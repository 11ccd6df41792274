"""Real-time playback sinks: bounded-queue producer/consumer streaming.

Counterpart of `miotts_tpu/runtime/playback.py` and of the reference's
`examples/stream-to-device.cpp`: the synthesis thread produces chunks into
a bounded sample queue (cap ~10 s, `stream-to-device.cpp:232,267`) with
condition-variable backpressure; a consumer drains it: the host's audio
device through a player process when one is installed, else a file/stdout
PCM sink (for a server, "playback" is a network peer).  Underruns are
zero-filled like the reference audio callback
(`stream-to-device.cpp:169-177`).  numpy and threads only: nothing here
touches the GPU.
"""

from __future__ import annotations

import sys
import threading
from typing import IO, Optional

import numpy as np

from ..audio.wav import f32_to_s16


class BoundedSampleQueue:
    """Thread-safe float-sample FIFO with a cap and cv backpressure
    (`playback_state`, stream-to-device.cpp:152-182)."""

    def __init__(self, max_samples: int):
        self.max_samples = max_samples
        self._buf: list[np.ndarray] = []
        self._n = 0
        self._closed = False
        self._cv = threading.Condition()

    def push(self, samples: np.ndarray) -> bool:
        """Blocks while full; returns False once closed."""
        with self._cv:
            while self._n + len(samples) > self.max_samples and not self._closed:
                self._cv.wait(timeout=0.1)
            if self._closed:
                return False
            self._buf.append(np.asarray(samples, np.float32))
            self._n += len(samples)
            self._cv.notify_all()
            return True

    def pop(self, n: int, zero_fill: bool = True) -> np.ndarray:
        """Non-blocking pop of up to n samples; short reads are zero-filled
        (device underrun semantics)."""
        out = np.zeros(n, np.float32) if zero_fill else None
        with self._cv:
            got = 0
            while got < n and self._buf:
                head = self._buf[0]
                take = min(n - got, len(head))
                if out is None:
                    out = np.zeros(n, np.float32)
                out[got:got + take] = head[:take]
                if take == len(head):
                    self._buf.pop(0)
                else:
                    self._buf[0] = head[take:]
                self._n -= take
                got += take
            self._cv.notify_all()
        return out if out is not None else np.zeros(n, np.float32)

    def drain_wait(self, poll: float = 0.05) -> None:
        with self._cv:
            while self._n > 0 and not self._closed:
                self._cv.wait(timeout=poll)

    @property
    def fill(self) -> int:
        with self._cv:
            return self._n

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class PCMSink:
    """Consumer thread writing s16le PCM to a stream (file/stdout/socket)."""

    def __init__(self, queue: BoundedSampleQueue, out: IO[bytes],
                 sample_rate: int, block: int = 4096, pace_realtime: bool = False):
        self.queue = queue
        self.out = out
        self.sample_rate = sample_rate
        self.block = block
        self.pace = pace_realtime
        self.consumed = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def _run(self):
        import time
        period = self.block / self.sample_rate
        while not self._stop.is_set():
            t0 = time.perf_counter()
            avail = self.queue.fill
            if avail == 0:
                if self._stop.is_set():
                    break
                # A real device clock keeps ticking through a TOTAL underrun
                # and plays silence (stream-to-device.cpp:169-177); the
                # paced sink does the same once playback has started.  An
                # idle (pre-start / post-close) sink just waits.
                if not (self.pace and self.consumed > 0
                        and not self.queue.closed):
                    time.sleep(0.005)
                    continue
            # Real-time (paced) mode zero-fills underruns like a device
            # callback; file/stdout sinks write exactly what was produced.
            n = self.block if self.pace else min(self.block, avail)
            chunk = self.queue.pop(n)
            pcm = f32_to_s16(chunk).astype("<i2").tobytes()
            self.out.write(pcm)
            self.consumed += len(chunk)
            if self.pace:
                dt = time.perf_counter() - t0
                if dt < period:
                    time.sleep(period - dt)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
        try:
            self.out.flush()
        except Exception:
            pass


def find_audio_player(sample_rate: int) -> Optional[list]:
    """argv of an installed CLI player that accepts s16le mono PCM on
    stdin, or None.  Checked in order: PipeWire, PulseAudio, ALSA."""
    import shutil
    if shutil.which("pw-play"):
        return ["pw-play", "--rate", str(sample_rate), "--channels", "1",
                "--format", "s16", "-"]
    if shutil.which("paplay"):
        return ["paplay", "--raw", f"--rate={sample_rate}", "--channels=1",
                "--format=s16le"]
    if shutil.which("aplay"):
        return ["aplay", "-q", "-f", "S16_LE", "-r", str(sample_rate),
                "-c", "1", "-t", "raw", "-"]
    return None


class AudioDeviceSink(PCMSink):
    """Plays on the host's audio device by piping s16le PCM into a player
    subprocess (pw-play / paplay / aplay) — the counterpart of the
    reference's miniaudio device callback
    (`stream-to-device.cpp:238-299`).  The player's own device clock paces
    consumption: when its buffer fills, the pipe write blocks, which stalls
    this consumer thread, which lets the bounded queue fill, which
    backpressures synthesis — the same chain as the reference's cv wait.
    On underrun the device player waits for data (silence) instead of this
    sink zero-filling; `--dump-fed-wav` therefore captures exactly the
    samples the device consumed, like the reference's fed-audio capture."""

    def __init__(self, queue: BoundedSampleQueue, sample_rate: int,
                 block: int = 4096, player_cmd: Optional[list] = None):
        import subprocess
        cmd = player_cmd or find_audio_player(sample_rate)
        if cmd is None:
            raise RuntimeError(
                "no audio player found (tried pw-play, paplay, aplay); "
                "stream to a PCM sink instead (cli stream -o -)")
        self._proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        super().__init__(queue, self._proc.stdin, sample_rate, block=block,
                         pace_realtime=False)

    def stop(self):
        super().stop()
        try:
            self._proc.stdin.close()
        except Exception:
            pass
        try:
            self._proc.wait(timeout=5)
        except Exception:
            self._proc.kill()


class _CaptureOut:
    """Tee for --dump-fed-wav: records exactly what the sink consumed."""

    def __init__(self, inner: IO[bytes], fed: list):
        self._inner = inner
        self._fed = fed

    def write(self, b):
        self._fed.append(bytes(b))
        return self._inner.write(b)

    def flush(self):
        try:
            self._inner.flush()
        except Exception:
            pass

    def close(self):
        try:
            self._inner.close()
        except Exception:
            pass


def stream_to_sink(engine, voice, text, out: IO[bytes] | None = None,
                   options=None, chunk_samples: int = 4096,
                   queue_seconds: float = 10.0,
                   dump_fed_path: str | None = None,
                   device: bool = False,
                   player_cmd: Optional[list] = None) -> bool:
    """Full producer/consumer pipeline: synthesis -> bounded queue -> sink.

    Mirrors `stream-to-device.cpp:184-309` incl. `--dump-fed-wav` (capture
    exactly what the consumer drained).  `device=True` plays on the host
    audio device (AudioDeviceSink); without a player installed it degrades
    to a real-time paced null sink (the stream still runs at device-clock
    pace and `--dump-fed-wav` still captures)."""
    from .engine import Options
    options = options or Options()
    sr = engine.sample_rate
    queue = BoundedSampleQueue(int(queue_seconds * sr))
    fed: list[bytes] = []

    if device:
        try:
            sink = AudioDeviceSink(queue, sr, block=chunk_samples,
                                   player_cmd=player_cmd)
            if dump_fed_path:
                sink.out = _CaptureOut(sink.out, fed)
        except RuntimeError as e:
            print(f"stream: {e}; falling back to paced null sink",
                  file=sys.stderr)
            import io

            class _Null(io.RawIOBase):
                def write(self, b):
                    return len(b)
            null_out: IO[bytes] = _Null()
            sink = PCMSink(queue,
                           _CaptureOut(null_out, fed) if dump_fed_path
                           else null_out,
                           sr, block=chunk_samples, pace_realtime=True)
    else:
        out = out or sys.stdout.buffer
        sink = PCMSink(queue, _CaptureOut(out, fed) if dump_fed_path else out,
                       sr, block=chunk_samples)
    sink.start()

    def cb(samples, sample_rate, is_last):
        if samples is not None:
            return queue.push(samples)
        return True

    ok = engine.synthesize_stream(voice, text, cb, chunk_samples=chunk_samples,
                                  options=options)
    queue.drain_wait()
    sink.stop()
    queue.close()

    if dump_fed_path and fed:
        from ..audio.wav import wav_write
        pcm = np.frombuffer(b"".join(fed), dtype="<i2").astype(np.float32) / 32767.0
        wav_write(dump_fed_path, pcm, sr)
    return ok
