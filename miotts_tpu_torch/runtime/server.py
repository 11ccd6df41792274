"""HTTP serving front-end over the continuous batcher (counterpart of
`miotts_tpu/runtime/server.py`).

Endpoints:
  GET  /health            -> {"status": "ok", "pending": N, "sample_rate"}
  GET  /voices            -> {"voices": [names]}
  GET  /stats             -> the batcher's stage accounting + occupancy
  POST /synthesize        body {"text": ..., "voice": name?,
                                "temperature"?, "max_tokens"?, "seed"?,
                                "format": "wav" | "pcm"}
       -> audio/wav (buffered) or chunked s16le PCM stream

Stdlib only (http.server): one scheduler thread drives batcher.step()
under `_lock` while handler threads block on per-request chunk queues.

Graceful shutdown reads the batcher's `pending` under the same lock the
scheduler holds through step(), and `pending` counts requests the batcher
is admitting, so a request taken from the waiting queue but not yet active
is never mistaken for a drained server.
"""

from __future__ import annotations

import json
import queue
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..audio.wav import f32_to_s16
from .batching import ContinuousBatcher
from .engine import Options, TTSEngine, VoiceModel


class TTSServer:
    def __init__(self, engine: TTSEngine, voices: dict[str, VoiceModel],
                 n_slots: int = 8, default_voice: str | None = None,
                 request_timeout_sec: float | None = None):
        self.engine = engine
        self.voices = voices
        self.default_voice = default_voice or next(iter(voices), None)
        self.batcher = ContinuousBatcher(engine, n_slots=n_slots)
        # per-request chunk-queue capacity (~24 s of audio at the default
        # 4096-sample chunks); a client further behind than this is dead
        self.queue_cap = 256
        # wall-clock budget per request; exceeded -> cancelled at the next
        # scheduler callback (None = unlimited)
        self.request_timeout_sec = request_timeout_sec
        self.draining = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._scheduler, daemon=True)

    def start_scheduler(self):
        self._thread.start()

    def stop(self):
        self._stop.set()

    def pending(self) -> int:
        """The batcher's unfinished work, read under the scheduler lock."""
        with self._lock:
            return self.batcher.pending

    def shutdown(self, drain_timeout_sec: float = 30.0) -> bool:
        """Graceful shutdown: refuse new requests (503), keep stepping until
        every in-flight request finishes (or the drain budget runs out),
        then stop the scheduler.  Returns True when fully drained."""
        self.draining = True
        deadline = time.monotonic() + drain_timeout_sec
        while self.pending() and time.monotonic() < deadline:
            time.sleep(0.01)
        drained = self.pending() == 0
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=60)
        return drained

    def _scheduler(self):
        while not self._stop.is_set():
            with self._lock:
                pending = self.batcher.pending
                if pending:
                    self.batcher.step()
            if not pending:
                time.sleep(0.005)

    def submit(self, text: str, voice_name: str | None,
               options: Options) -> "_StreamHandle":
        """Submit a request; returns a handle whose queue yields
        (samples | None, is_last)."""
        if self.draining:
            raise RuntimeError("server is shutting down")
        vname = voice_name or self.default_voice
        if vname not in self.voices:
            raise KeyError(f"unknown voice '{vname}'")
        h = _StreamHandle(self.queue_cap)
        if self.request_timeout_sec is not None:
            h.deadline = time.monotonic() + self.request_timeout_sec

        # runs on the scheduler thread under self._lock, so it must NEVER
        # block: a dead or hopelessly slow client (queue full) cancels its
        # own request by returning False
        def cb(samples, sr, is_last):
            if h.deadline is not None and time.monotonic() > h.deadline:
                h.timed_out = True
                h.abandoned = True
            if h.abandoned:
                return False
            try:
                h.q.put_nowait(
                    (None if samples is None else np.asarray(samples), is_last))
            except queue.Full:
                h.abandoned = True
                return False
            # only a DELIVERED final counts
            if is_last:
                h.final_sent = True
            return True

        def on_finish(req):
            # a request may finish without a delivered final (no speech
            # codes, cancellation, queue full on the last chunk): always
            # release the waiting handler, evicting stale chunks if needed
            if not h.final_sent:
                h.final_sent = True
                while True:
                    try:
                        h.q.put_nowait((None, True))
                        break
                    except queue.Full:
                        try:
                            h.q.get_nowait()
                        except queue.Empty:
                            continue
        with self._lock:
            self.batcher.submit(text, self.voices[vname], cb, options,
                                on_finish=on_finish)
        return h


class _StreamHandle:
    """Per-request bridge between the scheduler thread and a handler thread."""

    def __init__(self, maxsize: int = 256):
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self.abandoned = False   # handler died / stopped draining
        self.final_sent = False
        self.timed_out = False
        self.deadline: float | None = None   # monotonic cancel-after


def _make_handler(server: TTSServer):
    engine = server.engine

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # /health and /stats are unlocked snapshots: taking the
            # scheduler lock would stall them for a whole scheduler step
            b = server.batcher
            if self.path == "/health":
                return self._json(200, {"status": "ok", "pending": b.pending,
                                        "sample_rate": engine.sample_rate})
            if self.path == "/voices":
                return self._json(200, {"voices": sorted(server.voices)})
            if self.path == "/stats":
                st = dict(b.stage)
                st.update(pending=b.pending, active_slots=int(np.sum(b.active)),
                          n_slots=b.n_slots)
                return self._json(200, st)
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/synthesize":
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise TypeError("body must be a JSON object")
                text = str(req["text"])
                options = Options(
                    temperature=float(req.get("temperature", -1.0)),
                    max_tokens=int(req.get("max_tokens", -1)),
                    seed=int(req.get("seed", -1)),
                )
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                return self._json(400, {"error": f"bad request: {e}"})

            fmt = req.get("format", "wav")
            try:
                handle = server.submit(text, req.get("voice"), options)
            except KeyError as e:
                return self._json(400, {"error": str(e)})
            except RuntimeError as e:
                # graceful shutdown: refuse new work, let in-flight drain
                return self._json(503, {"error": str(e)})
            chunks_q = handle.q

            def next_chunk():
                """Queue get bounded by the request deadline (+ grace for
                the cancel round-trip through the scheduler)."""
                if handle.deadline is None:
                    return chunks_q.get()
                budget = max(0.05, handle.deadline + 5.0 - time.monotonic())
                try:
                    return chunks_q.get(timeout=budget)
                except queue.Empty:
                    handle.timed_out = True
                    handle.abandoned = True
                    return None, True

            sr = engine.sample_rate
            if fmt == "pcm":
                # chunked s16le PCM as audio is committed; a client
                # disconnect abandons the handle so the scheduler's next
                # callback cancels the request
                try:
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     f"audio/L16;rate={sr};channels=1")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    while True:
                        samples, is_last = next_chunk()
                        if samples is not None and len(samples):
                            pcm = f32_to_s16(samples).astype("<i2").tobytes()
                            self.wfile.write(f"{len(pcm):X}\r\n".encode())
                            self.wfile.write(pcm + b"\r\n")
                        if is_last:
                            break
                    self.wfile.write(b"0\r\n\r\n")
                finally:
                    handle.abandoned = True
                return

            # buffered WAV
            parts = []
            try:
                while True:
                    samples, is_last = next_chunk()
                    if samples is not None:
                        parts.append(samples)
                    if is_last:
                        break
            finally:
                handle.abandoned = True
            if handle.timed_out and not parts:
                return self._json(504, {"error": "request timed out"})
            audio = np.concatenate(parts) if parts else np.zeros(0, np.float32)
            pcm = f32_to_s16(audio).astype("<i2").tobytes()
            hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm),
                              b"WAVE", b"fmt ", 16, 1, 1, sr, sr * 2, 2, 16,
                              b"data", len(pcm))
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(44 + len(pcm)))
            self.end_headers()
            self.wfile.write(hdr + pcm)

    return Handler


def make_http_server(srv: TTSServer, host: str = "127.0.0.1",
                     port: int = 8080) -> ThreadingHTTPServer:
    """The HTTP listener for `srv` (port 0 picks a free one)."""
    return ThreadingHTTPServer((host, port), _make_handler(srv))


def serve(engine: TTSEngine, voices: dict[str, VoiceModel],
          host: str = "127.0.0.1", port: int = 8080, n_slots: int = 8,
          request_timeout_sec: float | None = None):
    """Run the TTS HTTP server (blocking).  On interrupt, drains in-flight
    requests (new ones get 503) before stopping the scheduler."""
    srv = TTSServer(engine, voices, n_slots=n_slots,
                    request_timeout_sec=request_timeout_sec)
    # run every serving shape once before the listener opens
    srv.batcher.warmup()
    srv.start_scheduler()
    httpd = make_http_server(srv, host, port)
    print(f"miotts-torch serving on http://{host}:{port} "
          f"(slots={n_slots}, device={engine.device}, "
          f"voices={sorted(voices)})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        srv.shutdown()
