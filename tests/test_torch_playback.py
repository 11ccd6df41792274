"""The port's playback sinks (miotts_tpu_torch/runtime/playback.py) on the
JAX package's cases (tests/test_playback.py), and stream_to_sink's PCM
against the JAX package's from the same codes.

Tolerance: one s16 step.  The two packages' codecs agree within ~1e-6 in
f32, and a difference that small can move a sample across a truncation
boundary of f32_to_s16 (scale by 32767, truncate)."""

import io
import sys
import threading
import time

import numpy as np
import pytest

from miotts_tpu.gguf import write_voice_embedding
from miotts_tpu.models.synthetic import write_synthetic_codec
from miotts_tpu.runtime import engine as je
from miotts_tpu.runtime import playback as jpb
from miotts_tpu.text import format_speech_tokens
from miotts_tpu_torch.audio.wav import f32_to_s16, wav_read
from miotts_tpu_torch.runtime import engine as te
from miotts_tpu_torch.runtime import playback
from miotts_tpu_torch.runtime.playback import (AudioDeviceSink,
                                               BoundedSampleQueue, PCMSink,
                                               stream_to_sink)
from torch_port_util import few_torch_threads  # noqa: F401

S16_STEP = 1


@pytest.fixture(scope="module")
def codec_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("playback")
    codec = str(d / "codec.gguf")
    cfg = write_synthetic_codec(codec, n_codes=64, seed=3)
    emb = str(d / "v.emb.gguf")
    write_voice_embedding(emb, np.random.default_rng(5)
                          .standard_normal(cfg.adaln_dim) * 0.3)
    return codec, emb


def test_queue_fifo_and_underrun():
    q = BoundedSampleQueue(1000)
    q.push(np.arange(5, dtype=np.float32))
    q.push(np.arange(5, 8, dtype=np.float32))
    np.testing.assert_array_equal(q.pop(6), [0, 1, 2, 3, 4, 5])
    # underrun: the 2 samples left, then zeros
    np.testing.assert_array_equal(q.pop(5), [6, 7, 0, 0, 0])


def test_queue_backpressure_blocks_until_closed():
    q = BoundedSampleQueue(10)
    q.push(np.zeros(10, np.float32))
    result = {}

    def producer():
        result["pushed"] = q.push(np.zeros(5, np.float32))

    t = threading.Thread(target=producer)
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive()          # blocked on the full queue
    q.pop(6)                     # make room
    t.join(timeout=2)
    assert not t.is_alive() and result["pushed"]
    q.close()
    assert q.push(np.zeros(1, np.float32)) is False


def test_paced_sink_underrun_and_clock():
    """A producer that lags behind real time: the paced sink zero-fills the
    gaps mid-stream and consumes at about the sample clock."""
    sr, block = 8000, 400              # 50 ms device period
    q = BoundedSampleQueue(sr * 10)
    buf = io.BytesIO()
    sink = PCMSink(q, buf, sr, block=block, pace_realtime=True)

    def produce():
        for _ in range(3):
            q.push(np.ones(sr // 10, np.float32))
            time.sleep(0.25)

    t0 = time.perf_counter()
    prod = threading.Thread(target=produce)
    prod.start()
    sink.start()
    prod.join(timeout=5)
    q.drain_wait()
    wall = time.perf_counter() - t0
    sink.stop()
    q.close()
    assert not prod.is_alive()

    pcm = np.frombuffer(buf.getvalue(), dtype="<i2").astype(np.float32)
    loud = np.nonzero(np.abs(pcm) > 16000)[0]
    assert loud.size == 3 * (sr // 10)
    assert loud[-1] - loud[0] + 1 > loud.size   # zero-filled gaps between
    assert wall >= 0.45
    assert sink.consumed >= len(pcm) - block


def test_audio_device_sink_plays_via_subprocess(tmp_path):
    """The player process receives exactly the queued PCM (a stand-in
    player copies its stdin to a file)."""
    sink_file = str(tmp_path / "consumed.pcm")
    player = [sys.executable, "-c",
              "import sys, shutil; shutil.copyfileobj("
              f"sys.stdin.buffer, open({sink_file!r}, 'wb'))"]
    q = BoundedSampleQueue(100_000)
    sink = AudioDeviceSink(q, 44100, block=1024, player_cmd=player)
    sink.start()
    samples = (np.random.default_rng(0).standard_normal(5000) * 0.2
               ).astype(np.float32)
    q.push(samples)
    q.drain_wait()
    time.sleep(0.1)
    sink.stop()
    q.close()
    got = np.fromfile(sink_file, dtype="<i2")
    np.testing.assert_array_equal(got, f32_to_s16(samples).astype("<i2"))


def test_stream_device_fallback_without_player(codec_files, tmp_path,
                                               monkeypatch, capsys):
    """device=True with no player installed: a paced null sink, and
    dump_fed_path still captures what it consumed."""
    codec, emb = codec_files
    monkeypatch.setattr(playback, "find_audio_player", lambda sr: None)
    eng = te.TTSEngine(te.EngineConfig(codec_path=codec, code_bucket=16,
                                       device="cpu"))
    text = format_speech_tokens(np.random.default_rng(1).integers(0, 64, 6))
    fed_path = str(tmp_path / "fed.wav")
    assert stream_to_sink(eng, te.VoiceModel(emb), text,
                          options=te.Options(skip_llm=True),
                          chunk_samples=2048, device=True,
                          dump_fed_path=fed_path)
    assert "falling back" in capsys.readouterr().err
    fed, sr = wav_read(fed_path)
    assert sr == eng.sample_rate and len(fed) >= 6 * eng.samples_per_token


@pytest.mark.parametrize("n_codes", [6, 60])
def test_stream_to_sink_matches_jax(codec_files, n_codes):
    """The same codes (skip-llm) through both packages' stream_to_sink into
    a byte buffer: the same byte count, samples within one s16 step."""
    codec, emb = codec_files
    text = format_speech_tokens(np.random.default_rng(n_codes).integers(
        0, 64, n_codes))
    outs = []
    for eng, voice, Opt, fn in (
            (je.TTSEngine(je.EngineConfig(codec_path=codec, code_bucket=16)),
             je.VoiceModel(emb), je.Options, jpb.stream_to_sink),
            (te.TTSEngine(te.EngineConfig(codec_path=codec, code_bucket=16,
                                          device="cpu")),
             te.VoiceModel(emb), te.Options, stream_to_sink)):
        buf = io.BytesIO()
        assert fn(eng, voice, text, out=buf, options=Opt(skip_llm=True),
                  chunk_samples=2048)
        outs.append(np.frombuffer(buf.getvalue(), dtype="<i2")
                    .astype(np.int32))
    want, got = outs
    assert got.size == want.size == n_codes * 1764
    assert int(np.max(np.abs(got - want))) <= S16_STEP
