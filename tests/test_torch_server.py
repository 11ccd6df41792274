"""The port's HTTP server (miotts_tpu_torch.runtime.server) on the CPU:
health, voices, stats, buffered WAV, streamed PCM, concurrency, errors,
request timeout, slow-client cancel, and graceful-shutdown drain."""

import http.client
import json
import threading
import time

import numpy as np
import pytest

from miotts_tpu.gguf import write_voice_embedding
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu_torch.runtime.engine import EngineConfig, Options, TTSEngine, VoiceModel
from miotts_tpu_torch.runtime.server import TTSServer, make_http_server
from torch_port_util import few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def engine_and_voice(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsrv")
    codec_path = str(d / "codec.gguf")
    llm_path = str(d / "llm.gguf")
    ccfg = write_synthetic_codec(codec_path, n_codes=64, seed=3)
    write_synthetic_llm(llm_path, seed=5, n_speech=64)
    emb_path = str(d / "jp_female.emb.gguf")
    write_voice_embedding(emb_path, np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    engine = TTSEngine(EngineConfig(
        model_path=llm_path, codec_path=codec_path, max_tokens=50,
        llm_dtype="float32", prompt_bucket=32, code_bucket=16, device="cpu"))
    return engine, VoiceModel(emb_path)


def _start(srv):
    httpd = make_http_server(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


@pytest.fixture(scope="module")
def server(engine_and_voice):
    engine, voice = engine_and_voice
    srv = TTSServer(engine, {"jp_female": voice}, n_slots=2)
    srv.start_scheduler()
    httpd, port = _start(srv)
    yield port
    httpd.shutdown()
    srv.stop()


def _conn(port):
    return http.client.HTTPConnection("127.0.0.1", port, timeout=120)


def _post(port, body):
    c = _conn(port)
    c.request("POST", "/synthesize", body=json.dumps(body),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    return r, r.read()


def test_health_and_voices(server):
    c = _conn(server)
    c.request("GET", "/health")
    r = c.getresponse()
    assert r.status == 200
    body = json.loads(r.read())
    assert body["status"] == "ok" and body["sample_rate"] == 44100
    c.request("GET", "/voices")
    assert json.loads(c.getresponse().read())["voices"] == ["jp_female"]


def test_stats_endpoint(server):
    c = _conn(server)
    c.request("GET", "/stats")
    r = c.getresponse()
    assert r.status == 200
    body = json.loads(r.read())
    for key in ("chunks", "decodes", "prefills", "llm_wait_sec",
                "codec_sync_sec", "device_steps", "codes_kept",
                "codes_decoded", "codes_committed", "emitted_samples",
                "graph_steps", "graph_captures", "graph_qdot_flops",
                "graph_qdot_bytes", "pending", "active_slots", "n_slots"):
        assert key in body


def test_synthesize_wav(server):
    r, data = _post(server, {"text": "hello server", "max_tokens": 30,
                             "temperature": 1.0})
    assert r.status == 200 and r.getheader("Content-Type") == "audio/wav"
    assert data[:4] == b"RIFF" and len(data) >= 44
    assert int.from_bytes(data[40:44], "little") == len(data) - 44


def test_synthesize_pcm_stream(server):
    r, data = _post(server, {"text": "stream me", "max_tokens": 30,
                             "temperature": 1.0, "format": "pcm"})
    assert r.status == 200 and "audio/L16" in r.getheader("Content-Type")
    assert len(data) % 2 == 0


def test_unknown_voice(server):
    r, _ = _post(server, {"text": "x", "voice": "nope"})
    assert r.status == 400


def test_bad_request_non_object(server):
    r, data = _post(server, [1, 2])
    assert r.status == 400 and "bad request" in json.loads(data)["error"]


def test_concurrent_requests(server):
    results = []

    def one(i):
        r, data = _post(server, {"text": f"req {i}", "max_tokens": 25,
                                 "temperature": 1.0})
        results.append((r.status, len(data)))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert len(results) == 4 and all(s == 200 for s, _ in results)


def test_request_timeout(engine_and_voice):
    """A request past request_timeout_sec is cancelled at the next
    scheduler callback: 504 with no audio (or 200 partial if the first
    commit won the race), and the slot is freed."""
    engine, voice = engine_and_voice
    srv = TTSServer(engine, {"v": voice}, n_slots=2, request_timeout_sec=0.0)
    srv.start_scheduler()
    httpd, port = _start(srv)
    r, _ = _post(port, {"text": "never fast enough", "max_tokens": 40,
                        "temperature": 1.0})
    assert r.status in (200, 504)
    deadline = time.time() + 60
    while srv.pending() and time.time() < deadline:
        time.sleep(0.05)
    assert srv.pending() == 0
    httpd.shutdown()
    srv.stop()


def test_slow_client_cancels_not_deadlocks(engine_and_voice):
    """A handler that stops draining cancels its own request once its chunk
    queue fills; the scheduler never blocks on it."""
    engine, voice = engine_and_voice
    srv = TTSServer(engine, {"v": voice}, n_slots=2)
    # the request emits at least two 4096-sample chunks (4 codes of 1764
    # samples at the engine's seed), so a one-chunk queue overflows
    srv.queue_cap = 1
    h = srv.submit("a slow client request", None,
                   Options(max_tokens=40, temperature=1.0))
    for _ in range(200):
        if not srv.batcher.pending:
            break
        srv.batcher.step()
    assert srv.batcher.pending == 0 and h.abandoned


def test_graceful_shutdown_drains(engine_and_voice):
    """shutdown(): in-flight requests finish with 200, new requests get
    503, the batcher is empty afterwards — five times in a row (the drain
    reads `pending` under the scheduler lock, so a request in the middle
    of its admission is never taken for a drained server)."""
    engine, voice = engine_and_voice
    for run in range(5):
        srv = TTSServer(engine, {"v": voice}, n_slots=2)
        srv.start_scheduler()
        httpd, port = _start(srv)
        inflight = []

        def one(i):
            r, data = _post(port, {"text": f"drain {run} {i}",
                                   "max_tokens": 25, "temperature": 1.0,
                                   "seed": i})
            inflight.append((r.status, len(data)))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        deadline = time.time() + 60
        while srv.batcher._next_id < 3 and time.time() < deadline:
            time.sleep(0.001)
        assert srv.shutdown(drain_timeout_sec=120), f"run {run}"
        for t in threads:
            t.join(timeout=120)
        assert len(inflight) == 3 and all(s == 200 for s, _ in inflight)
        assert srv.batcher.pending == 0
        r, _ = _post(port, {"text": "too late"})
        assert r.status == 503
        httpd.shutdown()
