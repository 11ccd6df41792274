"""The port's tracer (miotts_tpu_torch.runtime.profile.tracer) on the CPU:
off it records nothing and costs well under a microsecond a span; on it
nests spans under their parents, gives request spans their req_id, and
puts spans on torch.profiler's clock; the batcher's stage sums are the
durations of its spans, its counters count what the requests hold, and a
traced `cli bench` shows the spans in its Chrome trace."""

import json
import math
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from miotts_tpu.gguf import write_voice_embedding
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu_torch import cli as tcli
from miotts_tpu_torch.runtime import batching as tb
from miotts_tpu_torch.runtime import engine as te
from miotts_tpu_torch.runtime.profile import Tracer, tracer
from torch_port_util import few_torch_threads  # noqa: F401

KW = dict(max_tokens=40, llm_dtype="float32", prompt_bucket=32,
          code_bucket=16)
STAGE_KEYS = ["admit_sec", "llm_wait_sec", "codec_sync_sec",
              "codec_dispatch_sec", "flush_wait_sec", "chunks", "decodes",
              "prefills", "device_steps"]
COUNTERS = ["codes_kept", "codes_decoded", "codes_committed",
            "emitted_samples", "graph_steps", "graph_captures",
            "graph_qdot_flops", "graph_qdot_bytes", "moe_pairs",
            "moe_expert_reads"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace_models")
    paths = {"codec": str(d / "codec.gguf"), "llm": str(d / "llm.gguf"),
             "voice": str(d / "voice.emb.gguf")}
    ccfg = write_synthetic_codec(paths["codec"], n_codes=64, seed=3)
    write_synthetic_llm(paths["llm"], seed=5, n_speech=64)
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return paths


@pytest.fixture(scope="module")
def engine(files):
    eng = te.TTSEngine(te.EngineConfig(model_path=files["llm"],
                                       codec_path=files["codec"],
                                       device="cpu", **KW))
    return eng, te.VoiceModel(files["voice"])


@pytest.fixture
def the_tracer():
    """The program's tracer, stopped again whatever the test does."""
    yield tracer
    tracer.stop()


def test_off_records_nothing_and_a_span_costs_under_a_microsecond():
    tr = Tracer()
    assert not tr.on and tr.span("a") is tr.span("b")
    with tr.span("a"):
        with tr.span("b"):
            pass
    assert tr.add("req.queue", 0, 1, 3) == -1
    assert tr.spans == []
    n, best = 100_000, math.inf
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with tr.span("llm.conv"):
                pass
        best = min(best, (time.perf_counter_ns() - t0) / n)
    print(f"a disabled span, loop included: {best:.0f} ns")
    assert best < 1000


def test_nesting_gives_parents_and_requests_their_ids():
    tr = Tracer()
    tr.start()
    with tr.span("sched.step") as step:
        with tr.timed("sched.admit") as wave:
            with tr.span("llm.prefill"):
                pass
        tr.add("req.prefill", wave.start, wave.end, 7, parent=wave.index)
        with tr.span("sched.dispatch"):
            with tr.span("llm.step"):
                with tr.span("llm.sample"):
                    pass
        first = tr.add("req.first_audio", wave.end, time.perf_counter_ns(), 7)
    tr.add("req.queue", wave.start - 5, wave.start, 7, parent=-1)
    tr.stop()
    rows = {r[0]: r for r in tr.spans}
    names = [r[0] for r in tr.spans]

    def parent(name):
        p = rows[name][3]
        return names[p] if p >= 0 else None
    assert parent("sched.step") is None
    assert parent("sched.admit") == parent("sched.dispatch") == "sched.step"
    assert parent("llm.prefill") == parent("req.prefill") == "sched.admit"
    assert parent("llm.sample") == "llm.step"
    assert parent("llm.step") == "sched.dispatch"
    assert first >= 0 and parent("req.first_audio") == "sched.step"
    assert parent("req.queue") is None
    assert step.index == 0 and wave.index == 1
    assert {r[4] for r in tr.spans if r[0].startswith("req.")} == {7}
    assert {r[4] for r in tr.spans if not r[0].startswith("req.")} == {-1}
    for r in tr.spans:
        assert r[1] <= r[2]
        if r[3] >= 0 and not r[0].startswith("req.first"):
            p = tr.spans[r[3]]
            assert p[1] <= r[1] and r[2] <= p[2]


def test_a_span_s_self_time_is_its_duration_less_its_children_s():
    tr = Tracer()
    tr.start()
    top = tr.add("sched.step", 0, 100)
    a = tr.add("sched.dispatch", 10, 30, parent=top)
    tr.add("llm.step", 12, 20, parent=a)
    tr.add("sched.process", 40, 45, parent=top)
    tr.add("req.prefill", 0, 100, 3, parent=top)   # a request's: aside
    assert tr.self_ns() == [75, 12, 8, 5, 100]


def test_a_timed_span_reads_the_clock_while_off():
    tr = Tracer()
    with tr.timed("sched.readback") as t:
        time.sleep(0.002)
    assert t.seconds >= 0.002 and tr.spans == []


def test_spans_sit_on_the_profiler_s_clock():
    """Every op recorded inside a span lies inside the span's interval
    moved to the profiler's clock, and the span's `miotts.*` range matches
    its record in memory to within 50 us."""
    tr = Tracer()
    x = torch.randn(96, 96)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.start()
        for _ in range(30):
            with tr.span("t.mm"):
                torch.relu(torch.mm(x, x))
            time.sleep(0.001)
        tr.stop()
    events = list(prof.profiler.kineto_results.events())
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in events if e.name() == "miotts.t.mm")
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in events if e.name() in ("aten::mm", "aten::relu")]
    spans = [(tr.trace_ns(r[1]), tr.trace_ns(r[2])) for r in tr.spans]
    assert len(ranges) == len(spans) == 30 and len(ops) == 60
    # a range stamps its start inside its enter, which a loaded host can
    # stretch: the median span matches within 50 us
    gaps = sorted(max(abs(rs - s), abs(re_ - e))
                  for (s, e), (rs, re_) in zip(spans, ranges))
    assert gaps[len(gaps) // 2] < 50_000, gaps
    for os_, oe in ops:
        assert any(s <= os_ and oe <= e for s, e in spans), (os_, oe)


def test_the_stage_keys_stay_and_the_counters_follow(engine):
    eng, _ = engine
    b = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=4)
    assert list(b.stage) == STAGE_KEYS + COUNTERS
    assert all(b.stage[k] == 0 for k in b.stage)


def _serve(b, voice, n):
    reqs = []
    for i in range(n):
        b.submit(f"traced text {i}", voice, lambda s, sr, last: True,
                 te.Options(max_tokens=24 + 6 * i, temperature=0.8, seed=i),
                 on_finish=reqs.append)
    b.run_until_done(max_iters=400)
    assert b.pending == 0 and len(reqs) == n
    return reqs


def _span_sum(name):
    return sum(r[2] - r[1] for r in tracer.spans if r[0] == name) * 1e-9


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_a_batcher_run_counts_and_spans(engine, the_tracer, fused):
    eng, voice = engine
    b = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=4, fused=fused)
    the_tracer.start()
    reqs = _serve(b, voice, 3)
    the_tracer.stop()
    st = b.stage
    names = [r[0] for r in tracer.spans]
    assert names.count("llm.step") == st["device_steps"] > 0
    assert names.count("llm.sample") == st["device_steps"]
    assert names.count("llm.merge") == st["chunks"]
    assert names.count("llm.prefill") == st["prefills"]
    assert names.count("sched.admit") == st["prefills"]
    assert names.count("sched.readback") == st["chunks"]
    assert names.count("codec.decode") == names.count("codec.net") \
        == names.count("codec.istft") > 0
    assert st["codes_kept"] == sum(len(r.codes) for r in reqs) > 0
    assert st["codes_committed"] == sum(r.committed for r in reqs) > 0
    assert st["codes_decoded"] >= st["codes_committed"]
    assert st["emitted_samples"] == sum(r.emitted_samples for r in reqs)
    # the stage sums are the spans' durations, read from the same clock
    assert st["admit_sec"] == pytest.approx(_span_sum("sched.admit"))
    assert st["llm_wait_sec"] == pytest.approx(_span_sum("sched.readback"))
    if not fused:
        assert st["flush_wait_sec"] == pytest.approx(_span_sum("sched.flush"))
    for r in reqs:
        assert (r.submitted_at <= r.admitted_at <= r.prefilled_at
                <= r.first_audio_at)
        mine = {s[0]: s for s in tracer.spans if s[4] == r.req_id}
        assert set(mine) == {"req.queue", "req.prefill", "req.first_audio"}
        assert tracer.spans[mine["req.prefill"][3]][0] == "sched.admit"
        assert mine["req.queue"][2] == mine["req.prefill"][1]
        assert mine["req.prefill"][2] == mine["req.first_audio"][1]
        assert mine["req.first_audio"][2] * 1e-9 == pytest.approx(
            r.first_audio_at)


def test_the_batcher_follows_a_profiler(engine, the_tracer):
    """Started at the first scheduler step under a recording profiler,
    stopped at the first step after it; the spans stay readable."""
    eng, voice = engine
    b = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=4)
    b.submit("followed", voice, lambda s, sr, last: True,
             te.Options(max_tokens=16, temperature=0.8, seed=1))
    b.step()
    assert not tracer.on
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        b.step()
        b.step()
        assert tracer.on
    b.step()
    assert not tracer.on
    steps = [r for r in tracer.spans if r[0] == "sched.step"]
    assert len(steps) == 2
    got = [e.name() for e in prof.profiler.kineto_results.events()]
    assert got.count("miotts.sched.step") == 2
    assert got.count("miotts.llm.step") == [r[0] for r in tracer.spans
                                            ].count("llm.step") > 0
    b.run_until_done(max_iters=200)
    assert len([r for r in tracer.spans if r[0] == "sched.step"]) == 2


def test_cli_bench_trace_holds_the_program_s_spans(files, tmp_path, capsys):
    trace = tmp_path / "trace"
    assert tcli.main(["bench", "-m", files["llm"], "-c", files["codec"],
                      "-v", files["voice"], "-p", "traced bench",
                      "--max-tokens", "24", "--device", "cpu", "--trace",
                      str(trace)]) == 0
    capsys.readouterr()
    names = [e.get("name") for e in json.loads(
        (trace / "trace.json").read_text())["traceEvents"]]
    assert names.count("miotts.llm.step") >= 24
    assert "miotts.llm.attn" in names and "miotts.codec.decode" not in names
    assert "miotts.codec.net" in names and "miotts.codec.istft" in names
    assert not tracer.on
