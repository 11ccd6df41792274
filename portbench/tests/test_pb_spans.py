"""The readers of the program's spans and counters (portbench/spans.py and
metrics/step_host_ms, idle_in_step_share, queue_wait_p95_s,
admit_to_audio_p50_s, codec_redecode_ratio): their arithmetic on a
made-up window, None from a program that has no tracer, and on a tiny
traced cell their agreement with the harness's own readers."""

import json
import types

import pytest
import torch

from portbench import harness, spans
from portbench.harness import LayerContext
from portbench.metrics import (admit_to_audio_p50_s, codec_redecode_ratio,
                               idle_in_step_share, queue_wait_p95_s,
                               step_host_ms)
from portbench.trace import TraceView

from .conftest import TINY_DENSE, TINY_LFM2, tiny_cell, write_cell

SEED = 2 ** 31 + 7
NEW = (step_host_ms, idle_in_step_share, queue_wait_p95_s,
       admit_to_audio_p50_s, codec_redecode_ratio)


def _ctx(trace=None, stage=None):
    return LayerContext(shape=None, n_slots=2, chunk_steps=2, peak=None,
                        trace=trace, stage=stage or {}, chunks=[],
                        prefills=[], qdot_calls=[], audio_s=0.0)


def _program(monkeypatch, rows, offset=1000):
    from miotts_tpu_torch.runtime.profile import Tracer
    tr = Tracer()
    tr.spans, tr.offset_ns = rows, offset
    monkeypatch.setattr(spans, "_tracer", lambda: tr)


def test_readers_on_a_made_up_window(monkeypatch, capsys):
    # two steps (10 and 30 ns), the first with a sample span; request 4
    # submitted before the window opened (at 0), request 5 inside it and
    # without audio when it closed (at 600); times before the 1000 ns
    # offset
    rows = [["sched.dispatch", 0, 100, -1, -1],
            ["llm.step", 0, 10, 0, -1],
            ["llm.sample", 2, 4, 1, -1],
            ["llm.step", 20, 50, 0, -1],
            ["llm.merge", 60, 70, 0, -1],
            ["req.queue", -500, 0, -1, 4],
            ["req.prefill", 0, 100, 0, 4],
            ["req.queue", 10, 20, -1, 5],
            ["req.prefill", 20, 50, 0, 5],
            ["req.first_audio", 100, 400, 0, 4],
            ["sched.flush", 500, 600, -1, -1]]
    _program(monkeypatch, rows)
    view = TraceView(window_s=1e-6)
    # launches at 1003 (in a step's sample), 1030 (a step), 1065 (merge),
    # 1200 (outside): the gaps before k2, k3 and k4 end at the last three
    view.runtime = [(1003, 1), (1030, 2), (1065, 3), (1200, 4)]
    view.launches = list(view.runtime)
    view.device = [("k1", 1005, 1010, 1), ("k2", 1040, 1050, 2),
                   ("k3", 1070, 1080, 3), ("k4", 1300, 1310, 4)]
    ctx = _ctx(view, {"device_steps": 2, "codes_decoded": 90,
                      "codes_committed": 30})
    assert step_host_ms.read(ctx) == pytest.approx(20e-6)
    assert idle_in_step_share.read(ctx) == pytest.approx(
        100 * 30 / (30 + 20 + 220))
    assert queue_wait_p95_s.read(ctx) == pytest.approx(10e-9)
    # waits 300 ns (heard) and 550 ns (to the window's end, a bound)
    assert admit_to_audio_p50_s.read(ctx) == pytest.approx(300e-9)
    assert codec_redecode_ratio.read(ctx) == 3.0
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("portbench: program spans ")]
    assert len(line) == 1
    table = json.loads(line[0].split("spans ", 1)[1])
    assert table["llm.step"]["count"] == 2
    assert table["llm.step"]["self_ms_per_step"] == pytest.approx(
        (8 + 30) * 1e-6 / 2)
    assert table["llm.sample"]["launches_per_step"] == 0.5
    assert table["llm.step"]["idle_s"] == pytest.approx(30e-9)
    assert table["llm.merge"]["idle_s"] == pytest.approx(20e-9)
    assert table["outside_spans"]["idle_s"] == pytest.approx(220e-9)
    assert table["req.queue"]["self_ms_per_step"] == 0
    assert table["requests"] == {
        "queued_in_window": 1, "queued_before_window": 1,
        "longest_wait_from_before_s": 500e-9, "admitted_in_window": 2,
        "no_audio_by_window_end": 1}


def test_innermost_follows_the_nesting():
    rows = [("a", 0, 100, -1, -1), ("b", 10, 50, 0, -1),
            ("c", 20, 30, 1, -1), ("r", 0, 100, 0, 3), ("d", 60, 70, 0, -1)]
    assert spans.innermost(rows, [5, 15, 25, 35, 55, 65, 150]) == [
        0, 1, 2, 1, 0, 4, -1]


def test_a_program_without_the_tracer_gives_none(monkeypatch):
    monkeypatch.setattr(spans, "_tracer", lambda: None)
    view = TraceView(window_s=1.0)
    view.device = [("k", 0, 10, 1)]
    for mod in NEW:
        assert mod.read(_ctx(view, {"device_steps": 4})) is None


def _traced(root, name, monkeypatch, seconds=1.5):
    """A traced run of a tiny cell; returns (result, the readers' ctx)."""
    got = {}
    real = harness.metric_modules

    def read(ctx):
        got["ctx"] = ctx
    monkeypatch.setattr(harness, "metric_modules", lambda: {
        **real(), "zz_capture": types.SimpleNamespace(read=read, UNIT="x")})
    r = harness.run(name, SEED, seconds, True,
                    device="cuda" if torch.cuda.is_available() else "cpu",
                    root=root)
    return r, got["ctx"]


@pytest.mark.parametrize("config", [TINY_DENSE, TINY_LFM2],
                         ids=["tiny-dense", "tiny-lfm2"])
def test_the_program_agrees_with_the_harness_on_a_tiny_cell(
        tmp_path, config, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the CPU run; test_spans_on_the_card runs the card")
    # a window long enough that requests due in it finish, to be judged,
    # under the profiler's cost on the CPU
    name = config["name"] + ".closed"
    write_cell(tmp_path, name, config, tiny_cell(config, trace_seconds=2.5))
    r, ctx = _traced(tmp_path, name, monkeypatch, seconds=3.0)
    assert r["correct"], r["compared"]
    m = r["metrics"]
    for mod in (step_host_ms, queue_wait_p95_s, admit_to_audio_p50_s,
                codec_redecode_ratio):
        assert m[mod.__name__.rsplit(".", 1)[1]]["value"] > 0
    assert "idle_in_step_share" not in m      # no device on the CPU
    assert m["codec_redecode_ratio"]["value"] >= 1
    # slot occupancy from the program's counters: the window's codes kept
    # take the chunk in flight when it opened and leave the one in flight
    # when it closed, so the two differ by at most one chunk of codes
    st = ctx.stage
    n_chunks = st["device_steps"] // ctx.chunk_steps
    assert n_chunks == len(ctx.chunks) > 2
    prog = 100.0 * st["codes_kept"] / (st["device_steps"] * ctx.n_slots)
    assert abs(prog - m["slot_occupancy"]["value"]) <= 100.0 / n_chunks
    # the codec.decode spans are the harness's portbench.codec ranges
    decodes = [(s, e) for n, s, e, _, _ in spans.window(ctx)
               if n == "codec.decode"]
    ranges = [(s, e) for s, e, n in ctx.trace.ranges
              if n == "portbench.codec"]
    assert len(decodes) == len(ranges) > 0
    for (s, e), (rs, re_) in zip(sorted(decodes), sorted(ranges)):
        assert rs <= (s + e) // 2 <= re_
    names = {x[0] for x in spans.window(ctx)}
    assert {"sched.step", "sched.admit", "llm.step", "llm.sample", "llm.attn",
            "llm.ffn", "llm.head", "llm.merge", "llm.prefill",
            "codec.decode", "codec.net", "codec.istft", "req.queue",
            "req.prefill", "req.first_audio"} <= names
    assert ("llm.conv" in names) == (config is TINY_LFM2)


def test_an_untraced_run_never_starts_the_tracer(tiny_root):
    from miotts_tpu_torch.runtime.profile import tracer
    tracer.stop()
    tracer.spans = []
    r = harness.run("tiny-dense.closed", SEED, 1.0, False, device="cpu",
                    root=tiny_root)
    assert r["correct"] and not tracer.on and tracer.spans == []


@pytest.mark.cuda
def test_spans_on_the_card(tiny_root, monkeypatch):
    """On a card: the spans' miotts.* ranges stay out of TraceView.device,
    every new reader reads, and the idle each span's launches ended sums
    to the idle between the device's operations, within the window's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r, ctx = _traced(tiny_root, "tiny-dense.closed", monkeypatch)
    assert r["correct"], r["compared"]
    view = ctx.trace
    assert view.device and not any(n.startswith("miotts.")
                                   for n, *_ in view.device)
    for mod in NEW:
        assert mod.__name__.rsplit(".", 1)[1] in r["metrics"]
    assert 0 < r["metrics"]["idle_in_step_share"]["value"] <= 100
    got = spans.window(ctx)
    gaps = spans.idle_ends(view)
    at = spans.innermost(got, [t for t, _ in gaps])
    by = {}
    for i, (_, ns) in zip(at, gaps):
        by[got[i][0] if i >= 0 else ""] = by.get(got[i][0] if i >= 0
                                                 else "", 0) + ns
    idle = view.window_s * 1e9 - view.busy_ns()
    assert sum(by.values()) == sum(ns for _, ns in gaps) <= idle
