"""The program's own spans over a traced window, for the per-layer
metrics that read them (metrics/step_host_ms.py, idle_in_step_share.py,
queue_wait_p95_s.py, admit_to_audio_p50_s.py).

`miotts_tpu_torch.runtime.profile.tracer` keeps the spans in memory; the
batcher starts it at its first scheduler step under a recording
torch.profiler and stops it at the first step after, so a traced run's
window holds them with no call from here.  Each span is (name, start,
end, parent, req_id) with start and end moved onto the profiler's clock,
the clock of `TraceView`'s host events.  A program without the tracer,
or a run in which it recorded nothing, gives None, and so do the readers.

The window opens at the tracer's first span.  The harness starts its
profiler between a poll and a scheduler step, which can stall for
seconds: a request submitted before the window, or a wave ended before
it, would carry that stall, so the request readers take the requests
submitted (queue) or admitted (first audio) inside the window.

The first reader to ask logs one line, `portbench: program spans`: for
each span name its count, host self time per device step (ms), launch
calls per device step made in its self time, and the device idle time
(s) whose gap ended at such a launch; and under "requests" what the
request readers took and left."""

from __future__ import annotations

import bisect
import json
import sys

STEP = "llm.step"


def _tracer():
    from miotts_tpu_torch.runtime import profile
    return getattr(profile, "tracer", None)


def window(ctx):
    """The window's spans on the trace's clock, or None; computed once a
    context (the first call also logs the table)."""
    if not hasattr(ctx, "_program_spans"):
        tr = _tracer()
        rows = list(tr.spans) if tr is not None else []
        ctx._program_spans = None
        if rows:
            ctx._program_spans = [(n, tr.trace_ns(s), tr.trace_ns(e), p, r)
                                  for n, s, e, p, r in rows]
            _log(ctx, ctx._program_spans, tr.self_ns())
    return ctx._program_spans


def durations_s(spans, name: str) -> list:
    return [(e - s) * 1e-9 for n, s, e, _, _ in spans if n == name]


def bounds(spans) -> tuple:
    """(first start, last end) of the spans that are not a request's."""
    own = [(s, e) for _, s, e, _, r in spans if r < 0]
    return min(s for s, _ in own), max(e for _, e in own)


def queue_waits_s(spans) -> list:
    """From submit to the wave's start, of the requests submitted inside
    the window."""
    w0 = bounds(spans)[0]
    return [(e - s) * 1e-9 for n, s, e, _, _ in spans
            if n == "req.queue" and s >= w0]


def first_audio_waits_s(spans) -> tuple:
    """From the end of the wave to the first audio, of the requests
    admitted inside the window; one with none by the window's end enters
    as the time it had waited, a lower bound (as TTFA counts it).
    Returns (waits, how many of them are such bounds)."""
    w1 = bounds(spans)[1]
    heard = {r: e for n, _, e, _, r in spans if n == "req.first_audio"}
    waits, censored = [], 0
    for n, _, e, _, r in spans:
        if n == "req.prefill":
            censored += r not in heard
            waits.append((heard.get(r, w1) - e) * 1e-9)
    return waits, censored


def innermost(spans, times: list) -> list:
    """For each host time in `times` (sorted), the index of the innermost
    span around it, request spans aside, or -1.  Spans of one thread nest,
    so one sweep with a stack of the open ones finds it."""
    order = sorted((i for i, x in enumerate(spans) if x[4] < 0),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(order) and spans[order[k]][1] <= t:
            j = order[k]
            while stack and spans[stack[-1]][2] < spans[j][1]:
                stack.pop()
            stack.append(j)
            k += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def idle_ends(trace) -> list:
    """(host time of the launch that ended each device idle gap, gap ns)
    in time order: the gaps TraceView.idle_gaps sums."""
    launch_at = {corr: t for t, corr in trace.runtime}
    out, last_end = [], None
    for _, s, e, corr in trace.device:
        if last_end is not None and s > last_end:
            t = launch_at.get(corr)
            if t is not None:
                out.append((t, s - last_end))
        last_end = e if last_end is None else max(last_end, e)
    out.sort()
    return out


def in_spans(spans, name: str, times: list) -> list:
    """For each host time, whether it falls inside a span `name` (spans of
    one name on one thread never overlap)."""
    iv = sorted((s, e) for n, s, e, _, _ in spans if n == name)
    starts = [s for s, _ in iv]
    out = []
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        out.append(i >= 0 and t <= iv[i][1])
    return out


def _log(ctx, spans, own: list) -> None:
    steps = ctx.stage.get("device_steps", 0) if ctx.stage else 0
    per = 1.0 / steps if steps else 0.0
    names = sorted({x[0] for x in spans})
    table = {n: {"count": 0, "self_ms_per_step": 0.0,
                 "launches_per_step": 0.0, "idle_s": 0.0} for n in names}
    for x, ns in zip(spans, own):
        table[x[0]]["count"] += 1
        if x[4] < 0:
            table[x[0]]["self_ms_per_step"] += ns * 1e-6 * per
    outside = {"launches_per_step": 0.0, "idle_s": 0.0}
    trace = ctx.trace
    if trace is not None:
        launches = sorted(t for t, _ in trace.launches)
        for i in innermost(spans, launches):
            row = table[spans[i][0]] if i >= 0 else outside
            row["launches_per_step"] += per
        gaps = idle_ends(trace)
        for i, (_, ns) in zip(innermost(spans, [t for t, _ in gaps]), gaps):
            row = table[spans[i][0]] if i >= 0 else outside
            row["idle_s"] += ns * 1e-9
        outside["window_idle_s"] = trace.window_s - trace.busy_ns() * 1e-9
    table["outside_spans"] = outside
    w0 = bounds(spans)[0]
    early = [(e - s) * 1e-9 for n, s, e, _, _ in spans
             if n == "req.queue" and s < w0]
    waits, censored = first_audio_waits_s(spans)
    table["requests"] = {
        "queued_in_window": len(queue_waits_s(spans)),
        "queued_before_window": len(early),
        "longest_wait_from_before_s": max(early, default=0.0),
        "admitted_in_window": len(waits), "no_audio_by_window_end": censored}
    print("portbench: program spans " + json.dumps(
        {n: {k: round(v, 9) for k, v in row.items()}
         for n, row in table.items()}), file=sys.stderr, flush=True)
