"""Device idle time whose gap ended at a launch the host made inside an
`llm.step` span, over all idle time between the device's operations:
how much of the idle device waits on the LLM step's host dispatch.  The
program's spans on the trace's clock against TraceView's runtime launch
calls and device intervals (portbench/spans.py)."""
from portbench import spans

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "LLM step: models/llm.py"
MOVES = "audio_x_realtime"


def read(ctx):
    got = spans.window(ctx)
    if not got or ctx.trace is None or not ctx.trace.device:
        return None
    gaps = spans.idle_ends(ctx.trace)
    total = sum(ns for _, ns in gaps)
    if not total:
        return None
    inside = spans.in_spans(got, spans.STEP, [t for t, _ in gaps])
    return 100.0 * sum(ns for (_, ns), hit in zip(gaps, inside) if hit) / total
