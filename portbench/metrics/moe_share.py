"""The device time of the expert kernels (`moe_*`, ops/csrc/moe.cu) over
the device's busy time in the traced window: the share of the step the
routed feed-forward takes.  None where no such kernel ran."""
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "LLM step: models/llm.py"
MOVES = "audio_x_realtime"


def read(ctx):
    if ctx.trace is None:
        return None
    ns, n = ctx.trace.kernel_ns("moe_")
    busy = ctx.trace.busy_ns()
    if not n or not busy:
        return None
    return 100.0 * ns / busy
