"""Model FLOPs of the codes kept and the prompt tokens prefilled in the
traced window (2 x matmul parameters a token, attention over its
position, conv taps) over the window times the bf16 peak."""
from portbench import flops

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "LLM step: models/llm.py"
MOVES = "audio_x_realtime"


def read(ctx):
    if ctx.peak is None or ctx.trace is None:
        return None
    total = sum(flops.span_flops(ctx.shape, start, n)
                for c in ctx.chunks for start, n in c.spans)
    total += sum(flops.span_flops(ctx.shape, 0, n)
                 for wave in ctx.prefills for n in wave)
    if not total:
        return None
    return 100.0 * total / (ctx.trace.window_s * ctx.peak["bf16_flops"])
