"""The quantized linears' least time (FLOPs at the bf16 peak or bytes at
HBM bandwidth, weights at their GGUF size) over their kernels' device
time: K1's tile and GEMV, K1v, K2-K4 (ops/qmat.py)."""
from portbench import flops

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels: ops/qmat.py"
MOVES = "audio_x_realtime"


def read(ctx):
    if ctx.peak is None or ctx.trace is None or not ctx.qdot_calls:
        return None
    if any(c[3] is None for c in ctx.qdot_calls):
        return None
    least = sum(flops.least_time(*flops.linear(*c), ctx.peak)
                for c in ctx.qdot_calls)
    ns, n = ctx.trace.kernel_ns("qdot_")
    if not n:
        return None
    return 100.0 * least / (ns * 1e-9)
