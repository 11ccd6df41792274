"""The quantized linears' least time (FLOPs at the bf16 peak or bytes at
HBM bandwidth) over their kernels' device time: K1's tile and GEMV, K1v,
K2-K4 (ops/qmat.py).  Eager calls (the prefill's) are counted through
the program's `qdot` (the harness's Observer), one least time each,
weights at their GGUF size.  A replay of the batcher's CUDA graphs calls
no Python `qdot`, so its linears come from the program's counters
(ContinuousBatcher.stage's graph_qdot_flops and graph_qdot_bytes,
runtime/batching.py: 2 M K N, and the weight as the program holds it, x
and y, each once); they all run at M = n_slots, so their least time is
that of their summed FLOPs and bytes.  Held against every qdot kernel's
device time.  A program without the counters gives None."""
from portbench import flops

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels: ops/qmat.py"
MOVES = "audio_x_realtime"


def read(ctx):
    st = ctx.stage or {}
    if (ctx.peak is None or ctx.trace is None
            or "graph_qdot_bytes" not in st):
        return None
    if any(c[3] is None for c in ctx.qdot_calls):
        return None
    least = sum(flops.least_time(*flops.linear(*c), ctx.peak)
                for c in ctx.qdot_calls)
    least += flops.least_time(st["graph_qdot_flops"], st["graph_qdot_bytes"],
                              ctx.peak)
    ns, n = ctx.trace.kernel_ns("qdot_")
    if not n or not least:
        return None
    return 100.0 * least / (ns * 1e-9)
