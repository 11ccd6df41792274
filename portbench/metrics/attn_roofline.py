"""The batched decode attention's least time over K6's device time
(ops/decode_attn.py): each launch reads the cached keys and values of the
slots active at its step (its chunk's starting fills), once."""
from portbench import flops

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels: ops/decode_attn.py"
MOVES = "audio_x_realtime"


def read(ctx):
    if ctx.peak is None or ctx.trace is None or not ctx.chunks:
        return None
    s = ctx.shape
    least = 0.0
    for c in ctx.chunks:
        for i in range(ctx.chunk_steps):
            keys = [f for f, n in zip(c.fill0, c.active_steps) if n > i]
            least += flops.least_time(*flops.attention_step(
                keys, s.n_heads, s.n_kv_heads, s.head_dim), ctx.peak)
    least *= len(s.attn_layers)
    ns, n = ctx.trace.kernel_ns("decode_attn_kernel")
    if not n:
        return None
    return 100.0 * least / (ns * 1e-9)
