"""The expert layers' least time over the device time of every `moe_*`
kernel (ops/csrc/moe.cu) in the traced window.  The work comes from the
program's counters (ContinuousBatcher.stage's moe_pairs, the token-expert
pairs computed, and moe_expert_reads, the experts a layer step read;
runtime/batching.py) and the architecture's sizes: 6 D F FLOPs a pair (gate,
up and down of one expert), one expert's GGUF bytes a read, the bf16
activations of a row in and out once (rows are pairs over top_k), and the
router's product (2 D E FLOPs a row; its f32 weight once a layer step:
the window's chunk steps and prefill waves times the expert layers).  The
least time is the larger of the summed FLOPs at the bf16 peak and the
summed bytes at HBM bandwidth.  None for a model without experts or a
program without the counters."""
from portbench import flops, gguf_writer, weights

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels: ops/moe.py"
MOVES = "audio_x_realtime"


def work(s, pairs: int, reads: int, layer_steps: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the expert layers' work."""
    z = s.sizes
    D, E, Fe, k = s.dim, z["n_experts"], z["expert_ff"], z["top_k"]
    per, size = gguf_writer.BLOCK[weights.FORMATS[
        s.quant.get("ffn_gate_exps", s.quant["default"])]]
    rows = pairs // k
    fl = 6 * D * Fe * pairs + 2 * D * E * rows
    nbytes = (reads * 3 * D * Fe // per * size + layer_steps * 4 * E * D
              + 2 * flops.ACT_BYTES * D * rows)
    return fl, nbytes


def read(ctx):
    st, s = ctx.stage or {}, ctx.shape
    if (ctx.peak is None or ctx.trace is None or "n_experts" not in s.sizes
            or not st.get("moe_pairs")):
        return None
    ns, n = ctx.trace.kernel_ns("moe_")
    if not n:
        return None
    steps = ((len(ctx.chunks) * ctx.chunk_steps + len(ctx.prefills))
             * (s.n_layers - s.sizes["n_dense"]))
    fl, nbytes = work(s, st["moe_pairs"], st["moe_expert_reads"], steps)
    return 100.0 * flops.least_time(fl, nbytes, ctx.peak) / (ns * 1e-9)
