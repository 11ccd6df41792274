"""lfm2_moe (HF Lfm2Moe, llama.cpp's `lfm2moe`): LFM2's pre-norm layers
(archs/lfm2.py: gated short convolution or GQA attention with per-head
q/k RMSNorm), whose feed-forward is a SwiGLU of intermediate_size in the
first num_dense_layers and a sparse-expert block in every later layer:

  r = h W_g^T (the router ffn_gate_inp [E, D], f32); s = sigmoid(r)
  the chosen experts: the top num_experts_per_tok of s + b (the expert
  bias exp_probs_b, use_expert_bias: it only selects), ties to the lowest
  expert index
  w_j = s_j / max(sum of the chosen s, 2^-14) * routed_scaling_factor
  (norm_topk_prob; llama.cpp's clamp, HF adds 1e-6 to the sum: they agree
  to f32 rounding for a sum of sigmoids)
  out = sum_j w_j down_j(silu(gate_j h) * up_j h), the experts' stacks
  ffn_{gate,up}_exps [E, F, D] and ffn_down_exps [E, D, F]

Every product goes through `lin`, the router's included, so the control's
rounding of each product's input reaches the routing too.  The bias is
drawn with the configuration's `expert_bias_sigma` spread, and the down
stack with `expert_down_scale` times the spread of a dense down
projection: a routing decision that a rounding flips then moves its
token's residual by a few percent, so that a flip does not cascade
through the later expert layers into a different token (the
configuration's `assumed` says why)."""

import torch
import torch.nn.functional as F

from portbench import flops, weights
from portbench.reference.llm import attention, rms, short_conv, swiglu

GGUF_ARCH = "lfm2moe"
NORM_FLOOR = 2.0 ** -14
GATING_SIGMOID = 2          # llama.cpp's expert_gating_func for sigmoid


def shape_of(c: dict) -> weights.Shape:
    types = tuple("attn" if t == "full_attention" else "conv"
                  for t in c["layer_types"])
    return weights.shape_from(
        c, [i for i, t in enumerate(types) if t == "attn"],
        ff=c["intermediate_size"], conv_l=c.get("conv_L_cache", 3),
        layer_types=types, n_dense=c["num_dense_layers"],
        n_experts=c["num_experts"], top_k=c["num_experts_per_tok"],
        expert_ff=c["moe_intermediate_size"],
        norm_topk=bool(c["norm_topk_prob"]),
        scale=float(c["routed_scaling_factor"]),
        bias_sigma=float(c["expert_bias_sigma"]),
        down_scale=float(c["expert_down_scale"]))


def _conv(s, i: int) -> bool:
    return s.sizes["layer_types"][i] == "conv"


def _moe(s, i: int) -> bool:
    return i >= s.sizes["n_dense"]


def moe_layers(s) -> int:
    return s.n_layers - s.sizes["n_dense"]


def tensor_specs(s) -> list:
    D, z, specs = s.dim, s.sizes, []
    for i in range(s.n_layers):
        p = f"blk.{i}."
        specs.append(weights.vec(p + "attn_norm.weight", D, 0.1, 1.0))
        if _conv(s, i):
            specs += [
                weights.vec(p + "shortconv.conv.weight", D, 0.5,
                            cols=z["conv_l"]),
                weights.mat(p + "shortconv.in_proj.weight", "in_proj",
                            3 * D, D),
                weights.mat(p + "shortconv.out_proj.weight", "out_proj",
                            D, D)]
        else:
            specs += weights.attention_specs(p, s, qk_norm=True)
        if not _moe(s, i):
            specs += weights.ffn_specs(p, s, z["ff"])
            continue
        E, Fe = z["n_experts"], z["expert_ff"]
        specs += [
            weights.vec(p + "ffn_norm.weight", D, 0.1, 1.0),
            weights.vec(p + "ffn_gate_inp.weight", E, D ** -0.5, cols=D),
            weights.vec(p + "exp_probs_b.bias", E, z["bias_sigma"]),
            (p + "ffn_gate_exps.weight", (E, Fe, D), "ffn_gate_exps",
             D ** -0.5, 0.0),
            (p + "ffn_up_exps.weight", (E, Fe, D), "ffn_up_exps",
             D ** -0.5, 0.0),
            (p + "ffn_down_exps.weight", (E, D, Fe), "ffn_down_exps",
             z["down_scale"] * Fe ** -0.5, 0.0)]
    return specs


def gguf_kv(s) -> list:
    a, z, types = GGUF_ARCH, s.sizes, s.sizes["layer_types"]
    return weights.base_kv(s, z["ff"]) + [
        (f"{a}.attention.head_count",
         [s.n_heads if t == "attn" else 0 for t in types]),
        (f"{a}.attention.head_count_kv",
         [s.n_kv_heads if t == "attn" else 0 for t in types]),
        (f"{a}.shortconv.l_cache", z["conv_l"]),
        (f"{a}.expert_count", z["n_experts"]),
        (f"{a}.expert_used_count", z["top_k"]),
        (f"{a}.expert_feed_forward_length", z["expert_ff"]),
        (f"{a}.leading_dense_block_count", z["n_dense"]),
        (f"{a}.expert_gating_func", GATING_SIGMOID),
        (f"{a}.expert_weights_norm", z["norm_topk"]),
        (f"{a}.expert_weights_scale", z["scale"])]


def route(r, b, s):
    """(experts [N, k], weights [N, k]) of router logits r [N, E]."""
    z = s.sizes
    sg = torch.sigmoid(r)
    ids = torch.sort(sg + b, dim=-1, descending=True,
                     stable=True).indices[:, :z["top_k"]]
    w = sg.gather(1, ids)
    if z["norm_topk"]:
        w = w / w.sum(-1, keepdim=True).clamp(min=NORM_FLOOR)
    return ids, w * z["scale"]


def moe(h, W, p, s, lin):
    """The expert block's output for its normed input h [B, S, D]."""
    B, S, D = h.shape
    x = h.reshape(-1, D)
    ids, wts = route(lin(x, W(p + "ffn_gate_inp.weight")),
                     W(p + "exp_probs_b.bias"), s)
    gate, up = W(p + "ffn_gate_exps.weight"), W(p + "ffn_up_exps.weight")
    down = W(p + "ffn_down_exps.weight")
    out = torch.zeros_like(x)
    for e in torch.unique(ids).tolist():
        rows, j = (ids == e).nonzero(as_tuple=True)
        xe = x[rows]
        y = lin(F.silu(lin(xe, gate[e])) * lin(xe, up[e]), down[e])
        out.index_add_(0, rows, wts[rows, j, None] * y)
    return out.reshape(B, S, D)


def layer(x, W, p, i, s, lin, mask):
    h = rms(x, W(p + "attn_norm.weight"), s.eps)
    x = x + (short_conv(h, W, p, lin) if _conv(s, i)
             else attention(h, W, p, s, lin, mask, qk_norm=True))
    h = rms(x, W(p + "ffn_norm.weight"), s.eps)
    return x + (moe(h, W, p, s, lin) if _moe(s, i) else swiglu(h, W, p, lin))


def expert_params(s) -> int:
    """One expert's gate, up and down."""
    return 3 * s.dim * s.sizes["expert_ff"]


def matmul_params(s) -> int:
    """The active parameters a token meets: attention, conv, the dense
    FFNs, and in each expert layer its router and top_k experts; the
    head."""
    D, z, n_attn = s.dim, s.sizes, len(s.attn_layers)
    return (n_attn * flops.attention_params(s)
            + (s.n_layers - n_attn) * 4 * D * D        # in_proj, out_proj
            + z["n_dense"] * 3 * D * z["ff"]
            + moe_layers(s) * (z["top_k"] * expert_params(s)
                               + z["n_experts"] * D)
            + s.n_vocab * D)


def extra_token_flops(s) -> int:
    return 2 * s.sizes["conv_l"] * s.dim * (s.n_layers - len(s.attn_layers))


def weight_parts(s) -> dict:
    """The program's quantized linears outside the experts (whose stacks
    are not `qdot` weights)."""
    return {"wqkv": ("attn_q", "attn_k", "attn_v"), "wo": ("attn_output",),
            "w_gateup": ("ffn_gate", "ffn_up"), "w_down": ("ffn_down",),
            "in_proj": ("shortconv.in_proj",),
            "out_proj": ("shortconv.out_proj",)}
