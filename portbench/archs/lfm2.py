"""lfm2 (the hybrid of HF Lfm2): pre-norm blocks whose mixer is either GQA
attention with per-head RMSNorm of q and k (no bias) or a gated short
convolution, (B, C, x) = in_proj(h); y = C * causal_depthwise_conv(B * x)
over conv_L_cache taps; out_proj(y); a SwiGLU feed-forward in every
layer."""

from portbench import flops, weights
from portbench.reference.llm import attention, rms, short_conv, swiglu

GGUF_ARCH = "lfm2"


def ff_width(c: dict) -> int:
    """LFM2's feed-forward width: with block_auto_adjust_ff_dim, 2/3 of
    intermediate_size times block_ffn_dim_multiplier, rounded up to
    block_multiple_of (HF Lfm2MLP)."""
    ff = c["intermediate_size"]
    if c.get("block_auto_adjust_ff_dim"):
        ff = int(2 * ff / 3)
        ff = int(c.get("block_ffn_dim_multiplier", 1.0) * ff)
        m = c.get("block_multiple_of", 256)
        ff = m * ((ff + m - 1) // m)
    return ff


def shape_of(c: dict) -> weights.Shape:
    types = tuple("attn" if t == "full_attention" else "conv"
                  for t in c["layer_types"])
    return weights.shape_from(
        c, [i for i, t in enumerate(types) if t == "attn"], ff=ff_width(c),
        conv_l=c.get("conv_L_cache", 3), layer_types=types)


def _conv(s, i: int) -> bool:
    return s.sizes["layer_types"][i] == "conv"


def tensor_specs(s) -> list:
    D, specs = s.dim, []
    for i in range(s.n_layers):
        p = f"blk.{i}."
        specs.append(weights.vec(p + "attn_norm.weight", D, 0.1, 1.0))
        if _conv(s, i):
            specs += [
                weights.vec(p + "shortconv.conv.weight", D, 0.5,
                            cols=s.sizes["conv_l"]),
                weights.mat(p + "shortconv.in_proj.weight", "in_proj",
                            3 * D, D),
                weights.mat(p + "shortconv.out_proj.weight", "out_proj",
                            D, D)]
        else:
            specs += weights.attention_specs(p, s, qk_norm=True)
        specs += weights.ffn_specs(p, s, s.sizes["ff"])
    return specs


def gguf_kv(s) -> list:
    a, types = GGUF_ARCH, s.sizes["layer_types"]
    return weights.base_kv(s, s.sizes["ff"]) + [
        (f"{a}.attention.head_count",
         [s.n_heads if t == "attn" else 0 for t in types]),
        (f"{a}.attention.head_count_kv",
         [s.n_kv_heads if t == "attn" else 0 for t in types]),
        (f"{a}.shortconv.l_cache", s.sizes["conv_l"])]


def layer(x, W, p, i, s, lin, mask):
    h = rms(x, W(p + "attn_norm.weight"), s.eps)
    x = x + (short_conv(h, W, p, lin) if _conv(s, i)
             else attention(h, W, p, s, lin, mask, qk_norm=True))
    h = rms(x, W(p + "ffn_norm.weight"), s.eps)
    return x + swiglu(h, W, p, lin)


def matmul_params(s) -> int:
    D, n_attn = s.dim, len(s.attn_layers)
    return (n_attn * flops.attention_params(s)
            + (s.n_layers - n_attn) * 4 * D * D        # in_proj, out_proj
            + s.n_layers * 3 * D * s.sizes["ff"] + s.n_vocab * D)


def extra_token_flops(s) -> int:
    return 2 * s.sizes["conv_l"] * s.dim * (s.n_layers - len(s.attn_layers))


def weight_parts(s) -> dict:
    return {"wqkv": ("attn_q", "attn_k", "attn_v"), "wo": ("attn_output",),
            "w_gateup": ("ffn_gate", "ffn_up"), "w_down": ("ffn_down",),
            "in_proj": ("shortconv.in_proj",),
            "out_proj": ("shortconv.out_proj",)}
