"""qwen2 (dense): pre-norm blocks of RMSNorm, GQA attention with q/k/v
bias and half-split (neox) RoPE, and a SwiGLU feed-forward."""

from portbench import flops, weights
from portbench.reference.llm import attention, rms, swiglu

GGUF_ARCH = "qwen2"


def shape_of(c: dict) -> weights.Shape:
    return weights.shape_from(c, range(c["num_hidden_layers"]),
                              ff=c["intermediate_size"])


def tensor_specs(s) -> list:
    specs = []
    for i in range(s.n_layers):
        p = f"blk.{i}."
        specs.append(weights.vec(p + "attn_norm.weight", s.dim, 0.1, 1.0))
        specs += weights.attention_specs(p, s, bias=True)
        specs += weights.ffn_specs(p, s, s.sizes["ff"])
    return specs


def gguf_kv(s) -> list:
    a = GGUF_ARCH
    return weights.base_kv(s, s.sizes["ff"]) + [
        (f"{a}.attention.head_count", s.n_heads),
        (f"{a}.attention.head_count_kv", s.n_kv_heads)]


def layer(x, W, p, i, s, lin, mask):
    h = rms(x, W(p + "attn_norm.weight"), s.eps)
    x = x + attention(h, W, p, s, lin, mask, bias=True)
    h = rms(x, W(p + "ffn_norm.weight"), s.eps)
    return x + swiglu(h, W, p, lin)


def matmul_params(s) -> int:
    ffn = 3 * s.dim * s.sizes["ff"]
    return s.n_layers * (flops.attention_params(s) + ffn) + s.n_vocab * s.dim


def extra_token_flops(s) -> int:
    return 0


def weight_parts(s) -> dict:
    return {"wqkv": ("attn_q", "attn_k", "attn_v"), "wo": ("attn_output",),
            "w_gateup": ("ffn_gate", "ffn_up"), "w_down": ("ffn_down",)}
