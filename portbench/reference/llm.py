"""The plain reference of the LLM, in float32 with TF32 off: the embedding,
each layer as its architecture says (archs/<model_type>.py, `layer`, built
from the helpers here: RMSNorm, half-split (neox) RoPE, GQA attention, the
gated short convolution, SwiGLU), a final RMSNorm and the output head (the
embedding where the file has none).

A whole causal forward over each sequence (no KV cache, no batching of
requests beyond zero padding at the end), one layer at a time: the
layer's weights are dequantized from the file's bytes (`dequant`), used
and dropped, so the reference fits beside nothing else on the card.
`act`, when given, rounds every linear's input (the control's lower
precision).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .dequant import dequantize


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x [B, S, H, D], positions 0..S-1; rotates the pairs (i, i + D/2)."""
    S, D = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                  device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


class Weights:
    """Dequantizes the file's tensors on demand onto `device`."""

    def __init__(self, tensors: dict, device):
        self.t, self.dev = tensors, device

    def __call__(self, name: str) -> torch.Tensor:
        t = self.t[name]
        raw = torch.from_numpy(t.payload).to(self.dev)
        return dequantize(raw, t.ggml_type, t.shape)

    def has(self, name: str) -> bool:
        return name in self.t


def attention(h, W, p, s, lin, mask, bias=False, qk_norm=False):
    """Causal GQA self-attention over the whole sequence: q/k/v (with their
    bias), per-head RMSNorm of q and k, RoPE, softmax, the output
    projection."""
    B, S, _ = h.shape
    H, Hk, D = s.n_heads, s.n_kv_heads, s.head_dim
    q = lin(h, W(p + "attn_q.weight"))
    k = lin(h, W(p + "attn_k.weight"))
    v = lin(h, W(p + "attn_v.weight"))
    if bias:
        q = q + W(p + "attn_q.bias")
        k = k + W(p + "attn_k.bias")
        v = v + W(p + "attn_v.bias")
    q, k, v = (q.reshape(B, S, H, D), k.reshape(B, S, Hk, D),
               v.reshape(B, S, Hk, D))
    if qk_norm:
        q = rms(q, W(p + "attn_q_norm.weight"), s.eps)
        k = rms(k, W(p + "attn_k_norm.weight"), s.eps)
    q, k = rope(q, s.theta), rope(k, s.theta)
    k = k.repeat_interleave(H // Hk, dim=2)
    v = v.repeat_interleave(H // Hk, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(B, S, H * D)
    return lin(o, W(p + "attn_output.weight"))


def short_conv(h, W, p, lin):
    """LFM2's gated short convolution: (B, C, x) = in_proj(h);
    out_proj(C * causal_depthwise_conv(B * x))."""
    bcx = lin(h, W(p + "shortconv.in_proj.weight"))
    b, c, x = bcx.chunk(3, dim=-1)
    bx = b * x                                          # [B, S, dim]
    w = W(p + "shortconv.conv.weight")                  # [dim, L]
    L = w.shape[1]
    padded = F.pad(bx, (0, 0, L - 1, 0))
    S = bx.shape[1]
    conv = sum(padded[:, i:i + S] * w[:, i] for i in range(L))
    return lin(c * conv, W(p + "shortconv.out_proj.weight"))


def swiglu(h, W, p, lin):
    """down(silu(gate(h)) * up(h))."""
    g = lin(h, W(p + "ffn_gate.weight"))
    u = lin(h, W(p + "ffn_up.weight"))
    return lin(F.silu(g) * u, W(p + "ffn_down.weight"))


@torch.no_grad()
def forward_logits(tensors: dict, s, seqs: list, device,
                   act=None) -> list:
    """Logits [len(seq), n_vocab] (f32) at every position of each token
    sequence in `seqs`.  `s`: the model's Shape (portbench.weights)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(tensors, s, seqs, device, act)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _forward(tensors, s, seqs, device, act):
    W = Weights(tensors, device)
    B, S = len(seqs), max(len(q) for q in seqs)
    ids = torch.zeros((B, S), dtype=torch.long, device=device)
    for i, q in enumerate(seqs):
        ids[i, :len(q)] = torch.tensor(q, dtype=torch.long)
    mask = torch.ones((S, S), dtype=torch.bool, device=device).tril()

    def lin(x, w):
        return (x if act is None else act(x)) @ w.T

    emb = W("token_embd.weight")
    x = emb[ids]
    for i in range(s.n_layers):
        x = s.impl.layer(x, W, f"blk.{i}.", i, s, lin, mask)
    x = rms(x, W("output_norm.weight"), s.eps)
    head = W("output.weight") if W.has("output.weight") else emb
    logits = lin(x, head)
    return [logits[i, :len(q)] for i, q in enumerate(seqs)]
