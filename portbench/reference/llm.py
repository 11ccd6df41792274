"""The plain reference of the two LLM layouts, in float32 with TF32 off.

qwen2 (dense): pre-norm blocks of RMSNorm, GQA attention with q/k/v bias
and half-split (neox) RoPE, SwiGLU; a final RMSNorm and the output head.
lfm2 (hybrid, HF Lfm2): the same frame, where a layer is either GQA
attention with per-head RMSNorm of q and k (no bias) or a gated short
convolution: (B, C, x) = in_proj(h); y = C * causal_depthwise_conv(B * x)
over conv_L_cache taps; out_proj(y).  Tied embeddings where the file has
no output head.

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


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x [B, S, H, D], positions 0..S-1; rotates the pairs (i, i + D/2)."""
    S, D = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                  device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


class _Weights:
    """Dequantizes the file's tensors on demand onto `device`."""

    def __init__(self, tensors: dict, device):
        self.t, self.dev = tensors, device

    def __call__(self, name: str) -> torch.Tensor:
        t = self.t[name]
        raw = torch.from_numpy(t.payload).to(self.dev)
        return dequantize(raw, t.ggml_type, t.shape)

    def has(self, name: str) -> bool:
        return name in self.t


def _attention(h, W, p, s, lin, mask):
    B, S, _ = h.shape
    H, Hk, D = s.n_heads, s.n_kv_heads, s.head_dim
    q = lin(h, W(p + "attn_q.weight"))
    k = lin(h, W(p + "attn_k.weight"))
    v = lin(h, W(p + "attn_v.weight"))
    if s.qkv_bias:
        q = q + W(p + "attn_q.bias")
        k = k + W(p + "attn_k.bias")
        v = v + W(p + "attn_v.bias")
    q, k, v = (q.reshape(B, S, H, D), k.reshape(B, S, Hk, D),
               v.reshape(B, S, Hk, D))
    if s.qk_norm:
        q = _rms(q, W(p + "attn_q_norm.weight"), s.eps)
        k = _rms(k, W(p + "attn_k_norm.weight"), s.eps)
    q, k = _rope(q, s.theta), _rope(k, s.theta)
    k = k.repeat_interleave(H // Hk, dim=2)
    v = v.repeat_interleave(H // Hk, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(B, S, H * D)
    return lin(o, W(p + "attn_output.weight"))


def _short_conv(h, W, p, s, lin):
    bcx = lin(h, W(p + "shortconv.in_proj.weight"))
    b, c, x = bcx.chunk(3, dim=-1)
    bx = b * x                                          # [B, S, dim]
    w = W(p + "shortconv.conv.weight")                  # [dim, L]
    L = w.shape[1]
    padded = F.pad(bx, (0, 0, L - 1, 0))
    S = bx.shape[1]
    conv = sum(padded[:, i:i + S] * w[:, i] for i in range(L))
    return lin(c * conv, W(p + "shortconv.out_proj.weight"))


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
    W = _Weights(tensors, device)
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
        p = f"blk.{i}."
        h = _rms(x, W(p + "attn_norm.weight"), s.eps)
        conv = s.layer_types is not None and s.layer_types[i] == "conv"
        x = x + (_short_conv(h, W, p, s, lin) if conv
                 else _attention(h, W, p, s, lin, mask))
        h = _rms(x, W(p + "ffn_norm.weight"), s.eps)
        g = lin(h, W(p + "ffn_gate.weight"))
        u = lin(h, W(p + "ffn_up.weight"))
        x = x + lin(F.silu(g) * u, W(p + "ffn_down.weight"))
    x = _rms(x, W("output_norm.weight"), s.eps)
    head = W("output.weight") if W.has("output.weight") else emb
    logits = lin(x, head)
    return [logits[i, :len(q)] for i, q in enumerate(seqs)]
