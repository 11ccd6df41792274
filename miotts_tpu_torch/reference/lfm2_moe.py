"""The plain reference of an lfm2moe model (LiquidAI's LFM2-8B-A1B):
float32 torch, TF32 off, no kernel, no cache, no batching beyond zero
padding at the end of shorter sequences, and nothing of the port (it reads
the GGUF itself: F32 and Q8_0 tensors).

The forward, from llama.cpp's tensors and KVs:
  x = token_embd[ids]
  each layer i:  h = rms(x) * attn_norm
                 x += short_conv(h)  (head_count[i] == 0)  or  attention(h)
                 h = rms(x) * ffn_norm
                 x += swiglu(h)  (i < leading_dense_block_count)  or  moe(h)
  logits = (rms(x) * output_norm) @ head^T   (token_embd where no output)
with rms(v) = v / sqrt(mean(v^2) + eps).

  short_conv: (b, c, v) = in_proj(h) in thirds; out_proj(c * conv(b * v)),
      conv the causal depthwise convolution of length L over positions
      (weight [dim, L], tap L - 1 on the current position; HF Lfm2ShortConv)
  attention: q, k, v projections; per-head RMSNorm of q and k
      (attn_q_norm / attn_k_norm); half-split (neox) RoPE at positions
      0..S-1 with rope.freq_base; causal GQA softmax(q k^T / sqrt(d)) v;
      the output projection
  swiglu: down(silu(gate(h)) * up(h))
  moe (HF Lfm2MoeSparseMoeBlock, llama.cpp build_moe_ffn with sigmoid
      gating): r = h W_g^T (ffn_gate_inp, f32); s = sigmoid(r); the chosen
      experts are the top k (expert_used_count) of s + b (exp_probs_b: it
      only selects), ties to the lowest expert index; w_j = s_j / max(sum of
      the chosen s, 2^-14) * expert_weights_scale where expert_weights_norm
      (llama.cpp clamps the sum to the least normal f16; HF divides by the
      sum + 1e-6; a sum of k sigmoids is far above both, so they agree to
      f32 rounding), else s_j * scale; out = sum_j w_j down_j(silu(gate_j h)
      * up_j h) over the stacks ffn_{gate,up,down}_exps.

Every product is `lin(x, w) = x @ w^T`; `act`, when given, rounds each
product's input first, the router's included (a lower-precision control).
"""

from __future__ import annotations

import math
import mmap
import struct

import numpy as np
import torch
import torch.nn.functional as F

NORM_FLOOR = 6.103515625e-5
_F32, _Q8_0 = 0, 8
_SCALAR = {0: "<B", 1: "<b", 2: "<H", 3: "<h", 4: "<I", 5: "<i", 6: "<f",
           7: "<?", 10: "<Q", 11: "<q", 12: "<d"}


def read_gguf(path: str) -> tuple[dict, dict]:
    """(KVs, {name: float32 numpy array in numpy order}) of a GGUF v3 file
    whose tensors are F32 or Q8_0."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    at = 0

    def take(fmt):
        nonlocal at
        v = struct.unpack_from(fmt, mm, at)
        at += struct.calcsize(fmt)
        return v[0] if len(v) == 1 else v

    def string():
        nonlocal at
        n = take("<Q")
        s = mm[at:at + n].decode("utf-8")
        at += n
        return s

    def value(t):
        if t == 8:
            return string()
        if t == 9:
            et, n = take("<I"), take("<Q")
            return [value(et) for _ in range(n)]
        return take(_SCALAR[t])

    magic, _, n_t, n_kv = take("<IIQQ")
    if magic != 0x46554747:
        raise ValueError(f"{path}: not a GGUF file")
    kv = {}
    for _ in range(n_kv):
        key = string()
        kv[key] = value(take("<I"))
    infos = []
    for _ in range(n_t):
        name = string()
        ne = [take("<Q") for _ in range(take("<I"))]
        infos.append((name, tuple(reversed(ne)), take("<I"), take("<Q")))
    align = int(kv.get("general.alignment", 32))
    base = at + (-at) % align
    tensors = {}
    for name, shape, t, off in infos:
        n = int(np.prod(shape))
        if t == _F32:
            arr = np.frombuffer(mm, np.float32, n, base + off).copy()
        elif t == _Q8_0:
            b = np.frombuffer(mm, np.uint8, n // 32 * 34, base + off)
            b = b.reshape(-1, 34)
            d = b[:, :2].copy().view(np.float16).astype(np.float32)
            arr = (b[:, 2:].copy().view(np.int8).astype(np.float32) * d)
        else:
            raise ValueError(f"{name}: ggml type {t} is not F32 or Q8_0")
        tensors[name] = arr.reshape(shape)
    return kv, tensors


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x [B, S, H, D] at positions 0..S-1, pairs (i, i + D/2)."""
    S, D = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64) / D)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * inv
    cos = torch.cos(ang).float().to(x.device)[None, :, None, :]
    sin = torch.sin(ang).float().to(x.device)[None, :, None, :]
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def route(r: torch.Tensor, bias: torch.Tensor, k: int, scale: float,
          norm: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(experts [N, k], weights [N, k]) of router logits r [N, E]."""
    s = torch.sigmoid(r)
    ids = torch.sort(s + bias, dim=-1, descending=True,
                     stable=True).indices[:, :k]
    w = s.gather(1, ids)
    if norm:
        w = w / w.sum(-1, keepdim=True).clamp(min=NORM_FLOOR)
    return ids, w * scale


class Model:
    """An lfm2moe GGUF's tensors (as torch f32 on `device`) and its sizes."""

    def __init__(self, kv: dict, tensors: dict, device="cpu"):
        a = kv["general.architecture"]
        g = lambda key, d=None: kv.get(f"{a}.{key}", d)  # noqa: E731
        self.heads = list(g("attention.head_count"))
        kvh = g("attention.head_count_kv")
        self.n_heads = max(self.heads)
        self.n_kv = max(kvh) if isinstance(kvh, list) else int(kvh)
        self.dim = int(g("embedding_length"))
        self.head_dim = int(g("attention.key_length",
                              self.dim // self.n_heads))
        self.eps = float(g("attention.layer_norm_rms_epsilon"))
        self.theta = float(g("rope.freq_base"))
        self.n_dense = int(g("leading_dense_block_count", 0))
        self.k = int(g("expert_used_count"))
        self.scale = float(g("expert_weights_scale", 1.0))
        self.norm = bool(g("expert_weights_norm", True))
        self.t = {n: torch.from_numpy(v).to(device)
                  for n, v in tensors.items()}
        self.device = device

    def w(self, name):
        return self.t[name]


def _attention(h, m, p, lin):
    B, S, _ = h.shape
    H, Hk, D = m.n_heads, m.n_kv, m.head_dim
    q = lin(h, m.w(p + "attn_q.weight")).reshape(B, S, H, D)
    k = lin(h, m.w(p + "attn_k.weight")).reshape(B, S, Hk, D)
    v = lin(h, m.w(p + "attn_v.weight")).reshape(B, S, Hk, D)
    q = _rope(_rms(q, m.w(p + "attn_q_norm.weight"), m.eps), m.theta)
    k = _rope(_rms(k, m.w(p + "attn_k_norm.weight"), m.eps), m.theta)
    k = k.repeat_interleave(H // Hk, dim=2)
    v = v.repeat_interleave(H // Hk, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    mask = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(B, S, H * D)
    return lin(o, m.w(p + "attn_output.weight"))


def _short_conv(h, m, p, lin):
    b, c, v = lin(h, m.w(p + "shortconv.in_proj.weight")).chunk(3, dim=-1)
    bv = b * v
    w = m.w(p + "shortconv.conv.weight")                 # [dim, L]
    L, S = w.shape[1], bv.shape[1]
    padded = F.pad(bv, (0, 0, L - 1, 0))
    conv = sum(padded[:, i:i + S] * w[:, i] for i in range(L))
    return lin(c * conv, m.w(p + "shortconv.out_proj.weight"))


def moe(h, m, p, lin):
    """The expert layer p's output [B, S, dim] for its normed input h."""
    B, S, D = h.shape
    x = h.reshape(-1, D)
    ids, wts = route(lin(x, m.w(p + "ffn_gate_inp.weight")),
                     m.w(p + "exp_probs_b.bias"), m.k, m.scale, m.norm)
    gate, up = m.w(p + "ffn_gate_exps.weight"), m.w(p + "ffn_up_exps.weight")
    down = m.w(p + "ffn_down_exps.weight")
    out = torch.zeros_like(x)
    for e in torch.unique(ids).tolist():
        rows, j = (ids == e).nonzero(as_tuple=True)
        xe = x[rows]
        y = lin(F.silu(lin(xe, gate[e])) * lin(xe, up[e]), down[e])
        out.index_add_(0, rows, wts[rows, j, None] * y)
    return out.reshape(B, S, D)


def _swiglu(h, m, p, lin):
    g = lin(h, m.w(p + "ffn_gate.weight"))
    return lin(F.silu(g) * lin(h, m.w(p + "ffn_up.weight")),
               m.w(p + "ffn_down.weight"))


@torch.no_grad()
def forward(m: Model, seqs: list, act=None) -> list:
    """Logits [len(seq), vocab] (f32) at every position of each token
    sequence."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        def lin(x, w):
            return (x if act is None else act(x)) @ w.T

        B, S = len(seqs), max(len(q) for q in seqs)
        ids = torch.zeros((B, S), dtype=torch.long, device=m.device)
        for i, q in enumerate(seqs):
            ids[i, :len(q)] = torch.tensor(q, dtype=torch.long)
        emb = m.w("token_embd.weight")
        x = emb[ids]
        for i, heads in enumerate(m.heads):
            p = f"blk.{i}."
            h = _rms(x, m.w(p + "attn_norm.weight"), m.eps)
            x = x + (_attention(h, m, p, lin) if heads
                     else _short_conv(h, m, p, lin))
            h = _rms(x, m.w(p + "ffn_norm.weight"), m.eps)
            x = x + (_swiglu(h, m, p, lin) if i < m.n_dense
                     else moe(h, m, p, lin))
        x = _rms(x, m.w("output_norm.weight"), m.eps)
        head = m.t.get("output.weight", emb)
        logits = lin(x, head)
        return [logits[i, :len(q)] for i, q in enumerate(seqs)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
