"""Causal-LM decode engine in PyTorch (counterpart of
`miotts_tpu/models/llm.py`).

llama / qwen2 / qwen3 / mio: RMSNorm + SwiGLU + GQA + RoPE, with per-arch
toggles for QKV bias, QK-norm and the RoPE style.  lfm2: the hybrid of
LFM2, gated short-conv layers between QK-norm attention layers.  Quantized
weights stay packed (ops/qmat.QTensor) and every linear goes through
`qdot`, which on a GPU is the hand-written CUDA kernel.

The semantics follow the JAX package step for step:
  * The KV cache is a dense [L, B, H_kv, S_max, D] buffer plus `fill` [B];
    positions beyond `fill` are never attended, so a padded prefill equals
    an unpadded one.  Unlike JAX, the port updates the cache IN PLACE
    (`llm_forward` returns the same dict it was given, with a new `fill`).
  * Decode (S == 1) is deferred-write: the cache is read-only through the
    layers, the current token rides as one extra softmax column, and every
    layer's k/v is written once after the layer loop.
  * Prefill writes each layer's k/v first, then attends with the new fill.
  * Masks use -1e9, scores are f32, probabilities are cast to the compute
    dtype before the PV product (as JAX's einsums with f32 accumulation).
  * Activations default to bf16; logits and sampling are f32.

Hybrid (lfm2) models keep params["layers"] (one dict per layer, conv or
attention) instead of params["blocks"]; their cache holds k/v for the
attention layers only plus the short-conv state `conv` [n_conv, B, L-1,
dim].  Every attention layer writes first and then attends, decode
included, so a single-query step reads the cache through
`ops/decode_attn.decode_attention` (the hand-written CUDA kernel on a
GPU).

Batched serving (`llm_prefill_slots`, `llm_generate_chunk_batched`) keeps a
[L, n_slots, H_kv, S, D] cache, bf16 / f32 or int8 with per-(token, head)
scales, and reads it through `ops/decode_attn.decode_attention_batched`
(the hand-written CUDA kernel on a GPU).

Tensor parallelism (params from parallel/sharding.shard_llm_params): every
linear goes through `_linear`, which reads the weight's `Shard` record.  A
row-parallel weight multiplies this rank's K range of the activation,
through the kernel its route picks for the activation's dtype, and sums
the unrounded f32 partials over the model axis (`psum`) before one
rounding; a column-parallel one
gathers its output columns.  Activations stay whole on every rank except
attention, which runs on this rank's query and KV heads when the KV heads
divide the model axis (the cache holds those heads, `kv_heads`); the
output projection then takes the local heads as its K range.  So a layer
costs four all-reduces (fused QKV, wo, fused gate/up, down), the layout
GSPMD gives the JAX package's tables.  Data parallelism is the caller's:
each data rank runs these functions on its own batch rows and cache rows.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..gguf.quants import is_quantized
from ..ops.collective import ModelAxis, Shard, all_gather, psum
from ..ops.decode_attn import decode_attention, decode_attention_batched
from ..ops.qmat import QTensor, concat_qtensors, qdot, qtensor_from_raw
from ..runtime.profile import tracer

# Per-arch behaviour toggles (llama.cpp build_* graph equivalents).
_ARCH_TABLE = {
    "llama": dict(rope_style="norm", qkv_bias=False, qk_norm=False),
    "qwen2": dict(rope_style="neox", qkv_bias=True, qk_norm=False),
    "qwen3": dict(rope_style="neox", qkv_bias=False, qk_norm=True),
    "mio": dict(rope_style="neox", qkv_bias=True, qk_norm=False),
    # hybrid gated-short-conv / attention layers; per-head q/k RMS norms
    "lfm2": dict(rope_style="neox", qkv_bias=False, qk_norm=True),
}


@dataclass(frozen=True)
class LLMConfig:
    arch: str = "qwen2"
    n_layers: int = 24
    dim: int = 1024
    n_heads: int = 16
    n_kv_heads: int = 16
    head_dim: int = 64
    ff_dim: int = 2816
    n_vocab: int = 151936
    n_ctx: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    rope_style: str = "neox"        # "neox" (half-split) | "norm" (adjacent)
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embedding: bool = False
    # hybrid (lfm2) layer plan: None = all attention, else "attn" / "conv"
    # per layer (llama.cpp's per-layer head_count array, 0 = conv layer)
    layer_types: tuple[str, ...] | None = None
    conv_l_cache: int = 3
    conv_bias: bool = False

    @property
    def attn_layer_idx(self) -> tuple[int, ...]:
        if self.layer_types is None:
            return tuple(range(self.n_layers))
        return tuple(i for i, t in enumerate(self.layer_types) if t == "attn")

    @property
    def conv_layer_idx(self) -> tuple[int, ...]:
        if self.layer_types is None:
            return ()
        return tuple(i for i, t in enumerate(self.layer_types) if t == "conv")

    @classmethod
    def from_gguf(cls, reader) -> "LLMConfig":
        arch = str(reader.kv.get("general.architecture", "qwen2"))
        if arch not in _ARCH_TABLE:
            raise ValueError(f"unsupported LLM architecture {arch!r} "
                             f"(llama/qwen2/qwen3/mio/lfm2)")
        p = arch + "."
        g = lambda k, d: int(reader.kv.get(p + k, d))
        gf = lambda k, d: float(reader.kv.get(p + k, d))
        dim = g("embedding_length", 1024)
        hc = reader.kv.get(p + "attention.head_count", 16)
        layer_types = None
        if isinstance(hc, (list, tuple)):
            layer_types = tuple("attn" if int(h) > 0 else "conv" for h in hc)
            n_heads = max(int(h) for h in hc)
        else:
            n_heads = int(hc)
        kvc = reader.kv.get(p + "attention.head_count_kv", n_heads)
        n_kv = (max(int(h) for h in kvc) if isinstance(kvc, (list, tuple))
                else int(kvc))
        n_vocab = (len(reader.kv.get("tokenizer.ggml.tokens", []))
                   or g("vocab_size", 32000))
        return cls(
            arch=arch,
            n_layers=g("block_count", 24),
            dim=dim,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=g("attention.key_length", dim // n_heads),
            ff_dim=g("feed_forward_length", 4 * dim),
            n_vocab=n_vocab,
            n_ctx=g("context_length", 2048),
            rope_theta=gf("rope.freq_base", 10000.0),
            rms_eps=gf("attention.layer_norm_rms_epsilon", 1e-6),
            tie_embedding=not reader.has_tensor("output.weight"),
            layer_types=layer_types,
            conv_l_cache=g("shortconv.l_cache", 3),
            **_ARCH_TABLE[arch],
        )


# ---------------------------------------------------------------------------
# Weight loading
# ---------------------------------------------------------------------------

def _load_matrix(reader, name: str, dtype, device) -> Any:
    """Quantized formats stay packed as a QTensor; float formats become
    dense [out, in] tensors in `dtype`.  MIOTTS_SCALE_BF16 (any non-empty
    value, read at each call as the JAX package reads it) stores a
    QTensor's group scales and mins in bf16."""
    info = reader.tensors[name]
    if is_quantized(info.ggml_type):
        rows, cols = info.shape
        scale_dtype = (torch.bfloat16 if os.environ.get("MIOTTS_SCALE_BF16")
                       else torch.float32)
        return qtensor_from_raw(reader.tensor_raw(name), info.ggml_type,
                                rows, cols, device=device,
                                scale_dtype=scale_dtype)
    return torch.from_numpy(reader.tensor_f32(name)).to(device=device,
                                                        dtype=dtype)


def fuse_block(blk: dict, cfg: LLMConfig) -> dict:
    """q/k/v and gate/up into single matmuls (7 -> 4 per attention layer)
    when the siblings are all quantized or all dense.  A conv layer (no
    q/k/v) fuses gate/up only."""
    def same(keys):
        return (all(isinstance(blk[k], QTensor) for k in keys)
                or all(isinstance(blk[k], torch.Tensor) for k in keys))
    if "wq" in blk and same(("wq", "wk", "wv")):
        blk["wqkv"] = concat_qtensors([blk.pop("wq"), blk.pop("wk"),
                                       blk.pop("wv")])
        if cfg.qkv_bias:
            blk["bqkv"] = torch.cat([blk.pop("bq"), blk.pop("bk"),
                                     blk.pop("bv")])
    if same(("w_gate", "w_up")):
        blk["w_gateup"] = concat_qtensors([blk.pop("w_gate"), blk.pop("w_up")])
    return blk


_ATTN_MATS = (("wq", "attn_q"), ("wk", "attn_k"), ("wv", "attn_v"),
              ("wo", "attn_output"))
_CONV_MATS = (("in_proj", "shortconv.in_proj"),
              ("out_proj", "shortconv.out_proj"))
_FFN_MATS = (("w_gate", "ffn_gate"), ("w_up", "ffn_up"),
             ("w_down", "ffn_down"))
# optional f32 biases of a conv layer: key -> tensor name
_CONV_BIASES = (("conv_b", "shortconv.conv.bias"),
                ("in_proj_b", "shortconv.in_proj.bias"),
                ("out_proj_b", "shortconv.out_proj.bias"))


def load_llm_params(reader, cfg: LLMConfig | None = None,
                    dtype=torch.bfloat16,
                    device="cpu") -> tuple[dict, LLMConfig]:
    """LLM weights from GGUF (llama.cpp tensor naming) onto `device`, with
    q/k/v and gate/up fused: params["blocks"] for a dense model,
    params["layers"] for a hybrid one, whose conv layers carry conv_w
    [dim, L] f32, in_proj / out_proj and any biases the file has."""
    if cfg is None:
        cfg = LLMConfig.from_gguf(reader)

    def vec(name):
        return torch.from_numpy(reader.tensor_f32(name)).to(
            device=device, dtype=torch.float32)

    params: dict = {
        # the embedding stays dense (a gather), dequantized on the host
        "token_embd": torch.from_numpy(reader.tensor_f32(
            "token_embd.weight")).to(device=device, dtype=dtype),
        "output_norm": vec("output_norm.weight"),
    }
    if reader.has_tensor("output.weight"):
        params["output"] = _load_matrix(reader, "output.weight", dtype, device)
    blocks = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        attn = cfg.layer_types is None or cfg.layer_types[i] == "attn"
        blk = {"attn_norm": vec(p + "attn_norm.weight"),
               "ffn_norm": vec(p + "ffn_norm.weight")}
        for key, name in (_ATTN_MATS if attn else _CONV_MATS) + _FFN_MATS:
            blk[key] = _load_matrix(reader, p + name + ".weight", dtype, device)
        if not attn:
            blk["conv_w"] = vec(p + "shortconv.conv.weight").reshape(cfg.dim,
                                                                     -1)
            for key, name in _CONV_BIASES:
                if reader.has_tensor(p + name):
                    blk[key] = vec(p + name)
        if attn and cfg.qkv_bias:
            for key, name in (("bq", "attn_q"), ("bk", "attn_k"),
                              ("bv", "attn_v")):
                blk[key] = vec(p + name + ".bias")
        if attn and cfg.qk_norm:
            blk["q_norm"] = vec(p + "attn_q_norm.weight")
            blk["k_norm"] = vec(p + "attn_k_norm.weight")
        blocks.append(fuse_block(blk, cfg))
    params["blocks" if cfg.layer_types is None else "layers"] = blocks
    return params, cfg


def _layer_plan(params: dict, cfg: LLMConfig):
    """(kind, block) per layer in order: "attn" / "conv" for a hybrid
    model's params["layers"], "attn" for every dense block."""
    if "layers" in params:
        return list(zip(cfg.layer_types, params["layers"]))
    return [("attn", blk) for blk in params["blocks"]]


# ---------------------------------------------------------------------------
# Model math
# ---------------------------------------------------------------------------

def _rms_norm(x, w, eps):
    """Rounds to x.dtype BEFORE the weight multiply, as the JAX package."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _rope(x, pos, theta, style):
    """x [B, S, H, D]; pos [B, S].  'neox' rotates (i, i + D/2) pairs,
    'norm' adjacent (2i, 2i+1) pairs."""
    d = x.shape[-1]
    inv_freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = pos[..., None].float() * inv_freq
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    if style == "neox":
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    x2 = x.reshape(*x.shape[:-1], d // 2, 2)
    xe, xo = x2[..., 0], x2[..., 1]
    return torch.stack([xe * cos - xo * sin, xe * sin + xo * cos],
                       dim=-1).reshape(x.shape)


def kv_heads(params: dict | None, cfg: LLMConfig) -> int:
    """The KV heads a cache for `params` holds: cfg.n_kv_heads, or this
    rank's share of them when params are sharded (params["tp"]) and the
    heads divide the model axis (parallel/sharding's cache layout)."""
    return _local_heads(params.get("tp") if params else None, cfg)[1]


def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int | None = None,
                  dtype=torch.bfloat16, device="cpu",
                  quantized: bool = False,
                  n_kv_heads: int | None = None) -> dict:
    """Dense KV cache: k/v [L, B, H_kv, S, D] + fill counts [B] (int32).
    With `quantized`, k/v are int8 with per-(token, head) f32 scales
    k_scale / v_scale [L, B, H_kv, S].  A hybrid model's k/v cover its
    attention layers only (L = n_attn), and `conv` [n_conv, B, L_cache - 1,
    dim] in `dtype` holds each conv layer's last inputs.  `n_kv_heads`
    (default cfg.n_kv_heads): a tensor-parallel rank's share (`kv_heads`)."""
    S = max_len or cfg.n_ctx
    shape = (len(cfg.attn_layer_idx), batch, n_kv_heads or cfg.n_kv_heads, S,
             cfg.head_dim)
    kv_dtype = torch.int8 if quantized else dtype
    cache = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
             "v": torch.zeros(shape, dtype=kv_dtype, device=device),
             "fill": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if quantized:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
    if cfg.layer_types is not None:
        cache["conv"] = torch.zeros(
            (len(cfg.conv_layer_idx), batch, cfg.conv_l_cache - 1, cfg.dim),
            dtype=dtype, device=device)
    return cache


def _kv_quantize(x):
    """Per-(.., head) symmetric int8 over the last axis (round half to
    even, as jnp.round): x [..., D] -> (int8 [..., D], f32 scale [...])."""
    scale = x.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


def _layer(cache: dict, li: int) -> dict:
    """Attention layer li's views {k, v[, k_scale, v_scale]} of a stacked
    cache."""
    return {k: v[li] for k, v in cache.items() if k not in ("fill", "conv")}


def _attend(q, k_cache, v_cache, fill, q_pos, k_scale=None, v_scale=None,
            k_cur=None, v_cur=None):
    """Causal attention against the cache.  q [B, S_q, H, D]; k/v_cache
    [B, H_kv, S_max, D]; fill [B] valid entries; q_pos [B, S_q].
    k_scale / v_scale [B, H_kv, S_max] dequantize an int8 cache: they
    factor out of both dots and multiply the score and probability matrices
    instead.

    With k_cur / v_cur [B, 1, H_kv, D] (deferred-write decode) the current
    token is NOT in the cache and rides as one extra, always-valid column:
    concatenated to the scores, or merged without a concatenation under
    MIOTTS_ATTN_NOCAT (`_attend_nocat`, read at every call as the JAX
    package reads it at every trace).  Dots take their inputs in the
    compute dtype and sum in f32 (the exact products of bf16 values, as
    JAX's preferred_element_type=f32).

    A single query with the current token already in the cache (the
    hybrid decode, which writes first) goes through `decode_attention`
    (the CUDA kernel on a GPU), all in f32, as the JAX package's route to
    its `decode_attention` kernel."""
    B, S_q, H, D = q.shape
    H_kv, S_max = k_cache.shape[1], k_cache.shape[2]
    rep = H // H_kv
    cdt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    if S_q == 1 and k_cur is None:
        out = decode_attention(q[:, 0], k_cache, v_cache, fill, q_pos[:, 0],
                               k_scale, v_scale)
        return out.reshape(B, S_q, H * D).to(cdt)
    qg = q.to(cdt).float().reshape(B, S_q, H_kv, rep, D)
    kf = k_cache.to(cdt).float()
    vf = v_cache.to(cdt).float()
    scale = math.sqrt(D)
    scores = torch.einsum("bqgrd,bgkd->bgrqk", qg, kf) / scale
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, None, :]
    key_pos = torch.arange(S_max, device=q.device)
    valid = ((key_pos[None, None, :] <= q_pos[:, :, None])
             & (key_pos[None, None, :] < fill[:, None, None]))
    scores = scores.masked_fill(~valid[:, None, None], -1e9)
    if k_cur is not None:
        s_cur = torch.einsum("bqgrd,bqgd->bgrq", qg,
                             k_cur.to(cdt).float()) / scale
        if os.environ.get("MIOTTS_ATTN_NOCAT"):
            return _attend_nocat(scores, s_cur, vf, v_cur, v_scale, cdt)
        scores = torch.cat([scores, s_cur[..., None]], dim=-1)
    probs = torch.softmax(scores, dim=-1)
    if k_cur is not None:
        p_cur = probs[..., -1]
        probs = probs[..., :-1]
    if v_scale is not None:
        probs = probs * v_scale[:, :, None, None, :]
    out = torch.einsum("bgrqk,bgkd->bqgrd", probs.to(cdt).float(), vf)
    if k_cur is not None:
        out = out + torch.einsum("bgrq,bqgd->bqgrd", p_cur.to(cdt).float(),
                                 v_cur.to(cdt).float())
    return out.reshape(B, S_q, H * D).to(cdt)


def _attend_nocat(scores, s_cur, vf, v_cur, v_scale, cdt):
    """`_attend`'s softmax over the cache's scores [B, g, r, q, S] and the
    current token's s_cur [B, g, r, q] without concatenating them
    (MIOTTS_ATTN_NOCAT, the JAX package's no-concat merge): one shared
    max, each piece's exp, one normalizer l applied after the PV dots, so
    the unnormalized p is what rounds to the compute dtype."""
    B, g, r, S_q = s_cur.shape
    m = torch.maximum(scores.amax(dim=-1), s_cur)
    p_main = torch.exp(scores - m[..., None])
    p_cur = torch.exp(s_cur - m)
    l = p_main.sum(dim=-1) + p_cur
    if v_scale is not None:
        p_main = p_main * v_scale[:, :, None, None, :]
    out = torch.einsum("bgrqk,bgkd->bqgrd", p_main.to(cdt).float(), vf)
    out = out + torch.einsum("bgrq,bqgd->bqgrd", p_cur.to(cdt).float(),
                             v_cur.to(cdt).float())
    out = out / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, S_q, -1).to(cdt)


def _attend_bkernel(q, k_cache, v_cache, fill, q_pos, k_scale=None,
                    v_scale=None, k_cur=None, v_cur=None, k_buf=None,
                    v_buf=None, buf_valid=None):
    """Batched-decode attention (S_q == 1): the big cache read runs through
    `decode_attention_batched` (the CUDA kernel on a GPU, its plain version
    on the CPU) as a flash state (acc, m, l); the chunk-buffer columns
    k_buf / v_buf [B, H_kv, W, D] (valid where buf_valid [B, W]) and the
    current-token column k_cur / v_cur [B, 1, H_kv, D] are scored here and
    folded into the same softmax."""
    B, S_q, H, D = q.shape
    H_kv = k_cache.shape[1]
    rep = H // H_kv
    cdt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16

    acc, m, l = decode_attention_batched(
        q[:, 0], k_cache, v_cache, fill, q_pos[:, 0], k_scale, v_scale,
        return_stats=True)
    acc = acc.reshape(B, H_kv, rep, D)
    m = m.reshape(B, H_kv, rep)
    l = l.reshape(B, H_kv, rep)

    qg = q.to(cdt).float().reshape(B, S_q, H_kv, rep, D)
    s_buf = s_cur = None
    if k_buf is not None:
        s_buf = torch.einsum("bqgrd,bgwd->bgrqw", qg,
                             k_buf.to(cdt).float())[:, :, :, 0]
        s_buf = (s_buf / math.sqrt(D)).masked_fill(
            ~buf_valid[:, None, None, :], -1e9)               # [B, g, r, W]
    if k_cur is not None:
        s_cur = torch.einsum("bqgrd,bqgd->bgrq", qg,
                             k_cur.to(cdt).float())[..., 0]
        s_cur = s_cur / math.sqrt(D)                          # [B, g, r]

    m_all = m
    if s_buf is not None:
        m_all = torch.maximum(m_all, s_buf.amax(dim=-1))
    if s_cur is not None:
        m_all = torch.maximum(m_all, s_cur)
    alpha = torch.exp(m - m_all)
    out = acc * alpha[..., None]
    l_all = l * alpha
    if s_buf is not None:
        p_buf = torch.exp(s_buf - m_all[..., None])
        l_all = l_all + p_buf.sum(dim=-1)
        out = out + torch.einsum("bgrw,bgwd->bgrd", p_buf.to(cdt).float(),
                                 v_buf.to(cdt).float())
    if s_cur is not None:
        p_cur = torch.exp(s_cur - m_all)
        l_all = l_all + p_cur
        out = out + p_cur[..., None] * v_cur[:, 0, :, None, :].float()
    out = out / l_all.clamp(min=1e-20)[..., None]
    return out.reshape(B, S_q, H * D).to(cdt)


def _in_dim(w) -> int:
    return w.k if isinstance(w, QTensor) else w.shape[1]


def _linear(x, w, b=None, x_axis: ModelAxis | None = None):
    """x @ w^T (+ b) for a weight of any layout.  An unsharded weight:
    `qdot`.  A row-parallel Shard: this rank's K range of x (x itself when
    `x_axis` says x already is this rank's slice of its last dim) enters
    `qdot` in its own dtype, so the weight's route picks the kernel as it
    does unsharded (K1v / K3 for bf16 x), which writes its f32 sum
    unrounded (`out_f32`); the partials are summed in f32 over the model
    axis, then rounded once to x's dtype.  A
    column-parallel Shard: this rank's columns (+ its bias slice),
    gathered over the axis.  An unsharded or column-parallel weight under
    `x_axis` gathers x first."""
    if x_axis is not None and not (isinstance(w, Shard) and w.kind == "row"):
        x = all_gather(x, -1, x_axis.group)
    if not isinstance(w, Shard):
        y = qdot(x, w)
    elif w.kind == "row":
        if x_axis is None:
            k = _in_dim(w.local)
            x = x[..., w.axis.rank * k:(w.axis.rank + 1) * k]
        y = psum(qdot(x, w.local, out_f32=True), w.axis.group).to(x.dtype)
    else:
        y = qdot(x, w.local)
        if isinstance(b, Shard):
            y, b = y + b.local.to(y.dtype), None
        y = all_gather(y, -1, w.axis.group)[..., :w.n_out]
    return y if b is None else y + b.to(y.dtype)


def _local_heads(tp: ModelAxis | None, cfg: LLMConfig) -> tuple[int, int, int]:
    """(query heads, KV heads, first KV head) of this rank's attention:
    its share when the KV heads divide the model axis, else all of them."""
    H, H_kv = cfg.n_heads, cfg.n_kv_heads
    if tp is None or tp.size == 1 or H_kv % tp.size:
        return H, H_kv, 0
    return H // tp.size, H_kv // tp.size, tp.rank * (H_kv // tp.size)


def _block_forward(x, blk, lcache: dict, fill, pos, cfg: LLMConfig,
                   defer_write: bool = False, chunk_buf=None,
                   tp: ModelAxis | None = None):
    """One transformer block.  x [B, S, dim]; lcache this layer's cache
    views {k, v[, k_scale, v_scale]} with k/v [B, H_kv, S_max, D]; pos
    [B, S] absolute positions.

    defer_write (decode): the cache is only read, and the block returns
    (x, kv) with this token's {k, v[, k_scale, v_scale]} ([B, H_kv, D] /
    [B, H_kv]) for the caller's single post-loop write.  With `chunk_buf`
    = (k_buf, v_buf, buf_valid) (batched decode) attention goes through
    `_attend_bkernel` and kv holds the raw k / v for the chunk buffer.
    Otherwise (prefill) k/v are written into lcache in place at their
    positions first (quantized for an int8 cache), and the block returns
    (x, None).

    `tp` (sharded params): attention runs on this rank's heads
    (`_local_heads`), which `lcache` holds."""
    B, S, _ = x.shape
    D = cfg.head_dim
    H, H_kv, kv0 = _local_heads(tp, cfg)
    quantized = "k_scale" in lcache
    if lcache["k"].shape[1] != H_kv:
        raise ValueError(f"the cache holds {lcache['k'].shape[1]} KV heads, "
                         f"this rank attends over {H_kv} (kv_heads)")

    h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
    qd, kvd = cfg.n_heads * D, cfg.n_kv_heads * D
    if "wqkv" in blk:
        qkv = _linear(h, blk["wqkv"], blk["bqkv"] if cfg.qkv_bias else None)
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    else:
        bias = cfg.qkv_bias
        q = _linear(h, blk["wq"], blk["bq"] if bias else None)
        k = _linear(h, blk["wk"], blk["bk"] if bias else None)
        v = _linear(h, blk["wv"], blk["bv"] if bias else None)
    if H_kv != cfg.n_kv_heads:
        q = q[..., kv0 * (H // H_kv) * D:(kv0 * (H // H_kv) + H) * D]
        k = k[..., kv0 * D:(kv0 + H_kv) * D]
        v = v[..., kv0 * D:(kv0 + H_kv) * D]
    q = q.reshape(B, S, H, D)
    k = k.reshape(B, S, H_kv, D)
    v = v.reshape(B, S, H_kv, D)
    if cfg.qk_norm:
        q = _rms_norm(q, blk["q_norm"], cfg.rms_eps)
        k = _rms_norm(k, blk["k_norm"], cfg.rms_eps)
    q = _rope(q, pos, cfg.rope_theta, cfg.rope_style)
    k = _rope(k, pos, cfg.rope_theta, cfg.rope_style)
    ks = lcache.get("k_scale")
    vs = lcache.get("v_scale")

    if chunk_buf is not None:
        kv_out = {"k": k[:, 0], "v": v[:, 0]}
        k_buf, v_buf, buf_valid = chunk_buf
        attn = _attend_bkernel(q, lcache["k"], lcache["v"], fill, pos, ks, vs,
                               k_cur=k, v_cur=v, k_buf=k_buf, v_buf=v_buf,
                               buf_valid=buf_valid)
    elif defer_write:
        if quantized:
            kq, kss = _kv_quantize(k[:, 0].float())
            vq, vss = _kv_quantize(v[:, 0].float())
            kv_out = {"k": kq, "v": vq, "k_scale": kss, "v_scale": vss}
        else:
            kv_out = {"k": k[:, 0].to(lcache["k"].dtype),
                      "v": v[:, 0].to(lcache["v"].dtype)}
        attn = _attend(q, lcache["k"], lcache["v"], fill, pos, ks, vs,
                       k_cur=k, v_cur=v)
    else:
        kv_out = None
        b_idx = torch.arange(B, device=x.device)[:, None]
        p = pos.clamp(max=lcache["k"].shape[2] - 1).long()
        if quantized:
            kq, kss = _kv_quantize(k.float())
            vq, vss = _kv_quantize(v.float())
            lcache["k"][b_idx, :, p] = kq
            lcache["v"][b_idx, :, p] = vq
            ks[b_idx, :, p] = kss
            vs[b_idx, :, p] = vss
        else:
            lcache["k"][b_idx, :, p] = k.to(lcache["k"].dtype)
            lcache["v"][b_idx, :, p] = v.to(lcache["v"].dtype)
        new_fill = torch.maximum(fill, pos[:, -1] + 1)
        attn = _attend(q, lcache["k"], lcache["v"], new_fill, pos, ks, vs)
    x = x + _linear(attn.to(x.dtype), blk["wo"],
                    x_axis=tp if H_kv != cfg.n_kv_heads else None)
    return _ffn(x, blk, cfg), kv_out


def _ffn(x, blk, cfg: LLMConfig):
    """x + the SwiGLU feed-forward of ffn_norm(x)."""
    with tracer.span("llm.ffn"):
        h = _rms_norm(x, blk["ffn_norm"], cfg.rms_eps)
        if "w_gateup" in blk:
            gu = _linear(h, blk["w_gateup"])
            ff = gu.shape[-1] // 2
            gate, up = F.silu(gu[..., :ff]), gu[..., ff:]
        else:
            gate, up = (F.silu(_linear(h, blk["w_gate"])),
                        _linear(h, blk["w_up"]))
        return x + _linear((gate * up).to(x.dtype), blk["w_down"])


def _conv_block_forward(x, blk, state, advance, cfg: LLMConfig):
    """LFM2 gated short-conv layer + SwiGLU FFN (HF Lfm2ShortConv):
    (b, c, v) = split(in_proj(operator_norm(x))); a causal depthwise conv of
    length L over b * v, its first L - 1 inputs the cached `state`; then
    x + out_proj(c * conv), then the FFN.

    state [B, L-1, dim]: the last L - 1 real inputs; advance [B]: how many
    real tokens this call adds (n_real in a prefill, 1 or 0 in a decode
    step).  Returns (x, new_state) with new_state = ext[a : a + L - 1] of
    ext = concat(state, b * v): the old state where a == 0, else the last
    L - 1 real inputs."""
    S = x.shape[1]
    L = cfg.conv_l_cache
    h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
    # a column-parallel in_proj's shard is not (b, c, v): _linear gathers
    # the whole output before the split
    bcx = _linear(h, blk["in_proj"], blk.get("in_proj_b"))
    b_, c_, v_ = bcx.chunk(3, dim=-1)
    bv = b_ * v_
    ext = torch.cat([state.to(bv.dtype), bv], dim=1)       # [B, L-1+S, dim]
    w = blk["conv_w"].to(bv.dtype)                         # [dim, L]
    out = torch.zeros_like(bv)
    for i in range(L):
        out = out + ext[:, i:i + S] * w[:, i]
    if "conv_b" in blk:
        out = out + blk["conv_b"].to(out.dtype)
    x = x + _linear(c_ * out, blk["out_proj"], blk.get("out_proj_b"))
    # like JAX's dynamic slice, the start clamps to the last full window
    idx = (advance.long().clamp(0, S)[:, None]
           + torch.arange(L - 1, device=x.device))          # [B, L-1]
    new_state = ext.gather(1, idx[..., None].expand(-1, -1, ext.shape[-1]))
    return _ffn(x, blk, cfg), new_state.to(state.dtype)


def _logits(params, x, cfg: LLMConfig):
    """Final norm + output head -> f32 logits."""
    with tracer.span("llm.head"):
        x = _rms_norm(x, params["output_norm"], cfg.rms_eps)
        out_w = params.get("output")
        if out_w is None:
            # tied embeddings: a plain product outside any kernel, f32 sums
            return x.float() @ params["token_embd"].float().T
        return _linear(x, out_w).float()


@torch.no_grad()
def llm_forward(params: dict, tokens, pos, cache: dict, cfg: LLMConfig,
                advance=None):
    """Run the transformer over `tokens` [B, S] at positions `pos` [B, S],
    updating `cache` in place.  Returns (logits [B, S, V] f32, cache) with
    cache["fill"] = max(fill, pos[:, -1] + 1).  A dense model's S == 1 is
    the deferred-write decode; every other call (a prefill, any step of a
    hybrid model) writes each attention layer's k/v first and then
    attends.  `advance` [B] (hybrid only, default S): the real tokens each
    row adds to the conv state (see _conv_block_forward)."""
    x = params["token_embd"][tokens.long()]
    B, S, _ = x.shape
    fill = cache["fill"]
    tp = params.get("tp")
    if S == 1 and "layers" not in params:
        kvs = []
        for li, blk in enumerate(params["blocks"]):
            with tracer.span("llm.attn"):
                x, kv = _block_forward(x, blk, _layer(cache, li), fill, pos,
                                       cfg, defer_write=True, tp=tp)
            kvs.append(kv)
        # ONE write per cache field for every layer's new k/v: dims 1 (batch)
        # and 3 (position) are indexed, so the update is [B, L, H_kv(, D)];
        # like JAX's dynamic_update_slice the position clamps to the end
        b_idx = torch.arange(B, device=x.device)
        p = pos[:, 0].clamp(max=cache["k"].shape[3] - 1).long()
        for key in kvs[0]:
            cache[key][:, b_idx, :, p] = torch.stack([kv[key] for kv in kvs],
                                                     dim=1)
    else:
        if advance is None and "layers" in params:
            advance = torch.full((B,), S, dtype=torch.int32, device=x.device)
        attn_i = conv_i = 0
        for kind, blk in _layer_plan(params, cfg):
            if kind == "attn":
                with tracer.span("llm.attn"):
                    x, _ = _block_forward(x, blk, _layer(cache, attn_i), fill,
                                          pos, cfg, tp=tp)
                attn_i += 1
            else:
                with tracer.span("llm.conv"):
                    x, state = _conv_block_forward(
                        x, blk, cache["conv"][conv_i], advance, cfg)
                cache["conv"][conv_i] = state
                conv_i += 1
    cache["fill"] = torch.maximum(fill, (pos[:, -1] + 1).to(fill.dtype))
    return _logits(params, x, cfg), cache


def llm_prefill(params, tokens, n_real, cache, cfg: LLMConfig):
    """Prefill a right-padded [B, S_bucket] prompt; `n_real` [B] are the true
    lengths.  Padding positions are written to the cache but `fill` only
    advances to n_real, so later tokens never attend them, and a hybrid
    model's conv state takes the last real inputs (it starts from the
    state in `cache`, as in the JAX package).  Returns (last_logits [B, V],
    cache)."""
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    n_real = n_real.to(device=tokens.device, dtype=torch.int32)
    logits, cache = llm_forward(params, tokens, pos, cache, cfg,
                                advance=n_real)
    cache["fill"] = n_real.clone()
    last = logits[torch.arange(B, device=tokens.device), n_real.long() - 1]
    return last, cache


def llm_decode_step(params, token, cache, cfg: LLMConfig):
    """One decode step.  token [B]; positions come from cache fill.
    Returns (logits [B, V], cache)."""
    pos = cache["fill"][:, None]
    logits, cache = llm_forward(params, token[:, None], pos, cache, cfg)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# Sampling and the on-device generation loop
# ---------------------------------------------------------------------------

def sample_token(logits, temperature: float,
                 generator: torch.Generator | None = None):
    """Temperature + categorical sampling on the logits' device; temperature
    <= 0 is greedy (argmax, first index on ties).  logits [B, V] f32 -> [B]
    int64.  The draws come from `generator` (torch's Philox / mt19937, not
    JAX's threefry: sampled tokens are reproducible per seed within the
    port only)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_token_filtered(logits, temperature, generator=None,
                          top_k: int = 0, top_p=None, min_p=None):
    """The serving sampler of the JAX package (`sample_token_filtered`):
    temperature, then optional top-k, min-p (keep logits >= max + log
    min_p) and nucleus top-p (the smallest prefix of the sorted
    probabilities with mass >= top_p, rank 0 always kept) filters, then a
    categorical draw per row.  logits [B, V] f32 -> [B] int64; temperature,
    top_p and min_p are scalars or per-row [B]; rows at temperature <= 0
    are greedy.  The draws come from `generator` (torch's, not threefry)."""
    dev = logits.device

    def col(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        return v[:, None] if v.dim() == 1 else v

    t = col(temperature)
    scaled = logits / t.clamp(min=1e-6)
    neg = torch.tensor(-math.inf, device=dev)
    if top_k and top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled >= kth, scaled, neg)
    if min_p is not None:
        mx = scaled.amax(dim=-1, keepdim=True)
        scaled = torch.where(
            scaled >= mx + torch.log(col(min_p).clamp(min=1e-9)), scaled, neg)
    if top_p is not None:
        probs = torch.softmax(scaled, dim=-1)
        sorted_p, order = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
        keep_sorted = (torch.cumsum(sorted_p, dim=-1) - sorted_p) < col(top_p)
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        scaled = torch.where(keep, scaled, neg)
    greedy = torch.argmax(logits, dim=-1)
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                generator=generator)[:, 0]
    return torch.where(t.reshape(-1).expand(logits.shape[0]) > 0, sampled,
                       greedy)


@torch.no_grad()
def llm_generate_chunk(params: dict, last_logits, cache: dict,
                       temperature: float, stop_ids, cfg: LLMConfig,
                       n_steps: int, generator: torch.Generator | None = None,
                       done=None):
    """Generate up to `n_steps` tokens (single sequence) with no host sync:
    sample -> stop-check -> decode runs `n_steps` times on the device, and
    the stop flag, token buffer and count stay there until the caller reads
    them once per chunk.

    After a stop token nothing changes any more: the buffer keeps -1, the
    count, `fill` and a hybrid model's conv state stop advancing and
    `last_logits` is kept (the masked steps still run; their k/v writes
    land at `fill`, which no later token attends before rewriting it).
    `done` (0-d bool on the device, default False) carries the stop latch
    in from an earlier chunk, so a chunk enqueued before the host has read
    its predecessor's stop runs as masked steps only.

    last_logits [1, V]; stop_ids int [n_stop] (pad with -1).  Returns
    (tokens [n_steps] (-1 padded), n_generated, done, last_logits, cache)
    with n_generated and done as 0-d device tensors."""
    dev = last_logits.device
    stop_ids = stop_ids.to(dev)
    buf = torch.full((n_steps,), -1, dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    if done is None:
        done = torch.zeros((), dtype=torch.bool, device=dev)
    last = last_logits
    for i in range(n_steps):
        with tracer.span("llm.step"):
            with tracer.span("llm.sample"):
                tok = sample_token(last, temperature, generator)
                done = done | (tok[0] == stop_ids).any()
            active = ~done
            buf[i] = torch.where(active, tok[0], buf[i])
            step = active.long()
            count = count + step
            fill = cache["fill"]
            logits, cache = llm_forward(params, tok[:, None], fill[:, None],
                                        cache, cfg, advance=step[None])
            cache["fill"] = torch.where(active, cache["fill"], fill)
            last = torch.where(active, logits[:, 0], last)
    return buf, count, done, last, cache


# ---------------------------------------------------------------------------
# Speculative decoding: a draft model proposes k tokens, ONE target forward
# at M = k + 1 verifies them (the target's weights are read once a round)
# ---------------------------------------------------------------------------

def _spec_probs(logits, temperature: float):
    """The distribution `sample_token` draws from: softmax(logits / T) for
    T > 0, the one-hot argmax for T <= 0.  logits [..., V] f32."""
    if temperature > 0:
        return torch.softmax(logits / max(temperature, 1e-6), dim=-1)
    return torch.zeros_like(logits, dtype=torch.float32).scatter_(
        -1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)


def spec_accept(draft_tokens, target_logits, draft_logits, temperature: float,
                generator: torch.Generator | None = None,
                force_p: float | None = None):
    """The speculative-sampling acceptance rule (Leviathan et al. 2023,
    Chen et al. 2023), exact with respect to the target's sampling
    distribution, as the JAX package's `spec_accept`.

    draft_tokens [k] drawn from p_d(i) = probs(draft_logits[i]) ([k, V]);
    target_logits [k + 1, V]: row i verifies draft i, row k is the bonus
    distribution after all k drafts.  Returns (n_accept, next_token), 0-d
    device tensors: the round emits draft_tokens[:n_accept] then
    next_token, a draw from max(p_t - p_d, 0) at the first rejection or
    from the bonus row when all k are accepted.  At temperature <= 0 both
    distributions are one-hot: a draft is accepted iff it is the target's
    argmax, and next_token is the argmax of the residual or bonus (no draw
    is taken), so the output is greedy target decoding token for token.

    `force_p` (a measurement harness, MIOTTS_SPEC_FORCE_ACCEPT; None or NaN
    is off): each draft is accepted with probability force_p, whatever the
    logits, and the emitted tokens are then NOT target-distributed.  The
    uniforms come from `generator` (torch.rand), taken only where a draw
    decides something: at temperature > 0 or under force_p."""
    k = draft_tokens.shape[0]
    dev = target_logits.device
    p_t = _spec_probs(target_logits[:k], temperature)             # [k, V]
    p_d = _spec_probs(draft_logits, temperature)                   # [k, V]
    idx = torch.arange(k, device=dev)
    d = draft_tokens.long()
    ratio = p_t[idx, d] / p_d[idx, d].clamp(min=1e-30)
    forced = force_p is not None and not math.isnan(force_p)
    if temperature > 0 or forced:
        u = torch.rand((k,), generator=generator, device=dev)
        accept = u < (force_p if forced else ratio)
    else:
        accept = ratio > 0            # u < ratio with ratio 0 or >= 1
    n_accept = torch.cumprod(accept.long(), dim=0).sum()
    # row j of p_t and p_d by index_select: indexing by a 0-d tensor would
    # read it on the host
    j = n_accept.clamp(max=k - 1).view(1)
    pt_j = p_t.index_select(0, j)[0]
    residual = (pt_j - p_d.index_select(0, j)[0]).clamp(min=0.0)
    rsum = residual.sum()
    residual = torch.where(rsum > 0, residual / rsum.clamp(min=1e-30), pt_j)
    bonus = _spec_probs(target_logits[k], temperature)
    dist = torch.where(n_accept == k, bonus, residual)
    if temperature > 0:
        nxt = torch.multinomial(dist, 1, generator=generator)[0]
    else:
        nxt = torch.argmax(dist)
    return n_accept, nxt


@torch.no_grad()
def llm_generate_chunk_spec(params: dict, dparams: dict, pending, cache: dict,
                            dcache: dict, temperature: float, stop_ids,
                            cfg: LLMConfig, dcfg: LLMConfig, n_rounds: int,
                            k_spec: int, limit=None,
                            generator: torch.Generator | None = None,
                            force_p: float | None = None, done=None):
    """`n_rounds` draft-propose / target-verify rounds with no host sync
    (the JAX package's `llm_generate_chunk_spec`, whose device loop runs
    rounds until it has `n_steps` tokens; here the host fixes the rounds).

    `pending` [1]: the newest token, emitted by the caller and stop-checked
    but not yet in either cache, at position fill (both caches hold the
    same fill at a round's start).  Each round: the draft extends pending
    by k_spec tokens in S = 1 decode steps, plus one alignment step so its
    cache also covers d_k; ONE target forward over [pending, d_1..d_k] at
    positions fill + arange(k + 1) (the write-then-attend path: every
    linear runs at M = k + 1) verifies them; `spec_accept` keeps a prefix
    and draws the corrective or bonus token; the round's tokens are cut
    before the first stop token (which is not emitted, as in
    `llm_generate_chunk`); both fills roll back to fill + 1 + kept, so the
    rejected positions are rewritten by the next round.

    A round runs masked (emits nothing, changes no fill, pending or
    count) once a stop was seen (`done`, 0-d bool on the device, carried in
    from an earlier chunk) or once the chunk holds `limit` tokens (0-d
    int on the device; default no limit), as the JAX loop's condition
    `cnt < n_steps and not done`.  A round that starts below the limit may
    end up to k_spec tokens past it.  Masked rounds still run (their writes
    land at or past fill, clamped to the last cache column, where no kept
    token is attended).  The caches need k_spec + 1 positions of headroom
    past the last active round's start.

    Returns (buf [n_rounds * (k_spec + 1)] (-1 padded), count, done,
    pending, cache, dcache, rounds, accepted), the scalars as 0-d device
    tensors: rounds are the active rounds, accepted their accepted drafts
    (accepted / (rounds * k_spec) is the acceptance rate)."""
    K = k_spec
    dev = pending.device
    stop_ids = stop_ids.to(dev)
    s_max = cache["k"].shape[3]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    buf = torch.full((n_rounds * (K + 1),), -1, dtype=torch.int64, device=dev)
    count, rounds, accepted = zero, zero, zero
    if done is None:
        done = torch.zeros((), dtype=torch.bool, device=dev)
    slots = torch.arange(K + 1, device=dev)
    pending = pending.long()
    for _ in range(n_rounds):
        active = ~done
        if limit is not None:
            active = active & (count < limit)
        n = cache["fill"].long()                                   # [1]
        # the draft: K proposals, then the alignment step over d_K
        d_toks, d_logits = [], []
        tok = pending
        for i in range(K + 1):
            pos = (n + i).clamp(max=s_max - 1)[:, None]
            lg, dcache = llm_forward(dparams, tok[:, None], pos, dcache, dcfg)
            if i == K:
                break
            tok = sample_token(lg[:, 0], temperature, generator)
            d_toks.append(tok[0])
            d_logits.append(lg[0, 0])
        d_toks = torch.stack(d_toks)                               # [K]
        # ONE target forward verifies every draft
        vtoks = torch.cat([pending, d_toks])[None]                 # [1, K+1]
        vpos = (n[:, None] + slots).clamp(max=s_max - 1)
        t_logits, cache = llm_forward(params, vtoks, vpos, cache, cfg)
        a, nxt = spec_accept(d_toks, t_logits[0], torch.stack(d_logits),
                             temperature, generator, force_p)
        # d_1..d_a then the corrective / bonus token, cut at a stop
        out = torch.where(slots < a, d_toks[slots.clamp(max=K - 1)],
                          torch.where(slots == a, nxt, -1))
        is_stop = (out[:, None] == stop_ids[None, :]).any(dim=-1) & (out >= 0)
        any_stop = is_stop.any()
        n_emit = torch.where(any_stop, torch.argmax(is_stop.long()), a + 1)
        n_emit = torch.where(active, n_emit, 0)
        buf[(count + slots).clamp(max=buf.shape[0] - 1)] = torch.where(
            slots < n_emit, out, -1)
        # the rollback: both caches keep [.., pending, d_1..d_kept); the
        # corrective token is the next round's pending
        fill_new = torch.where(active, n + 1 + torch.minimum(n_emit, a),
                               n).to(torch.int32)
        cache["fill"] = fill_new
        dcache["fill"] = fill_new.clone()
        pending = torch.where(active & ~any_stop, nxt, pending)
        done = done | (active & any_stop)
        count = count + n_emit
        rounds = rounds + active.long()
        accepted = accepted + torch.where(active, a, 0)
    return buf, count, done, pending, cache, dcache, rounds, accepted


# ---------------------------------------------------------------------------
# Batched serving: slot prefill, per-slot sampling, chunked batched decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def llm_prefill_slots(params: dict, tokens, n_real, cache: dict, slots,
                      cfg: LLMConfig):
    """Prefill SEVERAL sequences into slots of a batched cache in one
    forward.  tokens [A, S_bucket]; n_real [A]; slots [A] (distinct).  A
    fresh sub-cache sized to the prompt bucket takes the prefill (the slots'
    old contents never matter: fill masks them), and its [0, S) positions
    are then written into the slots; a hybrid model's conv state starts
    from zeros and replaces the slots' state.  Updates `cache` in place;
    returns (last_logits [A, V], cache)."""
    A, S = tokens.shape
    dev = tokens.device
    sub = {k: v.new_zeros(v.shape[:1] + (A,) + v.shape[2:]) if k == "conv"
           else v.new_zeros(v.shape[:1] + (A,) + v.shape[2:3] + (S,)
                            + v.shape[4:])
           for k, v in cache.items() if k != "fill"}
    sub["fill"] = torch.zeros((A,), dtype=torch.int32, device=dev)
    pos = torch.arange(S, device=dev).expand(A, S)
    slots = slots.to(device=dev, dtype=torch.long)
    n_real = n_real.to(device=dev, dtype=torch.int32)
    with tracer.span("llm.prefill"):
        logits, sub = llm_forward(params, tokens, pos, sub, cfg,
                                  advance=n_real)
    for k in sub:
        if k == "conv":
            cache[k][:, slots] = sub[k]
        elif k != "fill":
            cache[k][:, slots, :, :S] = sub[k]
    cache["fill"][slots] = n_real
    last = logits[torch.arange(A, device=dev), n_real.long() - 1]
    return last, cache


def _decode_core(params, tok, pos, cache, cfg: LLMConfig, chunk_buf,
                 conv_state=None, advance=None):
    """One batched decode step against a READ-ONLY attention cache.  tok
    [B]; pos [B, 1]; chunk_buf = (k_buf [L, B, H_kv, W, D], v_buf, valid
    [B, W]) over the L attention layers.  A hybrid model also takes its
    conv state [n_conv, B, L_cache - 1, dim] and `advance` [B] (1 where
    the slot really advances).  Returns (logits [B, V] f32, kvs, new_conv)
    with kvs {k, v} [L, B, H_kv, D], this token's raw k / v of every
    attention layer, and the new conv state (None for a dense model)."""
    x = params["token_embd"][tok.long()][:, None]
    k_buf, v_buf, valid = chunk_buf
    kv_list, conv_list = [], []
    for kind, blk in _layer_plan(params, cfg):
        if kind == "attn":
            li = len(kv_list)
            with tracer.span("llm.attn"):
                x, kv = _block_forward(
                    x, blk, _layer(cache, li), cache["fill"], pos, cfg,
                    defer_write=True, chunk_buf=(k_buf[li], v_buf[li], valid),
                    tp=params.get("tp"))
            kv_list.append(kv)
        else:
            with tracer.span("llm.conv"):
                x, st = _conv_block_forward(x, blk, conv_state[len(conv_list)],
                                            advance, cfg)
            conv_list.append(st)
    kvs = {key: torch.stack([kv[key] for kv in kv_list]) for key in ("k", "v")}
    new_conv = torch.stack(conv_list) if conv_list else None
    return _logits(params, x, cfg)[:, 0], kvs, new_conv


# splitmix64 constants as signed int64 (torch has no uint64 arithmetic)
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _srl(z, s: int):
    """Logical right shift of int64 (torch's >> is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def slot_uniform(seed, drawn):
    """The uniform in [0, 1) of draw number `drawn` of a request seeded with
    `seed` (int64 tensors of one shape): output drawn + 1 of the splitmix64
    generator started at `seed`, top 53 bits.  Counter-based, so a
    request's draws depend on its own seed and count only, never on its
    neighbours in the batch; int64 products wrap as uint64 ones do."""
    z = seed + (drawn + 1) * _GOLDEN
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    z = z ^ _srl(z, 31)
    return _srl(z, 11).double() * (1.0 / (1 << 53))


def sample_tokens_slots(logits, temperature, seed, drawn):
    """Per-slot temperature sampling in one vectorised draw (no per-row
    launches, no host sync).  logits [B, V] f32; temperature [B] f32 (<= 0:
    greedy, argmax with the first index on ties); seed / drawn [B] int64.
    Sampled rows take the inverse CDF of softmax(logits / t) at
    slot_uniform(seed, drawn).  JAX's threefry cannot be reproduced here, so
    sampled tokens are the port's own; greedy rows match the JAX package."""
    greedy = torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature.clamp(min=1e-6)[:, None], -1)
    cdf = torch.cumsum(probs, dim=-1)
    u = (slot_uniform(seed, drawn) * cdf[:, -1].double()).float()
    sampled = torch.searchsorted(cdf, u[:, None], right=True)[:, 0]
    sampled = sampled.clamp(max=logits.shape[-1] - 1)
    return torch.where(temperature > 0, sampled, greedy)


@torch.no_grad()
def llm_generate_chunk_batched(params: dict, last_logits, cache: dict,
                               active, seed, drawn, temperature, stop_ids,
                               cfg: LLMConfig, n_steps: int,
                               attn_len: int = 0, codes: dict | None = None):
    """Batched generation of n_steps tokens for every ACTIVE slot, with
    per-slot stop detection and no host sync: the whole chunk is enqueued
    on the device and read by the caller once.

    Chunk-buffered cache protocol (the JAX package's): the big cache is
    read-only through the chunk; each step's raw k/v land in a small
    [L, B, H_kv, n_steps, D] buffer at the step's column (the same column
    for every slot), attended through `buf_valid`, and ONE scatter per
    chunk merges the buffer into the cache (quantized there for an int8
    cache).  A slot that stops never resumes within a chunk, so its valid
    columns are its first `adv` ones, positions fill0 .. fill0 + adv - 1.
    Columns past adv park at the last cache position, which fill never
    covers before the sequence itself rewrites it.  A hybrid model's conv
    state is small and rides the loop (advancing only while the slot is
    active); it is written back with the merge.

    `attn_len` (0 = full): attention reads only the first attn_len cache
    positions (a strided view, never a copy); the caller guarantees every
    active slot's fill + n_steps <= attn_len.  The merge targets the full
    cache.  All n_steps steps run even when every slot has stopped (a
    device-side early exit would need a host sync per step); the extra
    steps change nothing an active slot reads.

    last_logits [B, V]; active bool [B]; seed / drawn int64 [B] (the
    sampler's per-slot state, see sample_tokens_slots; `drawn` advances
    only while the slot is active); temperature f32 [B]; stop_ids [n_stop].
    Updates `cache` in place.  Returns (buf [B, n_steps] int64 (-1 where
    the slot was inactive or stopped), active, last_logits, cache, drawn).

    `codes` (the fused batch step, runtime/engine._fused_batch_step): the
    per-slot state {"table": token -> code [V'] (-1 for none), "buf":
    codes [B, bucket] int32, "n_codes", "n_tokens", "max_toks": int32 [B]}.
    Each step then also ends a slot at its token budget, tested on
    n_tokens before the step's increment (a slot at its budget draws,
    goes inactive and keeps nothing), and writes the kept token's code at
    buf[b, n_codes[b]] while the row has room.  "buf" is written in
    place; "n_codes" and "n_tokens" are replaced by the new counts."""
    B = last_logits.shape[0]
    dev = last_logits.device
    L, _, H_kv, s_max, D = cache["k"].shape
    if attn_len and attn_len < s_max:
        view = {k: (v if k in ("fill", "conv") else v[:, :, :, :attn_len])
                for k, v in cache.items()}
    else:
        view = cache
    conv = cache.get("conv")
    bdt = torch.float32 if cache["k"].dtype == torch.float32 else torch.bfloat16
    buf = torch.full((B, n_steps), -1, dtype=torch.int64, device=dev)
    k_buf = torch.zeros((L, B, H_kv, n_steps, D), dtype=bdt, device=dev)
    v_buf = torch.zeros_like(k_buf)
    valid = torch.zeros((B, n_steps), dtype=torch.bool, device=dev)
    adv = torch.zeros((B,), dtype=torch.int32, device=dev)
    fill0 = cache["fill"]
    stop_ids = stop_ids.to(dev)
    if codes is not None:
        table, code_buf = codes["table"], codes["buf"]
        n_codes, n_tokens = codes["n_codes"], codes["n_tokens"]
        bucket = code_buf.shape[1]
        rows = torch.arange(B, device=dev)
    last = last_logits
    for i in range(n_steps):
        with tracer.span("llm.step"):
            with tracer.span("llm.sample"):
                tok = sample_tokens_slots(last, temperature, seed, drawn)
                drawn = drawn + active.long()
                is_stop = (tok[:, None] == stop_ids[None, :]).any(dim=-1)
                active = active & ~is_stop
            if codes is not None:
                active = active & (n_tokens < codes["max_toks"])
                n_tokens = n_tokens + active.int()
                code = table[tok.clamp(0, table.shape[0] - 1)].int()
                col = n_codes.clamp(max=bucket - 1).long()
                write = active & (code >= 0) & (n_codes < bucket)
                code_buf[rows, col] = torch.where(write, code,
                                                  code_buf[rows, col])
                n_codes = n_codes + write.int()
            buf[:, i] = torch.where(active, tok, -1)
            pos = torch.where(active, fill0 + adv, s_max - 1)[:, None]
            step = active.int()
            last, kvs, conv = _decode_core(params, tok, pos, view, cfg,
                                           (k_buf, v_buf, valid), conv, step)
            k_buf[:, :, :, i] = kvs["k"].to(bdt)
            v_buf[:, :, :, i] = kvs["v"].to(bdt)
            valid[:, i] = active
            adv = adv + step

    # ONE merge scatter: slot b's column j -> position fill0[b] + j while
    # j < adv[b], else the parked last position
    with tracer.span("llm.merge"):
        j_idx = torch.arange(n_steps, device=dev)
        tpos = torch.where(j_idx[None, :] < adv[:, None],
                           fill0[:, None].long() + j_idx[None, :], s_max - 1)
        b_idx = torch.arange(B, device=dev)[:, None]
        if "k_scale" in cache:
            kq, ks = _kv_quantize(k_buf.float())
            vq, vs = _kv_quantize(v_buf.float())
            updates = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            updates = {"k": k_buf, "v": v_buf}
        for name, upd in updates.items():
            # [L, B, H, W(, D)] -> [B, W, L, H(, D)]: the advanced indices
            # (b, tpos) at cache dims 1 and 3 put their broadcast dims first
            upd = upd.movedim(1, 0).movedim(3, 1)
            cache[name][:, b_idx, :, tpos] = upd.to(cache[name].dtype)
        if conv is not None:
            cache["conv"].copy_(conv)
        cache["fill"] = fill0 + adv
    if codes is not None:
        codes.update(n_codes=n_codes, n_tokens=n_tokens)
    return buf, active, last, cache, drawn
