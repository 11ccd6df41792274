"""Causal-LM decode engine in PyTorch (counterpart of
`miotts_tpu/models/llm.py`, dense architectures).

llama / qwen2 / qwen3 / mio: RMSNorm + SwiGLU + GQA + RoPE, with per-arch
toggles for QKV bias, QK-norm and the RoPE style.  Quantized weights stay
packed (ops/qmat.QTensor) and every linear goes through `qdot`, which on a
GPU is the hand-written CUDA kernel.

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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..gguf.quants import is_quantized
from ..ops.qmat import QTensor, concat_qtensors, qdot, qtensor_from_raw

# Per-arch behaviour toggles (llama.cpp build_* graph equivalents).
_ARCH_TABLE = {
    "llama": dict(rope_style="norm", qkv_bias=False, qk_norm=False),
    "qwen2": dict(rope_style="neox", qkv_bias=True, qk_norm=False),
    "qwen3": dict(rope_style="neox", qkv_bias=False, qk_norm=True),
    "mio": dict(rope_style="neox", qkv_bias=True, qk_norm=False),
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

    @classmethod
    def from_gguf(cls, reader) -> "LLMConfig":
        arch = str(reader.kv.get("general.architecture", "qwen2"))
        if arch not in _ARCH_TABLE:
            raise ValueError(f"unsupported LLM architecture {arch!r} "
                             f"(dense llama/qwen2/qwen3/mio only)")
        p = arch + "."
        g = lambda k, d: int(reader.kv.get(p + k, d))
        gf = lambda k, d: float(reader.kv.get(p + k, d))
        dim = g("embedding_length", 1024)
        hc = reader.kv.get(p + "attention.head_count", 16)
        if isinstance(hc, (list, tuple)):
            raise ValueError("hybrid (per-layer head count) models are not "
                             "supported by the port yet")
        n_heads = int(hc)
        n_vocab = (len(reader.kv.get("tokenizer.ggml.tokens", []))
                   or g("vocab_size", 32000))
        return cls(
            arch=arch,
            n_layers=g("block_count", 24),
            dim=dim,
            n_heads=n_heads,
            n_kv_heads=int(reader.kv.get(p + "attention.head_count_kv", n_heads)),
            head_dim=g("attention.key_length", dim // n_heads),
            ff_dim=g("feed_forward_length", 4 * dim),
            n_vocab=n_vocab,
            n_ctx=g("context_length", 2048),
            rope_theta=gf("rope.freq_base", 10000.0),
            rms_eps=gf("attention.layer_norm_rms_epsilon", 1e-6),
            tie_embedding=not reader.has_tensor("output.weight"),
            **_ARCH_TABLE[arch],
        )


# ---------------------------------------------------------------------------
# Weight loading
# ---------------------------------------------------------------------------

def _load_matrix(reader, name: str, dtype, device) -> Any:
    """Quantized formats stay packed as a QTensor; float formats become
    dense [out, in] tensors in `dtype`."""
    info = reader.tensors[name]
    if is_quantized(info.ggml_type):
        rows, cols = info.shape
        return qtensor_from_raw(reader.tensor_raw(name), info.ggml_type,
                                rows, cols, device=device)
    return torch.from_numpy(reader.tensor_f32(name)).to(device=device,
                                                        dtype=dtype)


def fuse_block(blk: dict, cfg: LLMConfig) -> dict:
    """q/k/v and gate/up into single matmuls (7 -> 4 per layer) when the
    siblings are all quantized or all dense."""
    def same(keys):
        return (all(isinstance(blk[k], QTensor) for k in keys)
                or all(isinstance(blk[k], torch.Tensor) for k in keys))
    if same(("wq", "wk", "wv")):
        blk["wqkv"] = concat_qtensors([blk.pop("wq"), blk.pop("wk"),
                                       blk.pop("wv")])
        if cfg.qkv_bias:
            blk["bqkv"] = torch.cat([blk.pop("bq"), blk.pop("bk"),
                                     blk.pop("bv")])
    if same(("w_gate", "w_up")):
        blk["w_gateup"] = concat_qtensors([blk.pop("w_gate"), blk.pop("w_up")])
    return blk


def load_llm_params(reader, cfg: LLMConfig | None = None,
                    dtype=torch.bfloat16,
                    device="cpu") -> tuple[dict, LLMConfig]:
    """LLM weights from GGUF (llama.cpp tensor naming) onto `device`, with
    q/k/v and gate/up fused."""
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
        blk = {"attn_norm": vec(p + "attn_norm.weight"),
               "ffn_norm": vec(p + "ffn_norm.weight")}
        for key, name in (("wq", "attn_q"), ("wk", "attn_k"),
                          ("wv", "attn_v"), ("wo", "attn_output"),
                          ("w_gate", "ffn_gate"), ("w_up", "ffn_up"),
                          ("w_down", "ffn_down")):
            blk[key] = _load_matrix(reader, p + name + ".weight", dtype, device)
        if cfg.qkv_bias:
            for key, name in (("bq", "attn_q"), ("bk", "attn_k"),
                              ("bv", "attn_v")):
                blk[key] = vec(p + name + ".bias")
        if cfg.qk_norm:
            blk["q_norm"] = vec(p + "attn_q_norm.weight")
            blk["k_norm"] = vec(p + "attn_k_norm.weight")
        blocks.append(fuse_block(blk, cfg))
    params["blocks"] = blocks
    return params, cfg


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


def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int | None = None,
                  dtype=torch.bfloat16, device="cpu") -> dict:
    """Dense KV cache: k/v [L, B, H_kv, S, D] + fill counts [B] (int32)."""
    S = max_len or cfg.n_ctx
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "fill": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _attend(q, k_cache, v_cache, fill, q_pos, k_cur=None, v_cur=None):
    """Causal attention against the cache.  q [B, S_q, H, D]; k/v_cache
    [B, H_kv, S_max, D]; fill [B] valid entries; q_pos [B, S_q].

    With k_cur / v_cur [B, 1, H_kv, D] (deferred-write decode) the current
    token is NOT in the cache and rides as one extra, always-valid column.
    Dots take their inputs in the compute dtype and sum in f32 (the exact
    products of bf16 values, as JAX's preferred_element_type=f32)."""
    B, S_q, H, D = q.shape
    H_kv, S_max = k_cache.shape[1], k_cache.shape[2]
    rep = H // H_kv
    cdt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    qg = q.to(cdt).float().reshape(B, S_q, H_kv, rep, D)
    kf = k_cache.to(cdt).float()
    vf = v_cache.to(cdt).float()
    scale = math.sqrt(D)
    scores = torch.einsum("bqgrd,bgkd->bgrqk", qg, kf) / scale
    key_pos = torch.arange(S_max, device=q.device)
    valid = ((key_pos[None, None, :] <= q_pos[:, :, None])
             & (key_pos[None, None, :] < fill[:, None, None]))
    scores = scores.masked_fill(~valid[:, None, None], -1e9)
    if k_cur is not None:
        s_cur = torch.einsum("bqgrd,bqgd->bgrq", qg,
                             k_cur.to(cdt).float()) / scale
        scores = torch.cat([scores, s_cur[..., None]], dim=-1)
    probs = torch.softmax(scores, dim=-1)
    if k_cur is not None:
        p_cur = probs[..., -1]
        probs = probs[..., :-1]
    out = torch.einsum("bgrqk,bgkd->bqgrd", probs.to(cdt).float(), vf)
    if k_cur is not None:
        out = out + torch.einsum("bgrq,bqgd->bqgrd", p_cur.to(cdt).float(),
                                 v_cur.to(cdt).float())
    return out.reshape(B, S_q, H * D).to(cdt)


def _block_forward(x, blk, lk, lv, fill, pos, cfg: LLMConfig,
                   defer_write: bool = False):
    """One transformer block.  x [B, S, dim]; lk / lv this layer's cache
    [B, H_kv, S_max, D]; pos [B, S] absolute positions.

    defer_write (decode): the cache is only read, and the block returns
    (x, (k, v)) for this token, [B, H_kv, D] each, for the caller's single
    post-loop write.  Otherwise (prefill) k/v are written into lk / lv in
    place at their positions first, and the block returns (x, None)."""
    B, S, _ = x.shape
    H, H_kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
    qd, kvd = H * D, H_kv * D
    if "wqkv" in blk:
        qkv = qdot(h, blk["wqkv"])
        if cfg.qkv_bias:
            qkv = qkv + blk["bqkv"].to(qkv.dtype)
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    else:
        q, k, v = (qdot(h, blk["wq"]), qdot(h, blk["wk"]), qdot(h, blk["wv"]))
        if cfg.qkv_bias:
            q = q + blk["bq"].to(q.dtype)
            k = k + blk["bk"].to(k.dtype)
            v = v + blk["bv"].to(v.dtype)
    q = q.reshape(B, S, H, D)
    k = k.reshape(B, S, H_kv, D)
    v = v.reshape(B, S, H_kv, D)
    if cfg.qk_norm:
        q = _rms_norm(q, blk["q_norm"], cfg.rms_eps)
        k = _rms_norm(k, blk["k_norm"], cfg.rms_eps)
    q = _rope(q, pos, cfg.rope_theta, cfg.rope_style)
    k = _rope(k, pos, cfg.rope_theta, cfg.rope_style)

    if defer_write:
        kv_out = (k[:, 0].to(lk.dtype), v[:, 0].to(lv.dtype))
        attn = _attend(q, lk, lv, fill, pos, k_cur=k, v_cur=v)
    else:
        kv_out = None
        b_idx = torch.arange(B, device=x.device)[:, None]
        p = pos.clamp(max=lk.shape[2] - 1).long()
        lk[b_idx, :, p] = k.to(lk.dtype)
        lv[b_idx, :, p] = v.to(lv.dtype)
        new_fill = torch.maximum(fill, pos[:, -1] + 1)
        attn = _attend(q, lk, lv, new_fill, pos)
    x = x + qdot(attn.to(x.dtype), blk["wo"])

    h = _rms_norm(x, blk["ffn_norm"], cfg.rms_eps)
    if "w_gateup" in blk:
        gu = qdot(h, blk["w_gateup"])
        ff = gu.shape[-1] // 2
        gate, up = F.silu(gu[..., :ff]), gu[..., ff:]
    else:
        gate, up = F.silu(qdot(h, blk["w_gate"])), qdot(h, blk["w_up"])
    x = x + qdot((gate * up).to(x.dtype), blk["w_down"])
    return x, kv_out


@torch.no_grad()
def llm_forward(params: dict, tokens, pos, cache: dict, cfg: LLMConfig):
    """Run the transformer over `tokens` [B, S] at positions `pos` [B, S],
    updating `cache` in place.  Returns (logits [B, S, V] f32, cache) with
    cache["fill"] = max(fill, pos[:, -1] + 1).  S == 1 is the deferred-write
    decode, S > 1 the prefill."""
    x = params["token_embd"][tokens.long()]
    B, S, _ = x.shape
    fill = cache["fill"]
    if S == 1:
        kvs = []
        for li, blk in enumerate(params["blocks"]):
            x, kv = _block_forward(x, blk, cache["k"][li], cache["v"][li],
                                   fill, pos, cfg, defer_write=True)
            kvs.append(kv)
        # ONE write per cache field for every layer's new k/v: dims 1 (batch)
        # and 3 (position) are indexed, so the update is [B, L, H_kv, D];
        # like JAX's dynamic_update_slice the position clamps to the end
        b_idx = torch.arange(B, device=x.device)
        p = pos[:, 0].clamp(max=cache["k"].shape[3] - 1).long()
        cache["k"][:, b_idx, :, p] = torch.stack([kv[0] for kv in kvs], dim=1)
        cache["v"][:, b_idx, :, p] = torch.stack([kv[1] for kv in kvs], dim=1)
    else:
        for li, blk in enumerate(params["blocks"]):
            x, _ = _block_forward(x, blk, cache["k"][li], cache["v"][li],
                                  fill, pos, cfg)
    cache["fill"] = torch.maximum(fill, (pos[:, -1] + 1).to(fill.dtype))

    x = _rms_norm(x, params["output_norm"], cfg.rms_eps)
    out_w = params.get("output")
    if out_w is None:
        # tied embeddings: a plain product outside any kernel, f32 sums
        logits = x.float() @ params["token_embd"].float().T
    else:
        logits = qdot(x, out_w)
    return logits.float(), cache


def llm_prefill(params, tokens, n_real, cache, cfg: LLMConfig):
    """Prefill a right-padded [B, S_bucket] prompt; `n_real` [B] are the true
    lengths.  Padding positions are written to the cache but `fill` only
    advances to n_real, so later tokens never attend them.  Returns
    (last_logits [B, V], cache)."""
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    logits, cache = llm_forward(params, tokens, pos, cache, cfg)
    n_real = n_real.to(device=tokens.device, dtype=torch.int32)
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


@torch.no_grad()
def llm_generate_chunk(params: dict, last_logits, cache: dict,
                       temperature: float, stop_ids, cfg: LLMConfig,
                       n_steps: int, generator: torch.Generator | None = None):
    """Generate up to `n_steps` tokens (single sequence) with no host sync:
    sample -> stop-check -> decode runs `n_steps` times on the device, and
    the stop flag, token buffer and count stay there until the caller reads
    them once per chunk.

    After a stop token nothing changes any more: the buffer keeps -1, the
    count and `fill` stop advancing and `last_logits` is kept (the masked
    steps still run; their cache writes land at `fill`, which no later
    token attends before rewriting it).

    last_logits [1, V]; stop_ids int [n_stop] (pad with -1).  Returns
    (tokens [n_steps] (-1 padded), n_generated, done, last_logits, cache)
    with n_generated and done as 0-d device tensors."""
    dev = last_logits.device
    stop_ids = stop_ids.to(dev)
    buf = torch.full((n_steps,), -1, dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    last = last_logits
    for i in range(n_steps):
        tok = sample_token(last, temperature, generator)
        done = done | (tok[0] == stop_ids).any()
        active = ~done
        buf[i] = torch.where(active, tok[0], buf[i])
        count = count + active.long()
        fill = cache["fill"]
        logits, cache = llm_decode_step(params, tok, cache, cfg)
        cache["fill"] = torch.where(active, cache["fill"], fill)
        last = torch.where(active, logits, last)
    return buf, count, done, last, cache
