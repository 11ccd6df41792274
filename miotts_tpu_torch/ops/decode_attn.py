"""Single-query decode attention (counterparts of
`miotts_tpu/ops/decode_attn.py:decode_attention` and
`decode_attention_batched`).

Both take one query per row against that row's KV cache: q [B, H, D];
k/v cache [B, H_kv, S, D] bf16 / f32, or int8 with f32 scales
[B, H_kv, S]; fill / q_pos [B].  Key s is valid iff
s < min(fill[b], q_pos[b] + 1).  A CUDA tensor goes through a hand-written
kernel (and raises if it cannot build or launch); a CPU tensor goes through
the `*_plain` version, the same function in plain torch.

`decode_attention` (kernel `ops/csrc/decode_attn_single.cu`): the hybrid
decode's attention, all in f32.  q (bf16 or f32, upcast in the kernel) and
k are upcast, an int8 cache is dequantized by its scales, probabilities are
not rounded.  Returns f32 [B, H, D] = acc / max(l, 1e-20); a row with no
valid key returns 0.  The kernel splits each row's valid keys over a
thread-block cluster of `_single_plan(...).ranks` blocks, in contiguous
shares; each rank keeps its own flash state and rank 0 combines them in
rank order (only the order of f32 sums depends on the split).

`decode_attention_batched` (kernel `ops/csrc/decode_attn.cu`): the
attention of batched serving, as a flash state (acc, m, l) that
`models/llm.py:_attend_bkernel` folds together with the chunk-buffer and
current-token columns.  Returns f32 [B, H, D], or (acc [B, H, D]
unnormalised, m [B, H], l [B, H]) with return_stats.  Float mode computes
in the cache's type: q is cast to it, probabilities are rounded to it
before the PV product, sums are f32.  int8 mode quantizes q per (b, h)
row (`quantize_query`; the kernel does it itself, with the bits
`quantize_query` gives on a CUDA tensor), takes int8 x int8 scores and
quantizes the probabilities (times the v scales) to int8 per query row per
tile of S_TILE keys (`quantize_probs`) — a grouping that is part of the
result (~1 % of the row scale).  The TPU grid's b_tile and its
VMEM-driven tile halving have no counterpart here.  The kernel splits each
tile's valid keys over a thread-block cluster of `_attn_plan(...).ranks`
blocks, in contiguous shares; the ranks swap their row maxima, so p (and
p_i8) are the one-block values at any split.

`dma_floor` (K7, kernel `ops/csrc/dma_floor.cu`): a probe that streams the
k / v rows in K5's layout (its cluster split from `_single_plan`, its chunks
staged by `cp.async`) with no arithmetic beyond its 8 output rows a tile,
the floor of that layout's time; no attention calls it.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from .qmat import H100_SMS, _sm_count

NEG = -1e9
S_TILE = 512                      # keys per tile: the int8 quantization group
HEAD_DIMS = (64, 80, 128)
MAX_REP = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# K6's split (ops/csrc/decode_attn.cu, whose MAX_RANKS this is): a (b, kv
# head) is a thread-block cluster of at most ATTN_MAX_RANKS blocks (the
# portable cluster size), toward ATTN_BLOCKS_PER_SM blocks an SM, each rank
# taking at least ATTN_MIN_RANK_KEYS keys of a full tile; an int8 cache
# splits only rows of ATTN_INT8_MIN_SPLIT keys or more.
ATTN_MAX_RANKS = 8
ATTN_BLOCKS_PER_SM = 2
ATTN_MIN_RANK_KEYS = 128
ATTN_INT8_MIN_SPLIT = 512


# K5's split (ops/csrc/decode_attn_single.cu, whose MAX_RANKS is
# ATTN_MAX_RANKS too): a (b, kv head) is a cluster of at most ATTN_MAX_RANKS
# blocks, one block an SM at most, each rank taking at least
# SINGLE_MIN_RANK_KEYS keys of the cache.
SINGLE_MIN_RANK_KEYS = 32


@dataclass(frozen=True)
class AttnPlan:
    """How K5 or K6 covers a (b, kv head): a cluster of `ranks` blocks,
    each taking a contiguous share of the row's (K6: of every tile's) valid
    keys."""
    ranks: int


@functools.lru_cache(maxsize=None)
def _attn_plan(B: int, H_kv: int, S: int, sms: int = H100_SMS,
               int8: bool = False) -> AttnPlan:
    """K6's plan for B slots of H_kv kv heads over an S-key cache (attn_len)
    on a card of `sms` SMs, from shapes and the cache's type only (never
    the fills: no host sync).  One rank where the B * H_kv clusters already
    give ATTN_BLOCKS_PER_SM blocks an SM (a split only adds barriers
    there), and for an int8 cache of fewer than ATTN_INT8_MIN_SPLIT keys
    (its ps maxima cost a second cluster barrier a tile: on the H100 one
    rank was faster at S = 256, PERF.md); else enough ranks for that, or
    one a tile of the longest row, whichever is more, at most
    ATTN_MAX_RANKS and at most one per ATTN_MIN_RANK_KEYS keys of a tile
    (one rank was faster on 128-key rows).  (0.1B's 64 x 4 = 256 clusters:
    2 ranks at S = 256 and 512, int8 1 at 256; LFM2's 16 x 8 = 128: 2 at S
    = 256 (int8 1), 3 at 1024, 4 at 2048; the 2.6B's 64 x 8 = 512: 1.)"""
    if B < 1 or H_kv < 1 or S < 1 or sms < 1:
        raise ValueError(f"no attention plan for B={B} H_kv={H_kv} S={S} "
                         f"sms={sms}")
    if (B * H_kv >= ATTN_BLOCKS_PER_SM * sms
            or (int8 and S < ATTN_INT8_MIN_SPLIT)):
        return AttnPlan(ranks=1)
    occupancy = -(-ATTN_BLOCKS_PER_SM * sms // (B * H_kv))
    length = -(-S // S_TILE)
    cap = max(1, min(S, S_TILE) // ATTN_MIN_RANK_KEYS)
    return AttnPlan(ranks=min(ATTN_MAX_RANKS, cap, max(occupancy, length)))


@functools.lru_cache(maxsize=None)
def _single_plan(B: int, H_kv: int, S: int, sms: int = H100_SMS) -> AttnPlan:
    """K5's plan for B rows of H_kv kv heads over an S-key cache on a card
    of `sms` SMs, from shapes only (never the fills: no host sync): as many
    ranks as fit one block an SM (sms // (B * H_kv)), at most
    ATTN_MAX_RANKS and at most one per SINGLE_MIN_RANK_KEYS keys of S, at
    least one.  (LFM2's offline decode, B = 1 x 8 kv heads: 8 ranks, 64
    blocks, from S = 256 on; 4 rows x 8: 4.)"""
    if B < 1 or H_kv < 1 or S < 1 or sms < 1:
        raise ValueError(f"no attention plan for B={B} H_kv={H_kv} S={S} "
                         f"sms={sms}")
    return AttnPlan(ranks=max(1, min(ATTN_MAX_RANKS, sms // (B * H_kv),
                                     S // SINGLE_MIN_RANK_KEYS)))


def quantize_probs(ps: torch.Tensor):
    """int8 mode's probability quantization over the last axis (one tile's
    keys of a query row): psc = max(max(ps), 1e-20) / 127, p_i8 =
    trunc(ps / psc + 0.5), as int-valued f32.  Returns (p_i8, psc)."""
    psc = ps.amax(dim=-1, keepdim=True).clamp(min=1e-20) / 127.0
    return torch.trunc(ps / psc + 0.5), psc


def quantize_query(q: torch.Tensor):
    """Per-(b, h) symmetric int8 of q [B, H, D] (round half to even, clip
    +-127): (int-valued f32 [B, H, D], scale f32 [B, H]).  On a CUDA tensor
    PyTorch divides by the scalar 127 as a multiplication by its f32
    reciprocal, on a CPU tensor it divides; K6 reproduces the CUDA bits."""
    qf = q.float()
    qs = qf.abs().amax(dim=-1).clamp(min=1e-20) / 127.0
    return torch.round(qf / qs[..., None]).clamp(-127, 127), qs


def decode_attention_batched_plain(q, k_cache, v_cache, fill, q_pos,
                                   k_scale=None, v_scale=None,
                                   return_stats: bool = False):
    """The kernel's arithmetic in plain torch, tile by tile.  Integer dots
    run as f32 products of int-valued floats, exact below 2^24 (|q|, |k|,
    |p|, |v| <= 127, D <= 128, 512 keys a tile)."""
    B, H, D = q.shape
    H_kv, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // H_kv
    int8 = k_cache.dtype == torch.int8
    scale = 1.0 / math.sqrt(D)
    limit = torch.minimum(fill.long(), q_pos.long() + 1)
    if int8:
        qq, qs = quantize_query(q)
        qg = qq.reshape(B, H_kv, rep, D)
        qss = (qs * scale).reshape(B, H_kv, rep, 1)
    else:
        cdt = k_cache.dtype
        qg = q.to(cdt).float().reshape(B, H_kv, rep, D)
    acc = q.new_zeros((B, H_kv, rep, D), dtype=torch.float32)
    m = torch.full((B, H_kv, rep, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for t0 in range(0, S, S_TILE):
        t1 = min(S, t0 + S_TILE)
        kt = k_cache[:, :, t0:t1].float()
        vt = v_cache[:, :, t0:t1].float()
        kpos = torch.arange(t0, t1, device=q.device)
        mask = (kpos[None, :] < limit[:, None])[:, None, None, :]
        s = torch.einsum("bgrd,bgtd->bgrt", qg, kt)
        if int8:
            s = s * qss * k_scale[:, :, None, t0:t1]
        else:
            s = s * scale
        s = s.masked_fill(~mask, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if int8:
            p8, psc = quantize_probs(p * v_scale[:, :, None, t0:t1])
            pv = torch.einsum("bgrt,bgtd->bgrd", p8, vt) * psc
        else:
            pv = torch.einsum("bgrt,bgtd->bgrd", p.to(cdt).float(), vt)
        acc = acc * alpha + pv
        m = m_new
    if return_stats:
        return (acc.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H))
    return (acc / l.clamp(min=1e-20)).reshape(B, H, D)


def _check_strided(t: torch.Tensor, name: str) -> None:
    """16-byte-aligned rows: base, and every stride, in whole 16 bytes."""
    el = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must be contiguous")
    if t.data_ptr() % 16 or any(st * el % 16 for st in t.stride()[:-1]):
        raise ValueError(f"{name}: rows must be 16-byte aligned "
                         f"(strides {t.stride()}, {el}-byte elements)")


def _check_inputs(q, k_cache, v_cache, fill, q_pos, k_scale, v_scale,
                  kernel: str) -> None:
    """What both kernels take (raises before any build or launch): shapes,
    head dims, GQA ratios, dtypes, one GPU, 16-byte-aligned strided rows,
    scales exactly for an int8 cache."""
    B, H, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v cache must both be [B, H_kv, S, D], got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    _, H_kv, S, Dk = k_cache.shape
    if k_cache.shape[0] != B or Dk != D:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{kernel} kernel takes head dim {HEAD_DIMS}, "
                         f"got {D}")
    if H % H_kv or not 1 <= H // H_kv <= MAX_REP:
        raise ValueError(f"{kernel} kernel takes H / H_kv in 1..{MAX_REP},"
                         f" got {H} / {H_kv}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    if k_cache.dtype not in _DTYPE_CODE or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"cache must be f32, bf16 or int8 (k and v alike), "
                        f"got {k_cache.dtype} / {v_cache.dtype}")
    int8 = k_cache.dtype == torch.int8
    if int8 != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache needs k_scale and v_scale, and only "
                         "an int8 cache takes them")
    tensors = [q, k_cache, v_cache, fill, q_pos]
    if int8:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{kernel} kernel: every tensor must be on "
                             f"q's GPU")
    if tuple(fill.shape) != (B,) or tuple(q_pos.shape) != (B,):
        raise ValueError("fill and q_pos must be [B]")
    _check_strided(k_cache, "k_cache")
    _check_strided(v_cache, "v_cache")
    if int8:
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            if (t.dtype != torch.float32 or tuple(t.shape) != (B, H_kv, S)
                    or t.stride(-1) != 1):
                raise ValueError(f"{name} must be f32 [B, H_kv, S] with a "
                                 f"contiguous last dim")


def _decode_attention_cuda(q, k_cache, v_cache, fill, q_pos, k_scale,
                           v_scale, return_stats, plan: AttnPlan | None = None):
    """Launch `decode_attn_launch` (ops/csrc/decode_attn.cu) on the current
    stream under `plan` (None: `_attn_plan`'s for the card).  The cache may
    be a strided view; it is never copied."""
    from ._build import load_kernels
    if plan is not None and not 1 <= plan.ranks <= ATTN_MAX_RANKS:
        raise ValueError(f"decode_attn kernel takes 1..{ATTN_MAX_RANKS} "
                         f"ranks, got {plan.ranks}")
    _check_inputs(q, k_cache, v_cache, fill, q_pos, k_scale, v_scale,
                  "decode_attn")
    B, H, D = q.shape
    _, H_kv, S, _ = k_cache.shape
    int8 = k_cache.dtype == torch.int8
    if plan is None:
        plan = _attn_plan(B, H_kv, S, _sm_count(q.device), int8)
    if int8:       # q as it is: the kernel quantizes it (quantize_query's bits)
        q_arg = q.contiguous()
        if q_arg.data_ptr() % 16:          # q is read 8 or 16 bytes at a time
            q_arg = q_arg.clone()
        kss, vss = k_scale.stride(), v_scale.stride()
    else:
        q_arg = q.to(k_cache.dtype).contiguous()
        if q_arg.data_ptr() % 16:
            q_arg = q_arg.clone()
        kss = vss = (0, 0, 0)
    fill32 = fill.to(torch.int32).contiguous()
    qpos32 = q_pos.to(torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m = l = None
    if return_stats:
        m = torch.empty((B, H), dtype=torch.float32, device=q.device)
        l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    ks, vs = k_cache.stride(), v_cache.stride()
    lib = load_kernels()["decode_attn"]
    err = lib.decode_attn_launch(
        ptr(q_arg), int(q_arg.dtype == torch.float32), ptr(k_cache),
        ptr(v_cache),
        ptr(k_scale if int8 else None), ptr(v_scale if int8 else None),
        ptr(fill32), ptr(qpos32), ptr(out), ptr(m), ptr(l),
        B, H, H_kv, S, D, _DTYPE_CODE[k_cache.dtype], plan.ranks,
        ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], kss[0], kss[1], vss[0],
        vss[1], 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attn kernel launch failed: CUDA error "
                           f"{err}")
    decode_attention_batched.kernel_launches += 1
    return (out, m, l) if return_stats else out


def decode_attention_batched(q, k_cache, v_cache, fill, q_pos, k_scale=None,
                             v_scale=None, return_stats: bool = False,
                             plan: AttnPlan | None = None):
    """Single-position attention of every slot against its cache rows (see
    the module docstring).  CUDA tensors: the kernel under `plan` (None:
    `_attn_plan`'s); CPU tensors: the plain version."""
    if q.is_cuda:
        return _decode_attention_cuda(q, k_cache, v_cache, fill, q_pos,
                                      k_scale, v_scale, return_stats, plan)
    return decode_attention_batched_plain(q, k_cache, v_cache, fill, q_pos,
                                          k_scale, v_scale, return_stats)


decode_attention_batched.kernel_launches = 0


def decode_attention_plain(q, k_cache, v_cache, fill, q_pos, k_scale=None,
                           v_scale=None):
    """`decode_attention` in plain torch, one pass over all S keys: f32
    scores of q against the (dequantized) keys, masked to -1e9, softmax
    with the masked probabilities zeroed, f32 PV product."""
    B, H, D = q.shape
    H_kv, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(B, H_kv, H // H_kv, D)
    kf, vf = k_cache.float(), v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    s = torch.einsum("bgrd,bgsd->bgrs", qg, kf) * (1.0 / math.sqrt(D))
    limit = torch.minimum(fill.long(), q_pos.long() + 1)
    mask = (torch.arange(S, device=q.device)[None, :]
            < limit[:, None])[:, None, None, :]
    s = s.masked_fill(~mask, NEG)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    out = torch.einsum("bgrs,bgsd->bgrd", p, vf)
    return (out / p.sum(dim=-1, keepdim=True).clamp(min=1e-20)).reshape(B, H, D)


def _decode_attention_single_cuda(q, k_cache, v_cache, fill, q_pos, k_scale,
                                  v_scale, plan: AttnPlan | None = None):
    """Launch `decode_attn_single_launch` (ops/csrc/decode_attn_single.cu)
    on the current stream under `plan` (None: `_single_plan`'s for the
    card).  q goes in as it is (bf16 or f32: the kernel upcasts it); the
    cache may be a strided view (a layer of the stacked cache) and is never
    copied."""
    from ._build import load_kernels
    if plan is not None and not 1 <= plan.ranks <= ATTN_MAX_RANKS:
        raise ValueError(f"decode_attn_single kernel takes 1..{ATTN_MAX_RANKS}"
                         f" ranks, got {plan.ranks}")
    _check_inputs(q, k_cache, v_cache, fill, q_pos, k_scale, v_scale,
                  "decode_attn_single")
    B, H, D = q.shape
    _, H_kv, S, _ = k_cache.shape
    int8 = k_cache.dtype == torch.int8
    if plan is None:
        plan = _single_plan(B, H_kv, S, _sm_count(q.device))
    kss = k_scale.stride() if int8 else (0, 0, 0)
    vss = v_scale.stride() if int8 else (0, 0, 0)
    q_arg = q.contiguous()
    if q_arg.data_ptr() % 16:              # q is read 8 or 16 bytes at a time
        q_arg = q_arg.clone()
    fill32 = fill.to(torch.int32).contiguous()
    qpos32 = q_pos.to(torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    ks, vs = k_cache.stride(), v_cache.stride()
    lib = load_kernels()["decode_attn_single"]
    err = lib.decode_attn_single_launch(
        q_arg.data_ptr(), int(q_arg.dtype == torch.float32),
        k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None,
        fill32.data_ptr(), qpos32.data_ptr(), out.data_ptr(),
        B, H, H_kv, S, D, _DTYPE_CODE[k_cache.dtype], plan.ranks,
        ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], kss[0], kss[1], vss[0],
        vss[1], 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attn_single kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.kernel_launches += 1
    return out


def decode_attention(q, k_cache, v_cache, fill, q_pos, k_scale=None,
                     v_scale=None, plan: AttnPlan | None = None):
    """Single-query attention of each row against its cache rows, all in
    f32 (see the module docstring).  CUDA tensors: the kernel under `plan`
    (None: `_single_plan`'s); CPU tensors: the plain version."""
    if q.is_cuda:
        return _decode_attention_single_cuda(q, k_cache, v_cache, fill,
                                             q_pos, k_scale, v_scale, plan)
    return decode_attention_plain(q, k_cache, v_cache, fill, q_pos, k_scale,
                                  v_scale)


decode_attention.kernel_launches = 0


def dma_floor_plain(k_cache, v_cache):
    """K7 (`miotts_tpu/ops/decode_attn.py:_dma_floor`): s_tile = min(S,
    512) and n_s = S // s_tile whole tiles; out[b, h, r, d] = sum over t <
    n_s of k + v at row t * s_tile + r, r < 8, f32 [B, H_kv, 8, D], summed
    in t order."""
    B, H_kv, S, D = k_cache.shape
    s_tile = min(S, S_TILE)
    out = k_cache.new_zeros((B, H_kv, 8, D), dtype=torch.float32)
    for t in range(S // s_tile):
        r0 = t * s_tile
        out += (k_cache[:, :, r0: r0 + 8].float()
                + v_cache[:, :, r0: r0 + 8].float())
    return out


def _dma_floor_cuda(k_cache, v_cache, plan: AttnPlan | None = None):
    """Launch `attn_dma_floor_launch` (ops/csrc/dma_floor.cu) on the current
    stream under `plan` (None: `_single_plan`'s for the card, K5's split):
    contiguous k / v of one dtype on one GPU, 16-byte rows."""
    from ._build import load_kernels
    if plan is not None and not 1 <= plan.ranks <= ATTN_MAX_RANKS:
        raise ValueError(f"dma_floor kernel takes 1..{ATTN_MAX_RANKS} ranks, "
                         f"got {plan.ranks}")
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v cache must both be [B, H_kv, S, D], got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if k_cache.dtype not in _DTYPE_CODE or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"cache must be f32, bf16 or int8 (k and v alike), "
                        f"got {k_cache.dtype} / {v_cache.dtype}")
    B, H_kv, S, D = k_cache.shape
    el = k_cache.element_size()
    if D * el % 16 or 8 * D * el // 16 > 256 or min(S, S_TILE) < 8:
        raise ValueError(f"dma_floor kernel takes 16-byte rows of at most "
                         f"512 bytes and S >= 8, got D={D}, S={S}, "
                         f"{el}-byte elements")
    for t in (k_cache, v_cache):
        if not t.is_cuda or t.device != k_cache.device:
            raise ValueError("dma_floor kernel: k and v must be on one GPU")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("dma_floor kernel: k and v must be contiguous "
                             "and 16-byte aligned")
    if plan is None:
        plan = _single_plan(B, H_kv, S, _sm_count(k_cache.device))
    out = torch.empty((B, H_kv, 8, D), dtype=torch.float32,
                      device=k_cache.device)
    err = load_kernels()["dma_floor"].attn_dma_floor_launch(
        k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), B, H_kv, S,
        D, _DTYPE_CODE[k_cache.dtype], plan.ranks,
        torch.cuda.current_stream(k_cache.device).cuda_stream)
    if err:
        raise RuntimeError(f"attn_dma_floor kernel launch failed: CUDA "
                           f"error {err}")
    dma_floor.kernel_launches += 1
    return out


def dma_floor(k_cache, v_cache, plan: AttnPlan | None = None):
    """K7 on k / v [B, H_kv, S, D] -> f32 [B, H_kv, 8, D].  CUDA tensors:
    the kernel under `plan` (None: `_single_plan`'s); CPU tensors: the plain
    version."""
    if k_cache.is_cuda:
        return _dma_floor_cuda(k_cache, v_cache, plan)
    return dma_floor_plain(k_cache, v_cache)


dma_floor.kernel_launches = 0
