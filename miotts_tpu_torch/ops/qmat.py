"""Quantized weight tensors + fused dequant matmul on PyTorch.

Counterpart of `miotts_tpu/ops/qmat.py`.  GGUF block formats are repacked
once at load into the same planar, transposed layout the JAX package uses:

  values  int8 [K, N]            (Q8_0, Q6_K; Q4_0 / Q4_K / Q5_K unpacked)
          or uint8 [K/2, N]      (4-bit formats, nibble-packed PER GROUP:
                                  byte row r of group b holds w[b*g + r] in
                                  its low nibble and w[b*g + g/2 + r] in its
                                  high nibble)
  scales  f32 [K/g, N], or bf16 under MIOTTS_SCALE_BF16
  mins    [K/g, N] in the scales' dtype, or None   (affine formats; Q4_0's
                                  centring folds in here when packed)

  dequant: w[k, n] = values[k, n] * scales[k // g, n] - mins[k // g, n]
  y = x[M, K] @ w[K, N]

No lane padding: the TPU's N -> 128 pad and M -> 8 pad have no counterpart
on the GPU, so `n_out` equals N for tensors built here (the field is kept so
padded trees from the JAX package slice the same way).

`qdot` is the single matmul entry point for every LLM linear.  It picks a
kernel as the JAX package's `qdot` does, by the weight's `QdotRoute`:

  K1  `qdot.cu`       the default dequant-matmul, any M
  K2  `qdot_split`    packed weights at any M (MIOTTS_PACK4_SPLIT=1)
  K3  `qdot_group`    M = 1, bf16 x (MIOTTS_QDOT_GEMV=groupdot)
  K4  `qdot_w8a8`     M = 1, int8-quantized x (MIOTTS_QDOT_GEMV=w8a8)
  K1v `qdot_bf16`     bf16 x at any M, bf16 weights and dot
                      (MIOTTS_QDOT_BF16=1 / after)
  --  `qdot_xla`      no kernel: dequantize, then one `torch.matmul`
                      (MIOTTS_FORCE_XLA_QDOT=1, the JAX package's XLA path;
                      it overrides every other switch)

A CUDA tensor goes through the hand-written kernel (`ops/csrc/qdot.cu`,
`ops/csrc/qdot_gemv.cu`, `ops/csrc/qdot_bf16.cu`; at M > 1 K1, K1v and K2
share the tile of `ops/csrc/qdot_tile.cuh`, planned by `_tile_plan`; at
M = 1 K1, K1v, K2, K3 and K4 share the split-K GEMV of
`ops/csrc/qdot_gemv.cuh`, planned by `_gemv_plan`) and raises
if it cannot build or launch; a CPU tensor goes through the kernel's plain
torch version (`*_plain`).  4-bit formats load nibble-packed unless
MIOTTS_NO_PACK4 is set (`qtensor_from_raw`); every kernel takes both
storages, and f32 or bf16 scales and mins (`scale_dtype`; the loader's
MIOTTS_SCALE_BF16): a bf16-scale tensor reaches the kernels' bf16-scale
instantiations, which upcast each scale exactly in registers.
`qdot_dma_floor` (K8, `ops/csrc/dma_floor.cu`) is a probe that streams K1's
value and scale rows in the GEMV's split (`_gemv_plan`), staged by
`cp.async`; no linear calls it.
"""

from __future__ import annotations

import contextlib
import functools
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..gguf.quants import to_group_quant
from ..gguf.reader import GGML_Q4_0, GGML_Q4_K
from .collective import Shard

GEMV_MODES = ("plain", "w8a8", "groupdot")
BF16_MODES = ("", "1", "after")
SCALE_DTYPES = (torch.float32, torch.bfloat16)


@dataclass(frozen=True)
class QdotRoute:
    """The kernel choice of `qdot`, the JAX package's switches
    (`miotts_tpu/ops/qmat.py`: `_gemv_mode`, `_use_pack4_split`,
    `_gemv_m8`, `_use_bf16_dot`), resolved once (`from_env`) and carried
    by each QTensor.

      gemv   the M = 1 kernel: "plain" (K1), "w8a8" (K4), "groupdot" (K3,
             bf16 x only)
      split  packed weights through K2 at every M
      m8     pad M = 1 to 8 rows first, which bypasses the M = 1 kernels
      bf16   K1v for bf16 x at any M: "1" (bf16 scale, bf16 dequant) or
             "after" (f32 dequant, one bf16 cast); "" keeps K1
      xla    no kernel at all: `qdot_xla` (the JAX package's
             `_use_pallas()` false), whatever the other fields say"""
    gemv: str = "plain"
    split: bool = False
    m8: bool = False
    bf16: str = ""
    xla: bool = False

    def __post_init__(self):
        if self.gemv not in GEMV_MODES:
            raise ValueError(f"gemv must be one of {GEMV_MODES}, got "
                             f"{self.gemv!r}")
        if self.bf16 not in BF16_MODES:
            raise ValueError(f"bf16 must be one of {BF16_MODES}, got "
                             f"{self.bf16!r}")

    @classmethod
    def from_env(cls, env=None) -> "QdotRoute":
        """MIOTTS_QDOT_GEMV (w8a8 / groupdot / plain), its alias
        MIOTTS_QDOT_GROUPDOT=1, MIOTTS_PACK4_SPLIT=1, MIOTTS_GEMV_M8=1,
        MIOTTS_QDOT_BF16 (1 / after; anything else is off) and
        MIOTTS_FORCE_XLA_QDOT (any non-empty value), read as the JAX package
        reads them."""
        env = os.environ if env is None else env
        gemv = env.get("MIOTTS_QDOT_GEMV", "")
        if gemv not in GEMV_MODES:
            gemv = ("groupdot" if env.get("MIOTTS_QDOT_GROUPDOT", "") == "1"
                    else "plain")
        bf16 = env.get("MIOTTS_QDOT_BF16", "")
        return cls(gemv=gemv, split=env.get("MIOTTS_PACK4_SPLIT", "") == "1",
                   m8=env.get("MIOTTS_GEMV_M8", "") == "1",
                   bf16=bf16 if bf16 in BF16_MODES else "",
                   xla=bool(env.get("MIOTTS_FORCE_XLA_QDOT")))


@dataclass
class QTensor:
    """Group-affine quantized matrix, logical shape [out=N, in=K], stored
    transposed ([K, N], contraction dim first)."""
    values: torch.Tensor          # int8 [K, N] or uint8 [K/2, N] (packed)
    scales: torch.Tensor          # f32 or bf16 [K/g, N]
    mins: torch.Tensor | None     # [K/g, N] in the scales' dtype, or None
    group: int
    n_out: int = -1               # logical output dim (un-padded N)
    packed: bool = False
    route: QdotRoute = QdotRoute()   # the kernel `qdot` takes for it

    @property
    def k(self) -> int:
        return self.values.shape[0] * (2 if self.packed else 1)

    @property
    def shape(self) -> tuple[int, int]:
        """Logical [N, K] (the GGUF Linear layout)."""
        n = self.n_out if self.n_out > 0 else self.values.shape[1]
        return (n, self.k)

    def to(self, device) -> "QTensor":
        return replace(
            self, values=self.values.to(device), scales=self.scales.to(device),
            mins=None if self.mins is None else self.mins.to(device))

    def with_scale_dtype(self, dtype) -> "QTensor":
        """The same tensor with scales and mins in `dtype` (f32 -> bf16
        rounds to nearest even, as numpy's ml_dtypes and JAX do; bf16 ->
        f32 is exact).  Values are shared, not copied."""
        if dtype not in SCALE_DTYPES:
            raise ValueError(f"scales are f32 or bf16, got {dtype}")
        return replace(self, scales=self.scales.to(dtype),
                       mins=None if self.mins is None
                       else self.mins.to(dtype))

    @classmethod
    def from_group_quant(cls, gq, scale_dtype=torch.float32) -> "QTensor":
        """Host GroupQuant ([rows=N, cols=K]) -> transposed CPU tensors,
        scales and mins in `scale_dtype` (f32 or bf16)."""
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a.T))
        return cls(values=t(gq.values),
                   scales=t(gq.scales.astype(np.float32)),
                   mins=None if gq.mins is None
                   else t(gq.mins.astype(np.float32)),
                   group=gq.group,
                   n_out=gq.values.shape[0]).with_scale_dtype(scale_dtype)

    def unpacked_values(self) -> torch.Tensor:
        """Integer values [K, N] (unpacks the per-group nibble split)."""
        if not self.packed:
            return self.values
        g = self.group
        kh, n = self.values.shape
        v = self.values.to(torch.int32).reshape(kh * 2 // g, g // 2, n)
        return torch.cat([v & 0xF, v >> 4], dim=1).reshape(kh * 2, n)

    def dequant_t(self, dtype=torch.float32) -> torch.Tensor:
        """Dequantized weight in storage orientation [K, N] (un-padded)."""
        vals = self.unpacked_values()
        k, n = vals.shape
        g = self.group
        w = vals.to(dtype).reshape(k // g, g, n) * self.scales.to(dtype)[:, None, :]
        if self.mins is not None:
            w = w - self.mins.to(dtype)[:, None, :]
        w = w.reshape(k, n)
        if 0 < self.n_out != n:
            w = w[:, : self.n_out]
        return w

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """Dequantized weight in logical [N, K] orientation."""
        return self.dequant_t(dtype).T

    def pack4(self) -> "QTensor":
        """Packed-nibble storage for 4-bit formats: values become uint8
        [K/2, N]; centred formats (Q4_0's q-8) fold the offset into `mins`
        so the nibbles are unsigned.  Halves the value bytes of the GEMV."""
        if self.packed:
            return self
        v = self.values.to(torch.int32)
        k, n = v.shape
        if k % 2:
            raise ValueError("pack4 needs an even K")
        mins = self.mins
        if int(v.min()) < 0:
            if int(v.min()) < -8 or int(v.max()) > 7:
                raise ValueError("not a 4-bit format")
            v = v + 8
            extra = self.scales * 8.0
            mins = extra if mins is None else mins + extra
        if int(v.min()) < 0 or int(v.max()) > 15:
            raise ValueError("not a 4-bit format")
        g = self.group
        v3 = v.reshape(k // g, g, n)
        packed = (v3[:, : g // 2] | (v3[:, g // 2:] << 4)).reshape(k // 2, n)
        return replace(self, values=packed.to(torch.uint8), mins=mins,
                       packed=True)


def qtensor_from_raw(raw: np.ndarray, ggml_type: int, rows: int, cols: int,
                     device="cpu", pack4: bool | None = None,
                     scale_dtype=torch.float32) -> QTensor:
    """Raw GGUF blocks -> QTensor through the numpy repack.  4-bit formats
    (Q4_K / Q4_0) default to packed-nibble storage, as in the JAX package,
    unless MIOTTS_NO_PACK4 is set (or pack4=False): then their values stay
    int8 [K, N] (Q4_K's 0..15 with its mins, Q4_0's centred -8..7).  The
    repack is lossless, so the dequantized weight is the same either way.
    Scales and mins are stored in `scale_dtype` (f32 or bf16), rounded once
    after the pack and Q4_0's x8 min fold, as the JAX package's native
    repack does (the fold is exact in either order)."""
    if pack4 is None:
        pack4 = (ggml_type in (GGML_Q4_K, GGML_Q4_0) and cols % 2 == 0
                 and not os.environ.get("MIOTTS_NO_PACK4"))
    qt = QTensor.from_group_quant(to_group_quant(raw, ggml_type, rows, cols))
    if pack4:
        qt = qt.pack4()
    return qt.with_scale_dtype(scale_dtype).to(device)


def concat_qtensors(tensors: list):
    """Concatenate weights along the OUTPUT dim (QKV / gate+up fusion).

    Dense [N, K] tensors concatenate as they are.  Heterogeneous QTensors are
    harmonised EXACTLY, as in the JAX package (real Q4_K_M files put Q6_K
    next to Q4_K): a packed tensor is unpacked unless every sibling is
    packed with the same group, a coarser group repeats its scales/mins down
    to the finest group present, and a tensor without mins gets zero mins
    when a sibling has them.  The dequantized values stay bit-identical."""
    if all(isinstance(t, torch.Tensor) for t in tensors):
        return torch.cat(tensors, dim=0)
    if not all(isinstance(t, QTensor) for t in tensors):
        raise ValueError("mixed dense/quantized fusion is not supported")
    if (any(t.packed for t in tensors)
            and not all(t.packed and t.group == tensors[0].group
                        for t in tensors)):
        tensors = [QTensor(values=t.unpacked_values().to(torch.int8),
                           scales=t.scales, mins=t.mins, group=t.group,
                           n_out=t.n_out) if t.packed else t
                   for t in tensors]
    g = min(t.group for t in tensors)
    if any(t.group % g for t in tensors):
        raise ValueError(f"incompatible quant groups "
                         f"{[t.group for t in tensors]}")
    has_mins = any(t.mins is not None for t in tensors)

    def unpad(a, t):
        return a[:, : t.shape[0]]

    def expand(a, t):
        f = t.group // g
        return torch.repeat_interleave(a, f, dim=0) if f > 1 else a

    def mins_of(t):
        if t.mins is not None:
            return expand(unpad(t.mins, t), t)
        return torch.zeros((t.k // g, t.shape[0]), dtype=t.scales.dtype,
                           device=t.scales.device)

    values = torch.cat([unpad(t.values, t) for t in tensors], dim=1)
    scales = torch.cat([expand(unpad(t.scales, t), t) for t in tensors], dim=1)
    mins = (torch.cat([mins_of(t) for t in tensors], dim=1)
            if has_mins else None)
    return QTensor(values=values.contiguous(), scales=scales.contiguous(),
                   mins=None if mins is None else mins.contiguous(), group=g,
                   n_out=values.shape[1], packed=tensors[0].packed)


def with_route(tree, route: QdotRoute):
    """A params tree (dicts / lists) whose QTensors take `route`; the
    tensors are shared, not copied."""
    if isinstance(tree, QTensor):
        return replace(tree, route=route)
    if isinstance(tree, Shard):
        return replace(tree, local=with_route(tree.local, route))
    if isinstance(tree, dict):
        return {k: with_route(v, route) for k, v in tree.items()}
    if isinstance(tree, list):
        return [with_route(v, route) for v in tree]
    return tree


# ---------------------------------------------------------------------------
# Plain versions: the JAX package's functions, step for step, in torch (the
# CPU path, and what the CUDA kernels are held against)
# ---------------------------------------------------------------------------

def _out_dtype(x: torch.Tensor, out_f32: bool) -> torch.dtype:
    """A product's output dtype: x's, or f32 where `out_f32` asks for the
    unrounded f32 sum (a row-parallel shard's partial, rounded only after
    the ranks' partials are summed).  Every kernel and plain version below
    takes `out_f32`."""
    return torch.float32 if out_f32 else x.dtype


def qdot_plain(x: torch.Tensor, qt: QTensor,
               out_f32: bool = False) -> torch.Tensor:
    """K1.  x [M, K] @ w [K, N] in plain torch: dequantize to f32, multiply
    in f32, cast to x.dtype — the arithmetic of the TPU kernel's default
    (f32-dequant) path and of the CUDA kernel."""
    return (x.float() @ qt.dequant_t(torch.float32)).to(_out_dtype(x, out_f32))


def _bf16_mode_checked(mode: str) -> None:
    if mode not in BF16_MODES[1:]:
        raise ValueError(f"qdot_bf16 mode must be '1' or 'after', got "
                         f"{mode!r}")


def qdot_xla(x: torch.Tensor, qt: QTensor,
             out_f32: bool = False) -> torch.Tensor:
    """The JAX package's `_qdot_xla` (MIOTTS_FORCE_XLA_QDOT): the weight
    dequantized in f32 for f32 x, else in bf16, then one `torch.matmul`
    with x in the same dtype (every bf16 product exact, summed in f32),
    the result in x.dtype (`out_f32`: the same bf16 values multiplied in
    f32, unrounded).  No hand-written kernel: on a GPU the product is
    cuBLAS's; counted in `qdot_xla.calls` on every device."""
    dt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    qdot_xla.calls += 1
    if out_f32:
        return torch.matmul(x.to(dt).float(), qt.dequant_t(dt).float())
    return torch.matmul(x.to(dt), qt.dequant_t(dt)).to(x.dtype)


def qdot_bf16_plain(x: torch.Tensor, qt: QTensor, mode: str,
                    out_f32: bool = False) -> torch.Tensor:
    """K1v (`_qdot_pallas(bf16_dot=True | "after")`): x rounded to bf16; the
    weight dequantized without mins and rounded to bf16 as the mode says
    ("1": bf16(v * bf16(s)), exact before its one rounding; "after":
    bf16(v * s) of the f32 product); the bf16 x bf16 product in f32 (every
    product exact); minus the mins term from the f32 group sums of the
    unrounded x; cast to x.dtype."""
    _bf16_mode_checked(mode)
    M, K = x.shape
    g = qt.group
    s = (qt.scales.float() if mode == "after"
         else qt.scales.to(torch.bfloat16).float())
    v = qt.unpacked_values().float().reshape(K // g, g, -1)
    w = (v * s[:, None, :]).reshape(K, -1).to(torch.bfloat16).float()
    out = x.to(torch.bfloat16).float() @ w
    xg = x.float().reshape(M, K // g, g).sum(dim=2)
    return (out - _mins_term(xg, qt)).to(_out_dtype(x, out_f32))


def _k8_tile_k(K: int, N: int) -> int:
    """`benchmarks/bench_qmat.py:dma_floor`'s K tile: TILE_N = 512 if N is
    its multiple, else 256; TILE_K = K halved while TILE_N * TILE_K > 512 KiB
    and TILE_K / 2 is a multiple of 256."""
    tile_n = 512 if N % 512 == 0 else 256
    tile_k = K
    while (tile_n * tile_k > 512 * 1024 and tile_k % 2 == 0
           and (tile_k // 2) % 256 == 0):
        tile_k //= 2
    return tile_k


def _k8_checked(qt: QTensor) -> int:
    """Raise on what K8 does not take (int8 values, f32 or bf16 scales,
    group 32, at least one 256-row K tile); returns its K tile."""
    K, N = qt.values.shape
    if qt.packed or qt.values.dtype != torch.int8 or qt.group != 32:
        raise ValueError("qdot_dma_floor streams int8 values with group 32 "
                         "(Q8_0's layout)")
    if qt.scales.dtype not in SCALE_DTYPES or tuple(qt.scales.shape) != (
            K // 32, N):
        raise ValueError(f"scales must be f32 or bf16 [{K // 32}, {N}]")
    tile_k = _k8_tile_k(K, N)
    if K % 32 or tile_k < 256:
        raise ValueError(f"qdot_dma_floor needs K tiles of >= 256 rows, "
                         f"got K={K}")
    return tile_k


def qdot_dma_floor_plain(qt: QTensor) -> torch.Tensor:
    """K8 (`benchmarks/bench_qmat.py:dma_floor`), the probe that streams
    K1's value and scale blocks: out[0, n] = sum over K tiles t of
    v[t * TILE_K, n] + s[t * TILE_K / 32, n], f32 [1, N].  (The JAX grid
    covers N / TILE_N whole column tiles; this covers every column.)"""
    tile_k = _k8_tile_k(*qt.values.shape)
    v = qt.values[::tile_k].float()
    s = qt.scales[:: tile_k // 32].float()
    return (v + s).sum(dim=0, keepdim=True)


def _gemv_only(x: torch.Tensor, name: str) -> None:
    if x.shape[0] != 1:
        raise ValueError(f"{name} is a GEMV kernel (M=1), got M={x.shape[0]}")


def _mins_term(xg: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """xg [M, K/g] (f32 group sums of x) @ mins upcast to f32, or 0
    without mins."""
    return 0.0 if qt.mins is None else xg @ qt.mins.float()


def qdot_split_plain(x: torch.Tensor, qt: QTensor,
                     out_f32: bool = False) -> torch.Tensor:
    """K2 (`_qdot_pallas_split`): x cast to f32 and split into each quant
    group's lo / hi halves, each nibble plane dequantized in place and
    contracted by its own half-K product; the mins term from the f32 group
    sums of x, subtracted after; the output cast to x.dtype."""
    if not qt.packed:
        raise ValueError("qdot_split requires a packed QTensor")
    M, K = x.shape
    g, N = qt.group, qt.values.shape[1]
    x3 = x.float().reshape(M, K // g, g)
    x_lo = x3[:, :, : g // 2].reshape(M, K // 2)
    x_hi = x3[:, :, g // 2:].reshape(M, K // 2)
    v3 = qt.values.to(torch.int32).reshape(K // g, g // 2, N)
    s = qt.scales.float()[:, None, :]
    w_lo = ((v3 & 0xF).float() * s).reshape(K // 2, N)
    w_hi = ((v3 >> 4).float() * s).reshape(K // 2, N)
    out = x_lo @ w_lo + x_hi @ w_hi
    return (out - _mins_term(x3.sum(dim=2), qt)).to(_out_dtype(x, out_f32))


def qdot_group_plain(x: torch.Tensor, qt: QTensor,
                     out_f32: bool = False) -> torch.Tensor:
    """K3 (`_qdot_group_pallas`), M = 1: per-group partial sums d[b, n] of
    bf16(x) times the integer values, in f32; then sum_b d[b, n] * s[b, n];
    the mins term from the exact f32 group sums of x; cast to x.dtype."""
    _gemv_only(x, "qdot_group")
    K = x.shape[1]
    g = qt.group
    xb = x.to(torch.bfloat16).float().reshape(K // g, 1, g)
    v = qt.unpacked_values().float().reshape(K // g, g, -1)
    d = torch.bmm(xb, v)[:, 0]                       # [K/g, N]
    out = (d * qt.scales.float()).sum(dim=0, keepdim=True)
    xg = x.float().reshape(1, K // g, g).sum(dim=2)
    return (out - _mins_term(xg, qt)).to(_out_dtype(x, out_f32))


def quantize_groups(x: torch.Tensor, group: int):
    """Per-group symmetric int8 quantization of a row x [1, K], as
    `_qdot_w8a8_pallas`: sx = amax / 127 (1 where amax is 0), xq =
    clip(round_half_even(x / sx), -127, 127).  Returns (xq [K/g, g] as f32
    integers, sx [K/g])."""
    xf = x.float().reshape(-1, group)
    amax = xf.abs().amax(dim=1)
    # 127 as a tensor on x's device: CUDA torch multiplies by the
    # reciprocal of a host scalar divisor, which is not IEEE division
    sx = torch.where(amax > 0, amax / amax.new_full((), 127.0),
                     torch.ones_like(amax))
    xq = torch.clamp(torch.round(xf / sx[:, None]), -127, 127)
    return xq, sx


def qdot_w8a8_plain(x: torch.Tensor, qt: QTensor,
                    out_f32: bool = False) -> torch.Tensor:
    """K4 (`_qdot_w8a8_pallas`, packed and unpacked), M = 1: x quantized per
    group to int8, integer per-group partials d[b, n] = sum xq * v (exact:
    |d| < 2^24, so the f32 product below is exact), the scale s * sx riding
    them; the mins term from the group sums of x^ = xq * sx (not of x);
    cast to x.dtype."""
    _gemv_only(x, "qdot_w8a8")
    g = qt.group
    xq, sx = quantize_groups(x, g)
    v = qt.unpacked_values().float().reshape(xq.shape[0], g, -1)
    d = torch.bmm(xq[:, None, :], v)[:, 0]          # [K/g, N] integers
    out = (d * (qt.scales.float() * sx[:, None])).sum(dim=0, keepdim=True)
    xg = (sx * xq.sum(dim=1))[None]
    return (out - _mins_term(xg, qt)).to(_out_dtype(x, out_f32))


# ---------------------------------------------------------------------------
# CUDA wrappers: check, allocate, launch on the current stream, count
# ---------------------------------------------------------------------------

def _checked(name: str, x: torch.Tensor, qt: QTensor,
             xtypes=(torch.bfloat16, torch.float32),
             packed: bool | None = None, gemv: bool = False) -> int:
    """Raise on what kernel `name` does not take; returns N.  Scales are
    f32 or bf16 and mins, where present, of the scales' dtype: each dtype
    has its own instantiation of the kernel, and nothing is converted
    here."""
    M, K = x.shape
    vals = qt.values
    N = vals.shape[1]
    if x.dtype not in xtypes:
        raise TypeError(f"{name} kernel takes {xtypes} x, got {x.dtype}")
    if gemv:
        _gemv_only(x, name)
    if packed is not None and qt.packed != packed:
        raise ValueError(f"{name} kernel requires a "
                         f"{'packed' if packed else 'unpacked'} QTensor")
    if qt.group not in (16, 32):
        raise ValueError(f"{name} kernel takes group 16 or 32, got {qt.group}")
    want_v = torch.uint8 if qt.packed else torch.int8
    if vals.dtype != want_v:
        raise TypeError(f"values must be {want_v}, got {vals.dtype}")
    if qt.k != K or K % qt.group:
        raise ValueError(f"K mismatch: x has {K}, weight {qt.k}, "
                         f"group {qt.group}")
    tensors = [x, vals, qt.scales] + ([] if qt.mins is None else [qt.mins])
    if qt.scales.dtype not in SCALE_DTYPES:
        raise TypeError(f"{name} kernel takes f32 or bf16 scales, got "
                        f"{qt.scales.dtype}")
    for t in tensors[2:]:
        if t.dtype != qt.scales.dtype or tuple(t.shape) != (K // qt.group, N):
            raise ValueError(f"scales/mins must be {qt.scales.dtype} "
                             f"[{K // qt.group}, {N}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} kernel: every tensor must be on x's GPU")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: tensors must be contiguous")
    return N


def _s_bf16(qt: QTensor) -> int:
    """The launchers' scale-type argument: 1 for bf16 scales and mins."""
    return int(qt.scales.dtype == torch.bfloat16)


def _raise_on(err: int, fn: str) -> None:
    if err:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")


def _launch(fn: str, x, qt: QTensor, y, *args) -> None:
    """fn(x, v, s, mins, s_bf16, y, *args, stream) of
    ops/csrc/qdot_gemv.cu."""
    from ._build import load_kernels
    _raise_on(getattr(load_kernels()["qdot_gemv"], fn)(
        x.data_ptr(), qt.values.data_ptr(), qt.scales.data_ptr(),
        _ptr(qt.mins), _s_bf16(qt), y.data_ptr(), *args,
        torch.cuda.current_stream(x.device).cuda_stream), fn)


# the M > 1 tile of K1 and K1v (ops/csrc/qdot_tile.cuh, whose BN and BK
# these are): TILE_BN output columns of a bm-row tile and TILE_BK of K per
# stage.  16-row tiles serve M <= 16, and any M when the weight has fewer
# than TILE_BM16_MAX_KN values (a small linear is bound by latency: four
# 16-row tiles in parallel beat one 64-row tile).  K is split over blocks
# until they reach TILE_BLOCKS_PER_SM[bm] per SM, keeping SPLIT_MIN_STEPS
# stages or more in a split.  scripts/torch_qdot_tile_sweep.py times the
# choices.
TILE_BN = 128
TILE_BK = 64
TILE_BM16_MAX_KN = 1 << 22
TILE_BLOCKS_PER_SM = {16: 2, 64: 1}
SPLIT_MIN_STEPS = 2
H100_SMS = 132


@dataclass(frozen=True)
class TilePlan:
    """How the M > 1 tile covers y [M, N] = x [M, K] @ w: `bm` rows by
    TILE_BN columns a block, `splits` blocks along K of `k_split` each (the
    last one ragged)."""
    bm: int
    splits: int
    k_split: int
    n_tiles: int
    m_tiles: int


@functools.lru_cache(maxsize=None)
def _tile_plan(M: int, K: int, N: int, group: int,
               sms: int = H100_SMS) -> TilePlan:
    """The M > 1 tile plan of x [M, K] against a [K, N] weight of quant group
    `group` on a card of `sms` SMs: 16-row tiles for M <= 16 or a weight of
    fewer than TILE_BM16_MAX_KN values, 64 above, and K split as
    `_plan_for` says."""
    return _plan_for(16 if M <= 16 or K * N < TILE_BM16_MAX_KN else 64,
                     M, K, N, group, sms)


def _plan_for(bm: int, M: int, K: int, N: int, group: int,
              sms: int = H100_SMS) -> TilePlan:
    """The plan of bm-row tiles: K split over blocks in whole TILE_BK stages
    (no stage crosses a split) toward TILE_BLOCKS_PER_SM[bm] blocks an SM,
    with at least SPLIT_MIN_STEPS stages in a split."""
    if M < 2 or K < 1 or N < 1 or group not in (16, 32) or K % group:
        raise ValueError(f"no tile plan for M={M} K={K} N={N} group={group}")
    n_tiles, m_tiles = -(-N // TILE_BN), -(-M // bm)
    steps = -(-K // TILE_BK)
    want = -(-TILE_BLOCKS_PER_SM[bm] * sms // (n_tiles * m_tiles))
    per = -(-steps // max(1, min(want, steps // SPLIT_MIN_STEPS)))
    return TilePlan(bm=bm, splits=-(-steps // per), k_split=per * TILE_BK,
                    n_tiles=n_tiles, m_tiles=m_tiles)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# per device: the tile kernels' split-K tickets, one int32 per output tile,
# zeroed once here and reset to 0 by the block that uses them last.  An
# array outgrown by a larger launch stays allocated (_OUTGROWN): a CUDA
# graph captured before (runtime/batching.py) still launches on it.
_TICKETS: dict = {}
_OUTGROWN: list = []


def _tickets(device, n: int) -> torch.Tensor:
    """The split-K tickets of `device`, at least `n`.  One array serves
    every launch on the device, so two tile launches must not run at once:
    the port launches on one stream a device."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        if t is not None:
            _OUTGROWN.append(t)
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _tile_args(name: str, x: torch.Tensor, qt: QTensor, N: int,
               plan: TilePlan | GemvPlan | None) -> tuple:
    """(workspace, tickets, bm, splits, k_split) of the launch under `plan`
    (None: the card's own): at M = 1 the GEMV's splits and k_split
    (`_gemv_plan`; no workspace, no tickets, bm unused), at M > 1 the
    tile's (`_tile_plan`)."""
    M, K = x.shape
    if M == 1:
        return (None, None, 0) + _gemv_args(x, qt, N, plan)
    if x.data_ptr() % 16 or qt.values.data_ptr() % 16:
        raise ValueError(f"{name} kernel: x and values must be 16-byte "
                         f"aligned at M > 1")
    if _s_bf16(qt) and (qt.scales.data_ptr() % 16
                        or (qt.mins is not None and qt.mins.data_ptr() % 16)):
        raise ValueError(f"{name} kernel: bf16 scales and mins must be "
                         f"16-byte aligned at M > 1")
    if plan is None:
        plan = _tile_plan(M, K, N, qt.group, _sm_count(x.device))
    if plan.splits == 1:
        return None, None, plan.bm, 1, plan.k_split
    tiles = plan.n_tiles * plan.m_tiles
    ws = torch.empty((plan.splits, tiles, plan.bm, TILE_BN),
                     dtype=torch.float32, device=x.device)
    tickets = _tickets(x.device, tiles)
    return ws, tickets, plan.bm, plan.splits, plan.k_split


def _ptr(t):
    return None if t is None else t.data_ptr()


# the M = 1 GEMV of K1, K1v, K2, K3 and K4 (ops/csrc/qdot_gemv.cuh, whose
# GEMV_COLS, GEMV_TEAM_UNALIGNED and GEMV_MAX_SPLITS these are): a block
# covers GEMV_COLS output columns (16 x GEMV_TEAM_UNALIGNED where rows are
# not 16-byte aligned, N % 16 != 0), and K is split over a thread-block
# cluster of at most GEMV_MAX_SPLITS blocks (the portable cluster size)
# toward GEMV_BLOCKS_PER_SM blocks an SM.
GEMV_COLS = 32
GEMV_TEAM_UNALIGNED = 8
GEMV_MAX_SPLITS = 8
GEMV_BLOCKS_PER_SM = 2


def _gemv_cols(N: int) -> int:
    """Output columns of a GEMV block on a weight of N columns."""
    return GEMV_COLS if N % 16 == 0 else 16 * GEMV_TEAM_UNALIGNED


@dataclass(frozen=True)
class GemvPlan:
    """How the M = 1 GEMV covers y [1, N]: a block of `_gemv_cols(N)`
    columns is a cluster of `splits` blocks along K of `k_split` each
    (whole quant groups; the last one ragged)."""
    splits: int
    k_split: int


@functools.lru_cache(maxsize=None)
def _gemv_plan(K: int, N: int, group: int, sms: int = H100_SMS) -> GemvPlan:
    """The GEMV plan of x [1, K] against a [K, N] weight of quant group
    `group` on a card of `sms` SMs: K split in whole quant groups until the
    blocks reach GEMV_BLOCKS_PER_SM an SM, at most GEMV_MAX_SPLITS splits
    and one quant group a split.  (At N = 768 the cluster's 8 splits give
    24 x 8 = 192 blocks, 1.45 an H100 SM.)"""
    if K < 1 or N < 1 or group not in (16, 32) or K % group:
        raise ValueError(f"no GEMV plan for K={K} N={N} group={group}")
    n_tiles = -(-N // _gemv_cols(N))
    groups = K // group
    want = -(-GEMV_BLOCKS_PER_SM * sms // n_tiles)
    per = -(-groups // max(1, min(want, GEMV_MAX_SPLITS, groups)))
    return GemvPlan(splits=-(-groups // per), k_split=per * group)


def _gemv_args(x: torch.Tensor, qt: QTensor, N: int,
               plan: GemvPlan | None) -> tuple[int, int]:
    """(splits, k_split) of an M = 1 GEMV launch under `plan` (None:
    `_gemv_plan`'s for the card)."""
    if plan is None:
        plan = _gemv_plan(x.shape[1], N, qt.group, _sm_count(x.device))
    return plan.splits, plan.k_split


def _qdot_cuda(x: torch.Tensor, qt: QTensor,
               plan: TilePlan | GemvPlan | None = None,
               out_f32: bool = False) -> torch.Tensor:
    """K1: `qdot_launch` (ops/csrc/qdot.cu): at M = 1 the GEMV under `plan`
    (None: `_gemv_plan`'s), at M > 1 the tile under `plan` (None:
    `_tile_plan`'s)."""
    from ._build import load_kernels
    N = _checked("qdot", x, qt)
    M, K = x.shape
    ws, tickets, bm, splits, k_split = _tile_args("qdot", x, qt, N, plan)
    y = torch.empty((M, N), dtype=_out_dtype(x, out_f32), device=x.device)
    _raise_on(load_kernels()["qdot"].qdot_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), qt.values.data_ptr(),
        int(qt.packed), qt.scales.data_ptr(), _ptr(qt.mins), _s_bf16(qt),
        y.data_ptr(), int(out_f32),
        _ptr(ws), _ptr(tickets), M, K, N, qt.group, bm, splits, k_split,
        torch.cuda.current_stream(x.device).cuda_stream), "qdot_launch")
    qdot.kernel_launches += 1
    return y


def _qdot_bf16_cuda(x: torch.Tensor, qt: QTensor, mode: str,
                    plan: TilePlan | GemvPlan | None = None,
                    out_f32: bool = False) -> torch.Tensor:
    """K1v: `qdot_bf16_launch` (ops/csrc/qdot_bf16.cu): at M = 1 the GEMV
    under `plan` (None: `_gemv_plan`'s), at M > 1 the tile under `plan`
    (None: `_tile_plan`'s)."""
    from ._build import load_kernels
    _bf16_mode_checked(mode)
    N = _checked("qdot_bf16", x, qt)
    M, K = x.shape
    ws, tickets, bm, splits, k_split = _tile_args("qdot_bf16", x, qt, N,
                                                  plan)
    y = torch.empty((M, N), dtype=_out_dtype(x, out_f32), device=x.device)
    _raise_on(load_kernels()["qdot_bf16"].qdot_bf16_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), qt.values.data_ptr(),
        int(qt.packed), qt.scales.data_ptr(), _ptr(qt.mins), _s_bf16(qt),
        y.data_ptr(), int(out_f32),
        _ptr(ws), _ptr(tickets), M, K, N, qt.group, bm, splits, k_split,
        int(mode == "after"), torch.cuda.current_stream(x.device).cuda_stream),
        "qdot_bf16_launch")
    qdot_bf16.kernel_launches += 1
    return y


def _qdot_dma_floor_cuda(qt: QTensor,
                         plan: GemvPlan | None = None) -> torch.Tensor:
    """K8: `qdot_dma_floor_launch` (ops/csrc/dma_floor.cu) under `plan`
    (None: `_gemv_plan`'s for the card, K1's M = 1 split)."""
    from ._build import load_kernels
    if plan is not None and not 1 <= plan.splits <= GEMV_MAX_SPLITS:
        raise ValueError(f"qdot_dma_floor kernel takes 1..{GEMV_MAX_SPLITS} "
                         f"splits, got {plan.splits}")
    tile_k = _k8_checked(qt)
    K, N = qt.values.shape
    for t in (qt.values, qt.scales):
        if not t.is_cuda or t.device != qt.values.device:
            raise ValueError("qdot_dma_floor kernel: values and scales must "
                             "be on one GPU")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("qdot_dma_floor kernel: tensors must be "
                             "contiguous and 16-byte aligned")
    dev = qt.values.device
    if plan is None:
        plan = _gemv_plan(K, N, qt.group, _sm_count(dev))
    out = torch.empty((1, N), dtype=torch.float32, device=dev)
    _raise_on(load_kernels()["dma_floor"].qdot_dma_floor_launch(
        qt.values.data_ptr(), qt.scales.data_ptr(), _s_bf16(qt),
        out.data_ptr(), K, N,
        tile_k, plan.splits, plan.k_split,
        torch.cuda.current_stream(dev).cuda_stream), "qdot_dma_floor_launch")
    qdot_dma_floor.kernel_launches += 1
    return out


def _qdot_split_cuda(x: torch.Tensor, qt: QTensor,
                     plan: TilePlan | GemvPlan | None = None,
                     out_f32: bool = False) -> torch.Tensor:
    """K2: `qdot_split_launch` (ops/csrc/qdot_gemv.cu): at M = 1 the GEMV
    under `plan` (None: `_gemv_plan`'s), at M > 1 K1's tile under `plan`
    (None: `_tile_plan`'s)."""
    N = _checked("qdot_split", x, qt, packed=True)
    M, K = x.shape
    ws, tickets, bm, splits, k_split = _tile_args("qdot_split", x, qt, N, plan)
    y = torch.empty((M, N), dtype=_out_dtype(x, out_f32), device=x.device)
    _launch("qdot_split_launch", x, qt, y, int(out_f32), _ptr(ws), _ptr(tickets),
            int(x.dtype == torch.bfloat16), M, K, N, qt.group, bm, splits,
            k_split)
    qdot_split.kernel_launches += 1
    return y


def _qdot_group_cuda(x: torch.Tensor, qt: QTensor,
                     plan: GemvPlan | None = None,
                     out_f32: bool = False) -> torch.Tensor:
    """K3: `qdot_group_launch` (ops/csrc/qdot_gemv.cu), bf16 x only, the
    GEMV under `plan` (None: `_gemv_plan`'s)."""
    N = _checked("qdot_group", x, qt, xtypes=(torch.bfloat16,), gemv=True)
    K = x.shape[1]
    splits, k_split = _gemv_args(x, qt, N, plan)
    y = torch.empty((1, N), dtype=_out_dtype(x, out_f32), device=x.device)
    _launch("qdot_group_launch", x, qt, y, int(out_f32), int(qt.packed), K, N,
            qt.group,
            splits, k_split)
    qdot_group.kernel_launches += 1
    return y


def _qdot_w8a8_cuda(x: torch.Tensor, qt: QTensor,
                    plan: GemvPlan | None = None,
                    out_f32: bool = False) -> torch.Tensor:
    """K4a (unpacked) / K4b (packed): `qdot_w8a8_launch` /
    `qdot_w8a8_packed_launch` (ops/csrc/qdot_gemv.cu), the GEMV's
    integer-partial form under `plan` (None: `_gemv_plan`'s)."""
    N = _checked("qdot_w8a8", x, qt, gemv=True)
    K = x.shape[1]
    splits, k_split = _gemv_args(x, qt, N, plan)
    y = torch.empty((1, N), dtype=_out_dtype(x, out_f32), device=x.device)
    fn = "qdot_w8a8_packed_launch" if qt.packed else "qdot_w8a8_launch"
    _launch(fn, x, qt, y, int(out_f32), int(x.dtype == torch.bfloat16), K, N,
            qt.group,
            splits, k_split)
    if qt.packed:
        qdot_w8a8.packed_launches += 1
    else:
        qdot_w8a8.kernel_launches += 1
    return y


# ---------------------------------------------------------------------------
# Entry points: the kernel for a CUDA tensor, its plain version for a CPU one
# ---------------------------------------------------------------------------

def qdot_split(x: torch.Tensor, qt: QTensor,
               out_f32: bool = False) -> torch.Tensor:
    """K2 on x [M, K] and a packed QTensor -> [M, N]."""
    return (_qdot_split_cuda(x, qt, out_f32=out_f32) if x.is_cuda
            else qdot_split_plain(x, qt, out_f32))


def qdot_group(x: torch.Tensor, qt: QTensor,
               out_f32: bool = False) -> torch.Tensor:
    """K3 on x [1, K] -> [1, N]."""
    return (_qdot_group_cuda(x, qt, out_f32=out_f32) if x.is_cuda
            else qdot_group_plain(x, qt, out_f32))


def qdot_w8a8(x: torch.Tensor, qt: QTensor,
              out_f32: bool = False) -> torch.Tensor:
    """K4 on x [1, K] -> [1, N] (K4a for int8 values, K4b for packed)."""
    return (_qdot_w8a8_cuda(x, qt, out_f32=out_f32) if x.is_cuda
            else qdot_w8a8_plain(x, qt, out_f32))


def qdot_bf16(x: torch.Tensor, qt: QTensor, mode: str,
              out_f32: bool = False) -> torch.Tensor:
    """K1v on x [M, K] -> [M, N], mode "1" or "after"."""
    return (_qdot_bf16_cuda(x, qt, mode, out_f32=out_f32) if x.is_cuda
            else qdot_bf16_plain(x, qt, mode, out_f32))


def qdot_dma_floor(qt: QTensor, plan: GemvPlan | None = None) -> torch.Tensor:
    """K8 on an int8 g32 QTensor -> f32 [1, N].  CUDA tensors: the kernel
    under `plan` (None: `_gemv_plan`'s); CPU tensors: the plain version."""
    return (_qdot_dma_floor_cuda(qt, plan) if qt.values.is_cuda
            else qdot_dma_floor_plain(qt))


def _qdot_routed(x: torch.Tensor, w: QTensor,
                 out_f32: bool = False) -> torch.Tensor:
    """x [M, K] through the kernel of w.route, in the JAX package's order
    (`miotts_tpu/ops/qmat.py:qdot`): the XLA path first (no kernel), then
    w8a8 at M = 1, then groupdot at M = 1 for bf16 x, then split for packed
    weights, then K1v for bf16 x, then K1.  (The TPU's M -> 8 and N -> 128
    padding and its tiling gate have no counterpart here.)  The route is
    x's dtype's whatever `out_f32` says (passed on only when set, so each
    entry's call is otherwise what it always was)."""
    route, m = w.route, x.shape[0]
    kw = {"out_f32": True} if out_f32 else {}
    if route.xla:
        return qdot_xla(x, w, **kw)
    if m == 1 and route.gemv == "w8a8":
        return qdot_w8a8(x, w, **kw)
    if m == 1 and route.gemv == "groupdot" and x.dtype == torch.bfloat16:
        return qdot_group(x, w, **kw)
    if w.packed and route.split:
        return qdot_split(x, w, **kw)
    if route.bf16 and x.dtype == torch.bfloat16:
        return qdot_bf16(x, w, route.bf16, **kw)
    return _qdot_cuda(x, w, **kw) if x.is_cuda else qdot_plain(x, w, **kw)


# the list `recording` yields while its block runs, else None
_RECORDED: list | None = None


@contextlib.contextmanager
def recording():
    """Within the block, each quantized product `qdot` makes appends its
    (FLOPs, bytes) to the list yielded: 2 M K N, and the weight's values,
    scales and mins as held, x and y, each once.  A CUDA graph's capture
    (runtime/batching.py) counts the work of its linears so, since a
    replay makes no call."""
    global _RECORDED
    outer, _RECORDED = _RECORDED, []
    try:
        yield _RECORDED
    finally:
        _RECORDED = outer


def _work(x: torch.Tensor, w: QTensor, y: torch.Tensor) -> tuple[int, int]:
    """(FLOPs, bytes) of y [M, N] = x [M, K] @ w^T."""
    (M, K), N = x.shape, y.shape[1]
    held = sum(t.nbytes for t in (w.values, w.scales, w.mins)
               if t is not None)
    return 2 * M * K * N, held + x.nbytes + y.nbytes


def qdot(x: torch.Tensor, w, out_f32: bool = False) -> torch.Tensor:
    """x [..., K] @ W^T -> [..., N] for W a dense [N, K] tensor (GGUF Linear
    layout) or a QTensor.  The single matmul entry point of the LLM.
    `out_f32`: the f32 sum, not rounded to x.dtype (a row-parallel shard's
    partial, `models/llm._linear`), through the same kernel."""
    if isinstance(w, QTensor):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        m = x2.shape[0]
        if m == 1 and w.route.m8:
            x2 = torch.cat([x2, x2.new_zeros((7, x2.shape[1]))])
        y = _qdot_routed(x2, w, out_f32)[:m]
        if _RECORDED is not None:
            _RECORDED.append(_work(x2[:m], w, y))
        n = w.shape[0]
        if n != y.shape[1]:
            y = y[:, :n]
        return y.reshape(*lead, n)
    if out_f32:
        # the JAX package's dot_general(preferred_element_type=f32): the
        # products of x and w in x's dtype, summed in f32
        return torch.matmul(x.float(), w.T.to(x.dtype).float())
    return torch.matmul(x, w.T.to(x.dtype))


# launches of each kernel (the wrapper adds one where it launches)
qdot.kernel_launches = 0                 # K1
qdot_split.kernel_launches = 0           # K2
qdot_group.kernel_launches = 0           # K3
qdot_w8a8.kernel_launches = 0            # K4a (int8 values)
qdot_w8a8.packed_launches = 0            # K4b (packed nibbles)
qdot_bf16.kernel_launches = 0            # K1v
qdot_dma_floor.kernel_launches = 0       # K8 (the probe)
qdot_xla.calls = 0                       # no kernel: dequant + torch.matmul
