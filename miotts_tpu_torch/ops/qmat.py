"""Quantized weight tensors + fused dequant matmul on PyTorch.

Counterpart of `miotts_tpu/ops/qmat.py`.  GGUF block formats are repacked
once at load into the same planar, transposed layout the JAX package uses:

  values  int8 [K, N]            (Q8_0, Q6_K; Q4_0 / Q4_K / Q5_K unpacked)
          or uint8 [K/2, N]      (4-bit formats, nibble-packed PER GROUP:
                                  byte row r of group b holds w[b*g + r] in
                                  its low nibble and w[b*g + g/2 + r] in its
                                  high nibble)
  scales  f32 [K/g, N]
  mins    f32 [K/g, N] or None   (affine formats; Q4_0's centring folds in
                                  here when packed)

  dequant: w[k, n] = values[k, n] * scales[k // g, n] - mins[k // g, n]
  y = x[M, K] @ w[K, N]

No lane padding: the TPU's N -> 128 pad and M -> 8 pad have no counterpart
on the GPU, so `n_out` equals N for tensors built here (the field is kept so
padded trees from the JAX package slice the same way).

`qdot` is the single matmul entry point for every LLM linear.  A CUDA
tensor goes through the hand-written kernel `ops/csrc/qdot.cu` (and raises
if it cannot build or launch); a CPU tensor goes through `qdot_plain`, the
same function in plain torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.quants import to_group_quant
from ..gguf.reader import GGML_Q4_0, GGML_Q4_K


@dataclass
class QTensor:
    """Group-affine quantized matrix, logical shape [out=N, in=K], stored
    transposed ([K, N], contraction dim first)."""
    values: torch.Tensor          # int8 [K, N] or uint8 [K/2, N] (packed)
    scales: torch.Tensor          # f32 [K/g, N]
    mins: torch.Tensor | None     # f32 [K/g, N] or None
    group: int
    n_out: int = -1               # logical output dim (un-padded N)
    packed: bool = False

    @property
    def k(self) -> int:
        return self.values.shape[0] * (2 if self.packed else 1)

    @property
    def shape(self) -> tuple[int, int]:
        """Logical [N, K] (the GGUF Linear layout)."""
        n = self.n_out if self.n_out > 0 else self.values.shape[1]
        return (n, self.k)

    def to(self, device) -> "QTensor":
        return QTensor(
            values=self.values.to(device), scales=self.scales.to(device),
            mins=None if self.mins is None else self.mins.to(device),
            group=self.group, n_out=self.n_out, packed=self.packed)

    @classmethod
    def from_group_quant(cls, gq) -> "QTensor":
        """Host GroupQuant ([rows=N, cols=K]) -> transposed CPU tensors."""
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a.T))
        return cls(values=t(gq.values),
                   scales=t(gq.scales.astype(np.float32)),
                   mins=None if gq.mins is None
                   else t(gq.mins.astype(np.float32)),
                   group=gq.group, n_out=gq.values.shape[0])

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
        return QTensor(values=packed.to(torch.uint8), scales=self.scales,
                       mins=mins, group=g, n_out=self.n_out, packed=True)


def qtensor_from_raw(raw: np.ndarray, ggml_type: int, rows: int, cols: int,
                     device="cpu", pack4: bool | None = None) -> QTensor:
    """Raw GGUF blocks -> QTensor through the numpy repack.  4-bit formats
    (Q4_K / Q4_0) default to packed-nibble storage, as in the JAX package;
    the repack is lossless, so the dequantized weight is unchanged."""
    if pack4 is None:
        pack4 = ggml_type in (GGML_Q4_K, GGML_Q4_0) and cols % 2 == 0
    qt = QTensor.from_group_quant(to_group_quant(raw, ggml_type, rows, cols))
    if pack4:
        qt = qt.pack4()
    return qt.to(device)


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


def qdot_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x [M, K] @ w [K, N] in plain torch: dequantize to f32, multiply in
    f32, cast to x.dtype — the arithmetic of the TPU kernel's default
    (f32-dequant) path and of the CUDA kernel."""
    return (x.float() @ qt.dequant_t(torch.float32)).to(x.dtype)


def _qdot_cuda(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Launch `qdot_launch` (ops/csrc/qdot.cu) on the current stream."""
    from ._build import load_kernels
    M, K = x.shape
    vals = qt.values
    N = vals.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qdot kernel takes bf16/f32 x, got {x.dtype}")
    if qt.group not in (16, 32):
        raise ValueError(f"qdot kernel takes group 16 or 32, got {qt.group}")
    want_v = torch.uint8 if qt.packed else torch.int8
    if vals.dtype != want_v:
        raise TypeError(f"values must be {want_v}, got {vals.dtype}")
    if qt.k != K or K % qt.group:
        raise ValueError(f"K mismatch: x has {K}, weight {qt.k}, "
                         f"group {qt.group}")
    tensors = [x, vals, qt.scales] + ([] if qt.mins is None else [qt.mins])
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("qdot kernel: every tensor must be on x's GPU")
        if not t.is_contiguous():
            raise ValueError("qdot kernel: tensors must be contiguous")
    for t in tensors[2:]:
        if t.dtype != torch.float32 or tuple(t.shape) != (K // qt.group, N):
            raise ValueError(f"scales/mins must be f32 [{K // qt.group}, "
                             f"{N}], got {t.dtype} {tuple(t.shape)}")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = load_kernels()["qdot"]
    err = lib.qdot_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), vals.data_ptr(),
        int(qt.packed), qt.scales.data_ptr(),
        None if qt.mins is None else qt.mins.data_ptr(), y.data_ptr(),
        M, K, N, qt.group, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"qdot kernel launch failed: CUDA error {err}")
    qdot.kernel_launches += 1
    return y


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ W^T -> [..., N] for W a dense [N, K] tensor (GGUF Linear
    layout) or a QTensor.  The single matmul entry point of the LLM."""
    if isinstance(w, QTensor):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if x2.is_cuda:
            y = _qdot_cuda(x2, w)
        else:
            y = qdot_plain(x2, w)
        n = w.shape[0]
        if n != y.shape[1]:
            y = y[:, :n]
        return y.reshape(*lead, n)
    return torch.matmul(x, w.T.to(x.dtype))


qdot.kernel_launches = 0
