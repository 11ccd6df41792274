"""Dequantization of GGUF blocks in plain torch (llama.cpp's formulas),
frozen here so that the reference never calls the program's loader.

Each function takes a tensor's stored bytes (uint8, on any device) and
returns its float32 values, row-major in numpy order [rows, cols] with
the blocks running along cols.
"""

from __future__ import annotations

import torch

GGML_F32, GGML_Q8_0, GGML_Q4_K, GGML_Q6_K = 0, 8, 12, 14


def _f16(b: torch.Tensor) -> torch.Tensor:
    """[nb, 2] bytes of IEEE fp16 -> [nb] float32."""
    return b.contiguous().view(torch.float16).reshape(-1).float()


def q8_0(raw: torch.Tensor) -> torch.Tensor:
    """Blocks of 32: [fp16 d][32 x int8 q]; w = d * q."""
    b = raw.reshape(-1, 34)
    q = b[:, 2:].contiguous().view(torch.int8).float()
    return (q * _f16(b[:, :2])[:, None]).reshape(-1)


def q4_k(raw: torch.Tensor) -> torch.Tensor:
    """Super-blocks of 256: [fp16 d][fp16 dmin][12 bytes of 6-bit scales
    and mins][128 bytes of 4-bit q]; w = d * sc * q - dmin * m over each
    group of 32 (ggml's get_scale_min_k4 and dequantize_row_q4_K)."""
    b = raw.reshape(-1, 144).long()
    nb = b.shape[0]
    d, dmin = _f16(raw.reshape(-1, 144)[:, 0:2]), _f16(
        raw.reshape(-1, 144)[:, 2:4])
    s = b[:, 4:16]
    sc = torch.empty((nb, 8), dtype=torch.long, device=raw.device)
    mn = torch.empty_like(sc)
    sc[:, :4] = s[:, 0:4] & 63
    mn[:, :4] = s[:, 4:8] & 63
    sc[:, 4:] = (s[:, 8:12] & 15) | ((s[:, 0:4] >> 6) << 4)
    mn[:, 4:] = (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)
    qs = b[:, 16:144].reshape(nb, 4, 32)
    q = torch.stack([qs & 15, qs >> 4], dim=2).reshape(nb, 8, 32).float()
    w = (d[:, None, None] * sc[:, :, None].float() * q
         - dmin[:, None, None] * mn[:, :, None].float())
    return w.reshape(-1)


def q6_k(raw: torch.Tensor) -> torch.Tensor:
    """Super-blocks of 256: [128 bytes low 4 bits][64 bytes high 2 bits]
    [16 x int8 scales][fp16 d]; w = d * sc * (q - 32) over each group of
    16 (ggml's dequantize_row_q6_K)."""
    r = raw.reshape(-1, 210)
    nb = r.shape[0]
    b = r.long()
    d = _f16(r[:, 208:210])
    sc = r[:, 192:208].contiguous().view(torch.int8).float()
    q = torch.empty((nb, 2, 4, 32), dtype=torch.long, device=raw.device)
    for half in range(2):
        ql = b[:, half * 64:(half + 1) * 64]
        qh = b[:, 128 + half * 32:128 + (half + 1) * 32]
        q[:, half, 0] = (ql[:, :32] & 15) | ((qh & 3) << 4)
        q[:, half, 1] = (ql[:, 32:] & 15) | (((qh >> 2) & 3) << 4)
        q[:, half, 2] = (ql[:, :32] >> 4) | (((qh >> 4) & 3) << 4)
        q[:, half, 3] = (ql[:, 32:] >> 4) | (((qh >> 6) & 3) << 4)
    q = (q.reshape(nb, 16, 16) - 32).float()
    return (d[:, None, None] * sc[:, :, None] * q).reshape(-1)


def f32(raw: torch.Tensor) -> torch.Tensor:
    return raw.contiguous().view(torch.float32).reshape(-1)


_BY_TYPE = {GGML_F32: f32, GGML_Q8_0: q8_0, GGML_Q4_K: q4_k,
            GGML_Q6_K: q6_k}


def dequantize(raw: torch.Tensor, ggml_type: int, shape: tuple) -> torch.Tensor:
    """A tensor's stored bytes -> float32 values of `shape` (numpy order)."""
    if ggml_type not in _BY_TYPE:
        raise ValueError(f"no dequantization for ggml type {ggml_type}")
    return _BY_TYPE[ggml_type](raw).reshape(shape)
