"""GGUF quantization block formats — numpy reference codecs + device repacking.

Bit-exact (de)quantizers for the formats the reference models ship in
(`upstream README.md:196`: BF16, Q8_0, Q6_K, Q4_K_M).  The dequant
layouts follow ggml's block definitions; they must match bit-for-bit so a
model quantized by llama.cpp decodes to identical weights here.

Device side, every supported weight format is repacked once at load time into
a single *group-affine* layout ("GroupQuant"):

    w[k, n] = q[k, n] * scale[k // g, n] - min[k // g, n]

with q int8, scale/min float32 (min absent for symmetric formats).  The
fused dequant-matmul kernel (ops/qmat.py, ops/csrc/qdot.cu) consumes this
layout directly, so quantized weights stay quantized in device memory.

Mapping:
  Q8_0 -> g=32, symmetric           (q in [-127,127],  scale = d)
  Q4_K -> g=32, affine              (q in [0,15], scale = d*sc6, min = dmin*m6)
  Q6_K -> g=16, symmetric           (q-32 in [-32,31], scale = d*sc8)
  Q4_0 -> g=32, symmetric           (q-8 in [-8,7],    scale = d)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .reader import (
    GGML_BF16, GGML_F16, GGML_F32, GGML_Q4_0, GGML_Q4_K, GGML_Q5_K,
    GGML_Q6_K, GGML_Q8_0, GGML_BLOCK_LAYOUT,
)

QK = 32      # simple-format block size
QK_K = 256   # K-quant super-block size


# ---------------------------------------------------------------------------
# float16 helpers (GGUF stores block scales as IEEE f16)
# ---------------------------------------------------------------------------

def _f16_to_f32(u16: np.ndarray) -> np.ndarray:
    return u16.view(np.float16).astype(np.float32)


def _f32_to_f16_bits(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).view(np.uint16)


# ---------------------------------------------------------------------------
# Dequantization (raw GGUF bytes -> float32)
# ---------------------------------------------------------------------------

def dequant_f32(raw: np.ndarray, n: int) -> np.ndarray:
    return raw.view(np.float32)[:n].astype(np.float32)


def dequant_f16(raw: np.ndarray, n: int) -> np.ndarray:
    return raw.view(np.float16)[:n].astype(np.float32)


def dequant_bf16(raw: np.ndarray, n: int) -> np.ndarray:
    u16 = raw.view(np.uint16)[:n].astype(np.uint32) << 16
    return u16.view(np.float32)


def dequant_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    """Q8_0: blocks of 32 = [f16 d][32 x i8]."""
    nb = n // QK
    blocks = raw[: nb * 34].reshape(nb, 34)
    d = _f16_to_f32(blocks[:, :2].copy().view(np.uint16).reshape(nb))
    q = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (q * d[:, None]).reshape(-1)


def dequant_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    """Q4_0: blocks of 32 = [f16 d][16 bytes nibbles]; w = d*(q-8).

    Nibble order: low nibbles are elements 0..15, high nibbles 16..31.
    """
    nb = n // QK
    blocks = raw[: nb * 18].reshape(nb, 18)
    d = _f16_to_f32(blocks[:, :2].copy().view(np.uint16).reshape(nb))
    qs = blocks[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d[:, None]).reshape(-1)


def _unpack_q4k_scales(sc12: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack Q4_K's 12-byte field into 8 six-bit scales + 8 six-bit mins.

    ggml get_scale_min_k4: for j<4: sc=q[j]&63, m=q[j+4]&63;
    for j>=4: sc=(q[j+4]&0xF)|((q[j-4]>>6)<<4), m=(q[j+4]>>4)|((q[j]>>6)<<4).
    sc12: [nb, 12] uint8 -> (scales [nb,8], mins [nb,8]) uint8.
    """
    q = sc12.astype(np.uint8)
    sc = np.empty(q.shape[:-1] + (8,), dtype=np.uint8)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = q[..., j] & 63
        mn[..., j] = q[..., j + 4] & 63
    for j in range(4, 8):
        sc[..., j] = (q[..., j + 4] & 0x0F) | ((q[..., j - 4] >> 6) << 4)
        mn[..., j] = (q[..., j + 4] >> 4) | ((q[..., j] >> 6) << 4)
    return sc, mn


def _q4k_fields(raw: np.ndarray, n: int):
    """Split raw Q4_K blocks into (d, dmin, scales6, mins6, q4) arrays.

    Returns per-super-block d/dmin [nb], per-32-group 6-bit scales/mins [nb,8],
    and unpacked 4-bit quants [nb, 256] (uint8 0..15, element order).
    """
    nb = n // QK_K
    blocks = raw[: nb * 144].reshape(nb, 144)
    d = _f16_to_f32(blocks[:, 0:2].copy().view(np.uint16).reshape(nb))
    dmin = _f16_to_f32(blocks[:, 2:4].copy().view(np.uint16).reshape(nb))
    sc6, mn6 = _unpack_q4k_scales(blocks[:, 4:16])
    qs = blocks[:, 16:144]  # [nb, 128]
    # Element order per ggml dequant: chunks of 64; low nibbles of 32 bytes
    # are elements 0..31, high nibbles elements 32..63 of the chunk.
    q = np.empty((nb, QK_K), dtype=np.uint8)
    for c in range(4):
        chunk = qs[:, c * 32:(c + 1) * 32]
        q[:, c * 64:c * 64 + 32] = chunk & 0x0F
        q[:, c * 64 + 32:c * 64 + 64] = chunk >> 4
    return d, dmin, sc6, mn6, q


def dequant_q4_k(raw: np.ndarray, n: int) -> np.ndarray:
    """Q4_K: 256-elem super-blocks; w = d*sc6*q - dmin*m6 per 32-group."""
    d, dmin, sc6, mn6, q = _q4k_fields(raw, n)
    scale32 = d[:, None] * sc6.astype(np.float32)        # [nb, 8]
    min32 = dmin[:, None] * mn6.astype(np.float32)       # [nb, 8]
    qf = q.reshape(-1, 8, 32).astype(np.float32)
    w = qf * scale32[:, :, None] - min32[:, :, None]
    return w.reshape(-1)


def _q5k_fields(raw: np.ndarray, n: int):
    """Split raw Q5_K blocks (176 bytes / 256 elems: d, dmin, 12B scales,
    32B qh, 128B qs) into (d, dmin, sc6, mn6, q) with q uint8 in 0..31.

    Element order per ggml dequant: chunks of 64; low nibbles are elements
    0..31 (high bit qh & 1<<(2c)), high nibbles elements 32..63 (high bit
    qh & 1<<(2c+1))."""
    nb = n // QK_K
    blocks = raw[: nb * 176].reshape(nb, 176)
    d = _f16_to_f32(blocks[:, 0:2].copy().view(np.uint16).reshape(nb))
    dmin = _f16_to_f32(blocks[:, 2:4].copy().view(np.uint16).reshape(nb))
    sc6, mn6 = _unpack_q4k_scales(blocks[:, 4:16])
    qh = blocks[:, 16:48]    # [nb, 32]
    qs = blocks[:, 48:176]   # [nb, 128]
    q = np.empty((nb, QK_K), dtype=np.uint8)
    for c in range(4):
        chunk = qs[:, c * 32:(c + 1) * 32]
        hi_lo = ((qh >> (2 * c)) & 1).astype(np.uint8)
        hi_hi = ((qh >> (2 * c + 1)) & 1).astype(np.uint8)
        q[:, c * 64:c * 64 + 32] = (chunk & 0x0F) | (hi_lo << 4)
        q[:, c * 64 + 32:c * 64 + 64] = (chunk >> 4) | (hi_hi << 4)
    return d, dmin, sc6, mn6, q


def dequant_q5_k(raw: np.ndarray, n: int) -> np.ndarray:
    """Q5_K: 256-elem super-blocks; w = d*sc6*q - dmin*m6, q in 0..31."""
    d, dmin, sc6, mn6, q = _q5k_fields(raw, n)
    scale32 = d[:, None] * sc6.astype(np.float32)
    min32 = dmin[:, None] * mn6.astype(np.float32)
    qf = q.reshape(-1, 8, 32).astype(np.float32)
    return (qf * scale32[:, :, None] - min32[:, :, None]).reshape(-1)


def _q6k_fields(raw: np.ndarray, n: int):
    """Split raw Q6_K blocks into (d [nb], sc8 [nb,16], q [nb,256] int8).

    q is the centered quant (q6 - 32) in element order; sc8 the per-16 int8
    scales.
    """
    nb = n // QK_K
    blocks = raw[: nb * 210].reshape(nb, 210)
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8)
    d = _f16_to_f32(blocks[:, 208:210].copy().view(np.uint16).reshape(nb))
    q = np.empty((nb, QK_K), dtype=np.int8)
    for half in range(2):
        lo = ql[:, half * 64:(half + 1) * 64]
        hi = qh[:, half * 32:(half + 1) * 32]
        base = half * 128
        l = np.arange(32)
        q[:, base + l] = (((lo[:, l] & 0x0F) | (((hi[:, l] >> 0) & 3) << 4)).astype(np.int8) - 32)
        q[:, base + 32 + l] = (((lo[:, l + 32] & 0x0F) | (((hi[:, l] >> 2) & 3) << 4)).astype(np.int8) - 32)
        q[:, base + 64 + l] = (((lo[:, l] >> 4) | (((hi[:, l] >> 4) & 3) << 4)).astype(np.int8) - 32)
        q[:, base + 96 + l] = (((lo[:, l + 32] >> 4) | (((hi[:, l] >> 6) & 3) << 4)).astype(np.int8) - 32)
    return d, sc, q


def dequant_q6_k(raw: np.ndarray, n: int) -> np.ndarray:
    """Q6_K: 256-elem super-blocks; w = d * sc8[g16] * (q6 - 32)."""
    d, sc, q = _q6k_fields(raw, n)
    scale16 = d[:, None] * sc.astype(np.float32)         # [nb, 16]
    qf = q.reshape(-1, 16, 16).astype(np.float32)
    return (qf * scale16[:, :, None]).reshape(-1)


_DEQUANT = {
    GGML_F32: dequant_f32,
    GGML_F16: dequant_f16,
    GGML_BF16: dequant_bf16,
    GGML_Q8_0: dequant_q8_0,
    GGML_Q4_0: dequant_q4_0,
    GGML_Q4_K: dequant_q4_k,
    GGML_Q5_K: dequant_q5_k,
    GGML_Q6_K: dequant_q6_k,
}


def dequantize(raw: np.ndarray, ggml_type: int, n_elements: int) -> np.ndarray:
    if ggml_type not in _DEQUANT:
        from .reader import ggml_type_name
        raise ValueError(f"no dequantizer for {ggml_type_name(ggml_type)}")
    return _DEQUANT[ggml_type](np.ascontiguousarray(raw), n_elements)


# ---------------------------------------------------------------------------
# Quantization (float32 -> raw GGUF bytes) — used by the fixture/model writer
# and the quantize tool.  Formats are bit-compatible with ggml's layouts;
# rounding choices follow ggml where cheap (Q8_0) and use straightforward
# optimal-affine grouping for the K-quants (the *container* must match, the
# quantizer heuristic need not).
# ---------------------------------------------------------------------------

def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, QK).astype(np.float32)
    amax = np.abs(x).max(axis=1)
    d = amax / 127.0
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round(x * inv[:, None]), -127, 127).astype(np.int8)
    nb = x.shape[0]
    out = np.empty((nb, 34), dtype=np.uint8)
    out[:, :2] = _f32_to_f16_bits(d).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, QK).astype(np.float32)
    # ggml picks d from the max-|x| element, keeping its sign.
    idx = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), idx]
    d = maxv / -8.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round(x * inv[:, None]) + 8, 0, 15).astype(np.uint8)
    nb = x.shape[0]
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, :2] = _f32_to_f16_bits(d).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def _pack_q4k_scales(sc6: np.ndarray, mn6: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_q4k_scales. sc6/mn6: [nb, 8] uint8 (6-bit)."""
    nb = sc6.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(4):
        out[:, j] = (sc6[:, j] & 63) | ((sc6[:, j + 4] >> 4) << 6)
        out[:, j + 4] = (mn6[:, j] & 63) | ((mn6[:, j + 4] >> 4) << 6)
        out[:, j + 8] = (sc6[:, j + 4] & 0x0F) | ((mn6[:, j + 4] & 0x0F) << 4)
    return out


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    """Q4_K ("Q4_K_M" container): per-32-group affine with 6-bit super-scales."""
    x = x.reshape(-1, 8, 32).astype(np.float32)  # [nb, group, 32]
    nb = x.shape[0]
    gmax = x.max(axis=2)
    gmin = x.min(axis=2)
    # Per-group affine: w ≈ scale*q - min with q in 0..15.
    mins = np.maximum(-gmin, 0.0)                 # min term is subtracted
    scales = (gmax + mins) / 15.0
    scales = np.maximum(scales, 0.0)
    d = scales.max(axis=1) / 63.0                 # super-scale
    dmin = mins.max(axis=1) / 63.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1, dmin), 0.0)
    sc6 = np.clip(np.round(scales * inv_d[:, None]), 0, 63).astype(np.uint8)
    mn6 = np.clip(np.round(mins * inv_m[:, None]), 0, 63).astype(np.uint8)
    d16 = _f32_to_f16_bits(d)
    dmin16 = _f32_to_f16_bits(dmin)
    # Re-derive the actual (f16-rounded) per-group scale/min for quantizing.
    d_eff = d16.view(np.float16).astype(np.float32)[:, None] * sc6
    m_eff = dmin16.view(np.float16).astype(np.float32)[:, None] * mn6
    safe = np.where(d_eff > 0, d_eff, 1.0)
    q = np.clip(np.round((x + m_eff[:, :, None]) / safe[:, :, None]), 0, 15)
    q = np.where(d_eff[:, :, None] > 0, q, 0).astype(np.uint8).reshape(nb, QK_K)
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = dmin16.view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = _pack_q4k_scales(sc6, mn6)
    qs = np.empty((nb, 128), dtype=np.uint8)
    for c in range(4):
        lo = q[:, c * 64:c * 64 + 32]
        hi = q[:, c * 64 + 32:c * 64 + 64]
        qs[:, c * 32:(c + 1) * 32] = lo | (hi << 4)
    out[:, 16:144] = qs
    return out.reshape(-1)


def quantize_q5_k(x: np.ndarray) -> np.ndarray:
    """Q5_K: per-32-group affine with 5-bit quants + 6-bit super-scales."""
    x = x.reshape(-1, 8, 32).astype(np.float32)
    nb = x.shape[0]
    gmax = x.max(axis=2)
    gmin = x.min(axis=2)
    mins = np.maximum(-gmin, 0.0)
    scales = np.maximum((gmax + mins) / 31.0, 0.0)
    d = scales.max(axis=1) / 63.0
    dmin = mins.max(axis=1) / 63.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1, dmin), 0.0)
    sc6 = np.clip(np.round(scales * inv_d[:, None]), 0, 63).astype(np.uint8)
    mn6 = np.clip(np.round(mins * inv_m[:, None]), 0, 63).astype(np.uint8)
    d16 = _f32_to_f16_bits(d)
    dmin16 = _f32_to_f16_bits(dmin)
    d_eff = d16.view(np.float16).astype(np.float32)[:, None] * sc6
    m_eff = dmin16.view(np.float16).astype(np.float32)[:, None] * mn6
    safe = np.where(d_eff > 0, d_eff, 1.0)
    q = np.clip(np.round((x + m_eff[:, :, None]) / safe[:, :, None]), 0, 31)
    q = np.where(d_eff[:, :, None] > 0, q, 0).astype(np.uint8).reshape(nb, QK_K)
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = dmin16.view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = _pack_q4k_scales(sc6, mn6)
    qh = np.zeros((nb, 32), dtype=np.uint8)
    qs = np.empty((nb, 128), dtype=np.uint8)
    for c in range(4):
        lo = q[:, c * 64:c * 64 + 32]
        hi = q[:, c * 64 + 32:c * 64 + 64]
        qs[:, c * 32:(c + 1) * 32] = (lo & 0x0F) | ((hi & 0x0F) << 4)
        qh |= ((lo >> 4) & 1) << (2 * c)
        qh |= ((hi >> 4) & 1) << (2 * c + 1)
    out[:, 16:48] = qh
    out[:, 48:176] = qs
    return out.reshape(-1)


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    """Q6_K: per-16-group symmetric 6-bit with int8 group scales."""
    x = x.reshape(-1, 16, 16).astype(np.float32)  # [nb, group, 16]
    nb = x.shape[0]
    amax = np.abs(x).max(axis=2)
    gscale = amax / 31.0                          # q-32 in [-32, 31] -> use 31
    d = gscale.max(axis=1) / 127.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    sc8 = np.clip(np.round(gscale * inv_d[:, None]), -128, 127).astype(np.int8)
    d16 = _f32_to_f16_bits(d)
    d_eff = d16.view(np.float16).astype(np.float32)[:, None] * sc8
    safe = np.where(d_eff != 0, d_eff, 1.0)
    q = np.clip(np.round(x / safe[:, :, None]), -32, 31)
    q = np.where(d_eff[:, :, None] != 0, q, 0).astype(np.int8).reshape(nb, QK_K)
    qu = (q + 32).astype(np.uint8)
    out = np.empty((nb, 210), dtype=np.uint8)
    l = np.arange(32)
    for half in range(2):
        base = half * 128
        a = qu[:, base + l]
        b = qu[:, base + 32 + l]
        c = qu[:, base + 64 + l]
        e = qu[:, base + 96 + l]
        out[:, half * 64 + l] = (a & 0x0F) | ((c & 0x0F) << 4)
        out[:, half * 64 + 32 + l] = (b & 0x0F) | ((e & 0x0F) << 4)
        out[:, 128 + half * 32 + l] = (a >> 4) | ((b >> 4) << 2) | ((c >> 4) << 4) | ((e >> 4) << 6)
    out[:, 192:208] = sc8.view(np.uint8)
    out[:, 208:210] = d16.view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def quantize_f16(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).tobytes()


def quantize_bf16(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 with round-to-nearest-even and NaN preservation
    (ggml fp32_to_bf16 semantics: a NaN must stay a NaN, not round into
    Inf; rounding adds 0x7FFF + lsb-of-result in 32-bit so it cannot
    wrap)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.isnan(x.astype(np.float32))
    if nan.any():
        # quiet the NaN: keep sign + exponent, force a mantissa bit
        rounded = np.where(nan, ((u >> 16) | 0x0040).astype(np.uint16),
                           rounded)
    return rounded.tobytes()


_QUANTIZE = {
    GGML_F32: lambda x: x.astype(np.float32).tobytes(),
    GGML_F16: quantize_f16,
    GGML_BF16: quantize_bf16,
    GGML_Q8_0: lambda x: quantize_q8_0(x).tobytes(),
    GGML_Q4_0: lambda x: quantize_q4_0(x).tobytes(),
    GGML_Q4_K: lambda x: quantize_q4_k(x).tobytes(),
    GGML_Q5_K: lambda x: quantize_q5_k(x).tobytes(),
    GGML_Q6_K: lambda x: quantize_q6_k(x).tobytes(),
}


def quantize(x: np.ndarray, ggml_type: int) -> bytes:
    if ggml_type not in _QUANTIZE:
        from .reader import ggml_type_name
        raise ValueError(f"no quantizer for {ggml_type_name(ggml_type)}")
    blk_n, _ = GGML_BLOCK_LAYOUT[ggml_type]
    ne0 = x.shape[-1] if x.ndim else 1
    if ne0 % blk_n != 0:
        raise ValueError(f"last dim {ne0} not divisible by block size {blk_n}")
    return _QUANTIZE[ggml_type](np.ascontiguousarray(x, dtype=np.float32))


# ---------------------------------------------------------------------------
# Device repacking: GGUF blocks -> GroupQuant planar layout
# ---------------------------------------------------------------------------

@dataclass
class GroupQuant:
    """Planar group-affine quantized matrix, ready for device upload.

    Logical weight is [rows, cols] with contraction along `cols` (ggml ne[0],
    i.e. a Linear stored as [out, in] contracts over `cols`).  Layouts:

      values: int8  [rows, cols]
      scales: f32   [rows, cols // group]
      mins:   f32   [rows, cols // group] or None (symmetric formats)

    Dequant: w[r, c] = values[r, c] * scales[r, c//g] - mins[r, c//g].
    """
    values: np.ndarray
    scales: np.ndarray
    mins: np.ndarray | None
    group: int
    source_type: int

    @property
    def shape(self) -> tuple[int, int]:
        return self.values.shape  # type: ignore[return-value]

    def dequant(self) -> np.ndarray:
        g = self.group
        s = np.repeat(self.scales, g, axis=1)
        w = self.values.astype(np.float32) * s
        if self.mins is not None:
            w = w - np.repeat(self.mins, g, axis=1)
        return w


def to_group_quant(raw: np.ndarray, ggml_type: int, rows: int, cols: int) -> GroupQuant:
    """Repack raw GGUF tensor bytes into the planar GroupQuant layout.

    `rows`/`cols`: numpy-order 2-D shape (cols = ggml ne[0] = contraction dim).
    """
    n = rows * cols
    raw = np.ascontiguousarray(raw)
    if ggml_type == GGML_Q8_0:
        nb = n // QK
        blocks = raw[: nb * 34].reshape(nb, 34)
        d = _f16_to_f32(blocks[:, :2].copy().view(np.uint16).reshape(nb))
        q = blocks[:, 2:].view(np.int8).reshape(rows, cols)
        return GroupQuant(q.copy(), d.reshape(rows, cols // QK), None, QK, ggml_type)
    if ggml_type == GGML_Q4_0:
        nb = n // QK
        blocks = raw[: nb * 18].reshape(nb, 18)
        d = _f16_to_f32(blocks[:, :2].copy().view(np.uint16).reshape(nb))
        qs = blocks[:, 2:]
        q = np.concatenate([(qs & 0x0F), (qs >> 4)], axis=1).astype(np.int8) - 8
        return GroupQuant(q.reshape(rows, cols).copy(),
                          d.reshape(rows, cols // QK), None, QK, ggml_type)
    if ggml_type == GGML_Q4_K:
        d, dmin, sc6, mn6, q = _q4k_fields(raw, n)
        scale32 = (d[:, None] * sc6.astype(np.float32)).reshape(rows, cols // 32)
        min32 = (dmin[:, None] * mn6.astype(np.float32)).reshape(rows, cols // 32)
        return GroupQuant(q.view(np.int8).reshape(rows, cols).copy(),
                          scale32, min32, 32, ggml_type)
    if ggml_type == GGML_Q5_K:
        d, dmin, sc6, mn6, q = _q5k_fields(raw, n)
        scale32 = (d[:, None] * sc6.astype(np.float32)).reshape(rows, cols // 32)
        min32 = (dmin[:, None] * mn6.astype(np.float32)).reshape(rows, cols // 32)
        return GroupQuant(q.view(np.int8).reshape(rows, cols).copy(),
                          scale32, min32, 32, ggml_type)
    if ggml_type == GGML_Q6_K:
        d, sc, q = _q6k_fields(raw, n)
        scale16 = (d[:, None] * sc.astype(np.float32)).reshape(rows, cols // 16)
        return GroupQuant(q.reshape(rows, cols).copy(), scale16, None, 16, ggml_type)
    raise ValueError(f"to_group_quant: unsupported ggml type {ggml_type}")


def is_quantized(ggml_type: int) -> bool:
    return ggml_type in (GGML_Q8_0, GGML_Q4_0, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K)
