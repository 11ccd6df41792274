"""GGUF container reader (host side, numpy + mmap).

Re-implementation of the GGUF parsing surface the reference
consumes from ggml (`upstream src/miocodec.cpp:99-131,426-481` uses
gguf_init_from_file / gguf_find_key / gguf_get_val_* / gguf_get_data_offset /
gguf_get_tensor_offset / gguf_find_tensor).  This is a standalone parser: it
reads the header, the KV metadata store, and the tensor index, and exposes
zero-copy mmap views of the raw (possibly quantized) tensor payloads so the
loader can ship packed blocks straight to the device for in-kernel dequant.

GGUF spec: magic "GGUF", little-endian, version 2/3; u64 tensor/kv counts;
KV typed values; tensor infos (name, dims in ggml order ne[0] fastest, ggml
type enum, offset relative to the aligned data section).
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
DEFAULT_ALIGNMENT = 32

# -- GGUF metadata value types -------------------------------------------------
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STRING, T_ARRAY = range(10)
T_U64, T_I64, T_F64 = 10, 11, 12

_SCALAR_FMT = {
    T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h",
    T_U32: "<I", T_I32: "<i", T_F32: "<f", T_U64: "<Q",
    T_I64: "<q", T_F64: "<d",
}

# -- ggml tensor dtypes (the subset this framework supports) -------------------
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q4_1 = 3
GGML_Q5_0 = 6
GGML_Q5_1 = 7
GGML_Q8_0 = 8
GGML_Q2_K = 10
GGML_Q3_K = 11
GGML_Q4_K = 12
GGML_Q5_K = 13
GGML_Q6_K = 14
GGML_Q8_K = 15
GGML_I8 = 24
GGML_I16 = 25
GGML_I32 = 26
GGML_I64 = 27
GGML_F64 = 28
GGML_BF16 = 30

GGML_TYPE_NAMES = {
    GGML_F32: "F32", GGML_F16: "F16", GGML_BF16: "BF16",
    GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1", GGML_Q5_0: "Q5_0", GGML_Q5_1: "Q5_1",
    GGML_Q8_0: "Q8_0", GGML_Q2_K: "Q2_K", GGML_Q3_K: "Q3_K", GGML_Q4_K: "Q4_K",
    GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K", GGML_Q8_K: "Q8_K",
    GGML_I8: "I8", GGML_I16: "I16", GGML_I32: "I32", GGML_I64: "I64",
    GGML_F64: "F64",
}

# (block_elems, block_bytes) per ggml type.
GGML_BLOCK_LAYOUT = {
    GGML_F32: (1, 4),
    GGML_F16: (1, 2),
    GGML_BF16: (1, 2),
    GGML_F64: (1, 8),
    GGML_I8: (1, 1),
    GGML_I16: (1, 2),
    GGML_I32: (1, 4),
    GGML_I64: (1, 8),
    GGML_Q4_0: (32, 18),
    GGML_Q4_1: (32, 20),
    GGML_Q5_0: (32, 22),
    GGML_Q5_1: (32, 24),
    GGML_Q8_0: (32, 34),
    GGML_Q4_K: (256, 144),
    GGML_Q5_K: (256, 176),
    GGML_Q6_K: (256, 210),
}


def ggml_type_name(t: int) -> str:
    return GGML_TYPE_NAMES.get(t, f"type{t}")


def ggml_nbytes(shape_ne: tuple[int, ...], ggml_type: int) -> int:
    """Byte size of a tensor with ggml dims `ne` (ne[0] fastest-varying)."""
    if ggml_type not in GGML_BLOCK_LAYOUT:
        raise ValueError(f"unsupported ggml type {ggml_type}")
    blk_n, blk_b = GGML_BLOCK_LAYOUT[ggml_type]
    ne0 = shape_ne[0] if shape_ne else 1
    if ne0 % blk_n != 0:
        raise ValueError(f"ne[0]={ne0} not divisible by block size {blk_n}")
    row_bytes = ne0 // blk_n * blk_b
    n_rows = 1
    for d in shape_ne[1:]:
        n_rows *= d
    return row_bytes * n_rows


@dataclass
class TensorInfo:
    name: str
    ne: tuple[int, ...]          # ggml dims, ne[0] fastest-varying
    ggml_type: int
    offset: int                  # relative to data section start
    nbytes: int = 0

    @property
    def shape(self) -> tuple[int, ...]:
        """Numpy-order shape (row-major): reverse of ggml ne."""
        return tuple(reversed(self.ne))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def type_name(self) -> str:
        return ggml_type_name(self.ggml_type)


class GGUFReader:
    """Parses a GGUF file; exposes KV metadata and raw tensor byte views.

    Raw tensor payloads are exposed as zero-copy numpy uint8 views into an
    mmap of the file, so multi-GB quantized models load lazily.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._file: BinaryIO = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        self.kv: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self.tensor_order: list[str] = []
        self.version = 0
        self.alignment = DEFAULT_ALIGNMENT
        self.data_offset = 0
        self._parse()

    # -- low-level readers -----------------------------------------------
    def _read(self, n: int) -> bytes:
        b = self._mm[self._pos:self._pos + n]
        if len(b) != n:
            raise EOFError(f"unexpected EOF in {self.path}")
        self._pos += n
        return b

    def _read_fmt(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._read(size))[0]

    def _read_string(self) -> str:
        n = self._read_fmt("<Q")
        return self._read(n).decode("utf-8", errors="replace")

    def _read_value(self, vtype: int):
        if vtype in _SCALAR_FMT:
            return self._read_fmt(_SCALAR_FMT[vtype])
        if vtype == T_BOOL:
            return bool(self._read_fmt("<B"))
        if vtype == T_STRING:
            return self._read_string()
        if vtype == T_ARRAY:
            etype = self._read_fmt("<I")
            count = self._read_fmt("<Q")
            if etype in _SCALAR_FMT and count > 4096:
                # Fast path for big numeric arrays (token_type, SPM scores).
                fmt = _SCALAR_FMT[etype]
                itemsize = struct.calcsize(fmt)
                raw = self._read(itemsize * count)
                dt = np.dtype(fmt[1]).newbyteorder("<")
                return np.frombuffer(raw, dtype=dt).tolist()
            return [self._read_value(etype) for _ in range(count)]
        raise ValueError(f"unknown GGUF value type {vtype}")

    # -- structure -------------------------------------------------------
    def _parse(self) -> None:
        magic = self._read_fmt("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {magic:#x})")
        self.version = self._read_fmt("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{self.path}: unsupported GGUF version {self.version}")
        n_tensors = self._read_fmt("<Q")
        n_kv = self._read_fmt("<Q")

        for _ in range(n_kv):
            key = self._read_string()
            vtype = self._read_fmt("<I")
            self.kv[key] = self._read_value(vtype)

        self.alignment = int(self.kv.get("general.alignment", DEFAULT_ALIGNMENT))

        for _ in range(n_tensors):
            name = self._read_string()
            n_dims = self._read_fmt("<I")
            ne = tuple(self._read_fmt("<Q") for _ in range(n_dims))
            ggml_type = self._read_fmt("<I")
            offset = self._read_fmt("<Q")
            info = TensorInfo(name=name, ne=ne, ggml_type=ggml_type, offset=offset)
            try:
                info.nbytes = ggml_nbytes(ne, ggml_type)
            except ValueError:
                info.nbytes = 0
            self.tensors[name] = info
            self.tensor_order.append(name)

        pad = (self.alignment - self._pos % self.alignment) % self.alignment
        self.data_offset = self._pos + pad

    # -- public API ------------------------------------------------------
    def get_u32(self, key: str, default: int | None = None) -> int:
        v = self.kv.get(key, default)
        if v is None:
            raise KeyError(key)
        return int(v)

    def get_f32(self, key: str, default: float | None = None) -> float:
        v = self.kv.get(key, default)
        if v is None:
            raise KeyError(key)
        return float(v)

    def get_str(self, key: str, default: str | None = None) -> str:
        v = self.kv.get(key, default)
        if v is None:
            raise KeyError(key)
        return str(v)

    def has_tensor(self, name: str) -> bool:
        return name in self.tensors

    def tensor_raw(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of a tensor's packed payload."""
        info = self.tensors[name]
        start = self.data_offset + info.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=info.nbytes, offset=start)

    def tensor_f32(self, name: str) -> np.ndarray:
        """Fully dequantized tensor as float32 in numpy (row-major) order."""
        from .quants import dequantize
        info = self.tensors[name]
        flat = dequantize(self.tensor_raw(name), info.ggml_type, info.n_elements)
        return flat.reshape(info.shape)

    def tensor_np(self, name: str) -> np.ndarray:
        """Tensor in its natural numpy dtype (int tensors stay integral).

        Always returns an owning copy: a zero-copy mmap view would raise
        BufferError at reader close for any caller holding the result past
        the `with` block (quantized/f16 paths already copy via dequantize,
        so views here would make lifetime rules type-dependent)."""
        info = self.tensors[name]
        raw = self.tensor_raw(name)
        dt = {GGML_I8: np.int8, GGML_I16: np.int16, GGML_I32: np.int32,
              GGML_I64: np.int64, GGML_F64: np.float64, GGML_F32: np.float32}.get(info.ggml_type)
        if dt is not None:
            return raw.view(dt).reshape(info.shape).copy()
        return self.tensor_f32(name)

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_voice_embedding(path: str | os.PathLike) -> np.ndarray:
    """Load a `.emb.gguf` voice embedding (first tensor, F32).

    Mirrors the reference contract at `upstream src/miocodec.cpp:816-853`:
    the first tensor of the file must be F32; returns its flat float32 data
    (128-dim `mio.global_embedding` in practice).
    """
    with GGUFReader(path) as r:
        if not r.tensor_order:
            raise ValueError(f"{path}: no tensors")
        info = r.tensors[r.tensor_order[0]]
        if info.ggml_type != GGML_F32:
            raise ValueError(f"{path}: voice embedding must be F32, got {info.type_name}")
        return r.tensor_f32(r.tensor_order[0]).reshape(-1).copy()
