"""GGUF container writer.

The reference only reads GGUF; this framework also writes it, because (a) the
voice-embedding tool emits `.emb.gguf` files (reference:
`upstream tools/create_voice_emb.py:112-133`), (b) the test suite
builds tiny synthetic models, and (c) the quantize tool converts f32 checkpoints
to Q8_0/Q6_K/Q4_K GGUFs.  Produces GGUF v3, little-endian, alignment 32.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

from .reader import (
    DEFAULT_ALIGNMENT, GGUF_MAGIC,
    T_ARRAY, T_BOOL, T_F32, T_F64, T_I8, T_I16, T_I32, T_I64, T_STRING,
    T_U8, T_U16, T_U32, T_U64,
    GGML_F32, GGML_I32, ggml_nbytes,
)
from .quants import quantize

_SCALAR_PACK = {
    T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h",
    T_U32: "<I", T_I32: "<i", T_F32: "<f", T_U64: "<Q",
    T_I64: "<q", T_F64: "<d",
}


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _pack_value(vtype: int, v: Any) -> bytes:
    if vtype in _SCALAR_PACK:
        return struct.pack(_SCALAR_PACK[vtype], v)
    if vtype == T_BOOL:
        return struct.pack("<B", 1 if v else 0)
    if vtype == T_STRING:
        return _pack_string(v)
    raise ValueError(f"cannot pack value type {vtype}")


class GGUFWriter:
    def __init__(self, path: str):
        self.path = path
        self._kv: list[tuple[str, int, bytes]] = []
        self._tensors: list[tuple[str, tuple[int, ...], int, bytes]] = []

    # -- KV --------------------------------------------------------------
    def add_kv(self, key: str, value: Any, vtype: int | None = None) -> None:
        if vtype is None:
            if isinstance(value, bool):
                vtype = T_BOOL
            elif isinstance(value, int):
                vtype = T_U32 if 0 <= value < 2**32 else T_I64
            elif isinstance(value, float):
                vtype = T_F32
            elif isinstance(value, str):
                vtype = T_STRING
            elif isinstance(value, (list, tuple, np.ndarray)):
                return self.add_array(key, list(value))
            else:
                raise TypeError(f"cannot infer GGUF type for {type(value)}")
        self._kv.append((key, vtype, _pack_value(vtype, value)))

    def add_array(self, key: str, values: list, etype: int | None = None) -> None:
        if etype is None:
            if not values:
                etype = T_I32
            elif isinstance(values[0], bool):
                etype = T_BOOL
            elif isinstance(values[0], (int, np.integer)):
                etype = T_I32
            elif isinstance(values[0], (float, np.floating)):
                etype = T_F32
            elif isinstance(values[0], str):
                etype = T_STRING
            else:
                raise TypeError(f"cannot infer element type for {type(values[0])}")
        payload = struct.pack("<IQ", etype, len(values))
        payload += b"".join(_pack_value(etype, v) for v in values)
        self._kv.append((key, T_ARRAY, payload))

    # -- tensors ---------------------------------------------------------
    def add_tensor(self, name: str, data: np.ndarray, ggml_type: int | None = None) -> None:
        """Add a tensor. `data` is in numpy (row-major) order; its reversed
        shape becomes the ggml `ne` dims, and the last numpy axis (= ne[0])
        is the quantization axis."""
        data = np.ascontiguousarray(data)
        if ggml_type is None:
            if data.dtype == np.int32:
                ggml_type = GGML_I32
            else:
                ggml_type = GGML_F32
        if ggml_type == GGML_I32:
            payload = data.astype(np.int32).tobytes()
        else:
            payload = quantize(data.astype(np.float32), ggml_type)
        ne = tuple(reversed(data.shape)) if data.shape else (1,)
        expect = ggml_nbytes(ne, ggml_type)
        if len(payload) != expect:
            raise AssertionError(f"{name}: payload {len(payload)} != expected {expect}")
        self._tensors.append((name, ne, ggml_type, payload))

    # -- serialize -------------------------------------------------------
    def write(self) -> None:
        align = DEFAULT_ALIGNMENT
        header = struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self._tensors), len(self._kv))
        kv_blob = b""
        for key, vtype, payload in self._kv:
            kv_blob += _pack_string(key) + struct.pack("<I", vtype) + payload

        infos = b""
        offset = 0
        offsets = []
        for name, ne, ggml_type, payload in self._tensors:
            offsets.append(offset)
            infos += _pack_string(name)
            infos += struct.pack("<I", len(ne))
            for d in ne:
                infos += struct.pack("<Q", d)
            infos += struct.pack("<IQ", ggml_type, offset)
            offset += len(payload)
            offset += (align - offset % align) % align

        head = header + kv_blob + infos
        pad0 = (align - len(head) % align) % align

        with open(self.path, "wb") as f:
            f.write(head)
            f.write(b"\x00" * pad0)
            pos = 0
            for (name, ne, ggml_type, payload), off in zip(self._tensors, offsets):
                assert pos == off, (name, pos, off)
                f.write(payload)
                pos += len(payload)
                pad = (align - pos % align) % align
                f.write(b"\x00" * pad)
                pos += pad


def write_voice_embedding(path: str, embedding: np.ndarray, name: str = "unknown") -> None:
    """Write a `.emb.gguf` voice embedding file.

    Container contract per the reference tool
    (`upstream tools/create_voice_emb.py:125-133`): arch
    "mio-embedding", KV `mio.embedding.dim`, single F32 tensor
    `mio.global_embedding`.
    """
    emb = np.asarray(embedding, dtype=np.float32).reshape(-1)
    w = GGUFWriter(path)
    w.add_kv("general.architecture", "mio-embedding")
    w.add_kv("general.name", name)
    w.add_kv("mio.embedding.dim", int(emb.shape[0]))
    w.add_tensor("mio.global_embedding", emb, GGML_F32)
    w.write()
