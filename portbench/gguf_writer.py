"""A frozen GGUF v3 writer for the benchmark's seeded models.

It writes payloads that are already in their storage format (the weight
maker draws quantized blocks directly), so it never quantizes.  The
container follows the GGUF spec: little-endian, "GGUF" magic, version 3,
typed KV metadata, a tensor index whose dims are in ggml order (ne[0]
fastest, the reverse of numpy's shape) and a data section aligned to 32
bytes.  It is kept apart from the program's own writer so that what the
benchmark feeds the program cannot change with the program.
"""

from __future__ import annotations

import struct

import numpy as np

GGUF_MAGIC = 0x46554747
ALIGN = 32

# KV value types
T_U32, T_I32, T_F32, T_BOOL, T_STRING, T_ARRAY = 4, 5, 6, 7, 8, 9
T_I64 = 11

# ggml tensor types used here: (elements a block, bytes a block)
GGML_F32, GGML_Q8_0, GGML_Q4_K, GGML_Q6_K, GGML_I32 = 0, 8, 12, 14, 26
BLOCK = {GGML_F32: (1, 4), GGML_I32: (1, 4), GGML_Q8_0: (32, 34),
         GGML_Q4_K: (256, 144), GGML_Q6_K: (256, 210)}


def nbytes(n_elements: int, ggml_type: int) -> int:
    per, size = BLOCK[ggml_type]
    if n_elements % per:
        raise ValueError(f"{n_elements} elements is not a whole number of "
                         f"blocks of {per}")
    return n_elements // per * size


def _string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _scalar(vtype: int, v) -> bytes:
    if vtype == T_STRING:
        return _string(v)
    fmt = {T_U32: "<I", T_I32: "<i", T_F32: "<f", T_BOOL: "<B",
           T_I64: "<q"}[vtype]
    return struct.pack(fmt, int(v) if vtype == T_BOOL else v)


class Writer:
    """Collects KV pairs and raw tensor payloads, then writes one file."""

    def __init__(self):
        self._kv: list[bytes] = []
        self._tensors: list[tuple[str, tuple, int, np.ndarray]] = []

    def kv(self, key: str, value) -> None:
        if isinstance(value, bool):
            vtype = T_BOOL
        elif isinstance(value, int):
            vtype = T_U32 if 0 <= value < 2 ** 32 else T_I64
        elif isinstance(value, float):
            vtype = T_F32
        elif isinstance(value, str):
            vtype = T_STRING
        else:
            raise TypeError(f"{key}: no GGUF type for {type(value)}")
        self._kv.append(_string(key) + struct.pack("<I", vtype)
                        + _scalar(vtype, value))

    def array(self, key: str, values: list) -> None:
        etype = T_STRING if values and isinstance(values[0], str) else T_I32
        body = b"".join(_scalar(etype, v) for v in values)
        self._kv.append(_string(key) + struct.pack("<I", T_ARRAY)
                        + struct.pack("<IQ", etype, len(values)) + body)

    def tensor(self, name: str, shape: tuple, ggml_type: int,
               payload: np.ndarray) -> None:
        """`shape` in numpy order ([rows, cols] for a matrix); `payload`
        the tensor's bytes as a uint8 array."""
        n = int(np.prod(shape))
        if payload.nbytes != nbytes(n, ggml_type):
            raise ValueError(f"{name}: {payload.nbytes} bytes, want "
                             f"{nbytes(n, ggml_type)}")
        ne = tuple(reversed(shape))
        self._tensors.append((name, ne, ggml_type, payload))

    def write(self, f) -> None:
        """Write the file to the binary file object `f`."""
        head = [struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self._tensors),
                            len(self._kv)), *self._kv]
        offset = 0
        for name, ne, ggml_type, payload in self._tensors:
            head.append(_string(name) + struct.pack("<I", len(ne))
                        + b"".join(struct.pack("<Q", d) for d in ne)
                        + struct.pack("<IQ", ggml_type, offset))
            offset += payload.nbytes + (-payload.nbytes) % ALIGN
        blob = b"".join(head)
        f.write(blob + b"\0" * ((-len(blob)) % ALIGN))
        for _, _, _, payload in self._tensors:
            f.write(memoryview(np.ascontiguousarray(payload)).cast("B"))
            f.write(b"\0" * ((-payload.nbytes) % ALIGN))
