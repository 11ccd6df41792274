"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into its own
shared library under `build/torch_kernels/` at the repository root (listed
in .gitignore).  The library name carries a hash of the source, so an edited
kernel rebuilds and a current one is reused.  Nothing here runs at import:
the first CUDA kernel call builds, and `build_all` lets a calling script
start every `nvcc` at once.  A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> (source file, {C function: argtypes}); every function returns the
# cudaError_t of its launch as an int
KERNELS = {
    "qdot": ("qdot.cu", {
        # x, x_is_bf16, v, packed, s, mins, y, ws, tickets, M, K, N, group,
        # bm, splits, k_split, stream
        "qdot_launch": [_P, _I, _P, _I, _P, _P, _P, _P, _P] + [_I] * 7 + [_P],
    }),
    "qdot_gemv": ("qdot_gemv.cu", {
        # x, v, s, mins, y, ws, tickets, x_is_bf16, M, K, N, group, bm,
        # splits, k_split, stream
        "qdot_split_launch": [_P] * 7 + [_I] * 8 + [_P],
        # x, v, s, mins, y, packed, K, N, group, splits, k_split, stream
        "qdot_group_launch": [_P] * 5 + [_I] * 6 + [_P],
        # x, v, s, mins, y, x_is_bf16, K, N, group, splits, k_split, stream
        "qdot_w8a8_launch": [_P] * 5 + [_I] * 6 + [_P],
        "qdot_w8a8_packed_launch": [_P] * 5 + [_I] * 6 + [_P],
    }),
    "qdot_bf16": ("qdot_bf16.cu", {
        # x, x_is_bf16, v, packed, s, mins, y, ws, tickets, M, K, N, group,
        # bm, splits, k_split, after, stream
        "qdot_bf16_launch": [_P, _I, _P, _I, _P, _P, _P, _P, _P] + [_I] * 8
                            + [_P],
    }),
    "dma_floor": ("dma_floor.cu", {
        # k, v, out, sink, B, H_kv, S, D, dtype, stream
        "attn_dma_floor_launch": [_P] * 4 + [_I] * 5 + [_P],
        # v, s, out, sink, K, N, tile_k, stream
        "qdot_dma_floor_launch": [_P] * 4 + [_I] * 3 + [_P],
    }),
    "decode_attn": ("decode_attn.cu", {
        # q, q_f32, k, v, k_scale, v_scale, fill, q_pos, out, out_m, out_l,
        # B, H, H_kv, S, D, dtype, ranks, k/v strides (b, h, s), k/v scale
        # strides (b, h), scale, stream
        "decode_attn_launch": [_P, _I] + [_P] * 9 + [_I] * 7 + [_L] * 10
                              + [ctypes.c_float, _P],
    }),
    "decode_attn_single": ("decode_attn_single.cu", {
        # q, q_f32, k, v, k_scale, v_scale, fill, q_pos, out, B, H, H_kv,
        # S, D, dtype, ranks, k/v strides (b, h, s), k/v scale strides
        # (b, h), scale, stream
        "decode_attn_single_launch": [_P, _I] + [_P] * 7 + [_I] * 7
                                     + [_L] * 10 + [ctypes.c_float, _P],
    }),
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    # the source, every shared header in csrc/ and the flags
    parts = [(CSRC / KERNELS[name][0]).read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    parts.append(" ".join(NVCC_FLAGS).encode())
    digest = hashlib.sha1(b"\0".join(parts)).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start_build(name: str) -> subprocess.Popen | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.miotts_out, proc.miotts_tmp = out, tmp
    return proc


def _finish_build(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n"
                           f"{log}")
    os.replace(proc.miotts_tmp, proc.miotts_out)
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel that is not built yet, all `nvcc` processes at
    once.  Returns {name: compiler output} for what was compiled."""
    procs = {name: _start_build(name) for name in KERNELS}
    return {name: _finish_build(name, p)
            for name, p in procs.items() if p is not None}


def load_kernels() -> dict[str, ctypes.CDLL]:
    """{name: loaded library}, building what is missing."""
    if len(_loaded) < len(KERNELS):
        build_all()
        for name, (_, fns) in KERNELS.items():
            if name in _loaded:
                continue
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in fns.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _loaded[name] = lib
    return _loaded
