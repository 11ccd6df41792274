"""The quantized-matmul kernels and the K8 probe at bf16 group scales and
mins (MIOTTS_SCALE_BF16's storage) against their plain torch versions, and
against their own f32-scale instantiations on the same scales upcast.
Imports nothing of JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scale_bf16_cuda.py

The `cuda`-marked tests skip without a GPU; the wrappers' input checks run
everywhere (they raise before any build or launch)."""

import dataclasses

import numpy as np
import pytest
import torch

from miotts_tpu_torch.gguf import (GGML_Q4_0, GGML_Q4_K, GGML_Q6_K, GGML_Q8_0,
                                   quantize)
from miotts_tpu_torch.ops import qmat as tq

F32_TOL = 1e-5      # f32 output: the order of the f32 sums only
BF16_TOL = 1e-2     # bf16 output: one 2^-8 rounding on either side
PROBE_TOL = 1e-6    # K8: f32 sums of the tiles in another order
# (label, format, packed): g32 int8, g16 int8, g32 packed with mins, g32
# int8 with mins, Q4_0's packed centring (mins from the fold), and the
# Q4_K_M QKV mix (g16, mins, unpacked)
FORMATS = [("q8_0", GGML_Q8_0, False), ("q6_k", GGML_Q6_K, False),
           ("q4_k_packed", GGML_Q4_K, True), ("q4_k", GGML_Q4_K, False),
           ("q4_0_packed", GGML_Q4_0, True), ("q4_k+q6_k", None, False)]
NS = (1024, 1000)    # rows 16-byte aligned, and not (N % 16 == 8)


def _qt(fmt, pack4, n, k, seed=0):
    """A bf16-scale QTensor on the CPU, as a load under MIOTTS_SCALE_BF16
    gives it; fmt None: the fused QKV of a Q4_K_M file (Q4_K q / k, Q6_K
    v)."""
    if fmt is None:
        q, kv = n - n // 4, n // 8
        parts = [_qt(GGML_Q4_K, True, q, k, seed), _qt(GGML_Q4_K, True, kv, k,
                                                       seed + 1),
                 _qt(GGML_Q6_K, False, n - q - kv, k, seed + 2)]
        return tq.concat_qtensors(parts)
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    raw = np.frombuffer(quantize(w, fmt), dtype=np.uint8)
    return tq.qtensor_from_raw(raw, fmt, n, k, pack4=pack4,
                               scale_dtype=torch.bfloat16)


def _rel_err(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _x(m, k, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    x[:, 32:64] = 0.0           # an all-zero quant group (K4's sx = 1 rule)
    return torch.from_numpy(x).to("cuda", dtype)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _check(fn, plain, x, qt, tol, label):
    """fn(x, qt) against plain(x, qt) within tol, a second call bit for bit,
    and bit for bit the f32-scale instantiation on the upcast scales (the
    same f32 arithmetic in the same order)."""
    got = fn(x, qt)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (x.shape[0], qt.shape[0])
    err = _rel_err(got.float(), plain(x, qt).float())
    assert err < tol, (label, err)
    assert torch.equal(fn(x, qt), got), label
    assert torch.equal(fn(x, qt.with_scale_dtype(torch.float32)), got), label


# ---------------------------------------------------------------------------
# Wrapper checks (run everywhere)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qdot", "qdot_bf16", "qdot_split",
                                  "qdot_group", "qdot_w8a8"])
def test_wrappers_refuse_mixed_scale_dtypes(name):
    """bf16 scales with f32 mins (or the reverse) are refused, not
    converted: each launch takes one scale type."""
    qt = _qt(GGML_Q4_K, True, 64, 256)
    x = torch.zeros((1, 256), dtype=torch.bfloat16)
    fns = {"qdot": tq._qdot_cuda,
           "qdot_bf16": lambda x, q: tq._qdot_bf16_cuda(x, q, "after"),
           "qdot_split": tq._qdot_split_cuda, "qdot_group": tq._qdot_group_cuda,
           "qdot_w8a8": tq._qdot_w8a8_cuda}
    for mixed in (dataclasses.replace(qt, mins=qt.mins.float()),
                  dataclasses.replace(qt, scales=qt.scales.float())):
        with pytest.raises(ValueError, match="scales/mins"):
            tq._checked(name, x, mixed)
        if torch.cuda.is_available():
            with pytest.raises(ValueError, match="scales/mins"):
                fns[name](x.cuda(), mixed.to("cuda"))


def test_wrappers_refuse_other_scale_dtypes():
    qt = _qt(GGML_Q8_0, False, 64, 256)
    f16 = dataclasses.replace(qt, scales=qt.scales.half())
    with pytest.raises(TypeError, match="f32 or bf16 scales"):
        tq._checked("qdot", torch.zeros((1, 256)), f16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        tq._k8_checked(f16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        qt.with_scale_dtype(torch.float16)


# ---------------------------------------------------------------------------
# Kernels vs plain on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("label,fmt,pack4", FORMATS)
@pytest.mark.parametrize("n", NS)
def test_k1_matches_plain_at_bf16_scales_on_gpu(label, fmt, pack4, n):
    """K1 at M = 1 (the GEMV) and M = 7, 64 (the tile), f32 and bf16 x."""
    _need_gpu()
    qt = _qt(fmt, pack4, n, 1024).to("cuda")
    for m in (1, 7, 64):
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            _check(tq.qdot, tq.qdot_plain, _x(m, 1024, dtype, m), qt, tol,
                   (label, n, m, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("label,fmt,pack4", FORMATS)
@pytest.mark.parametrize("mode", ["1", "after"])
def test_k1v_matches_plain_at_bf16_scales_on_gpu(label, fmt, pack4, mode):
    """K1v in both modes at M = 1 and 16, aligned and ragged N."""
    _need_gpu()
    for n in NS:
        qt = _qt(fmt, pack4, n, 1024, seed=n).to("cuda")
        for m in (1, 16):
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                _check(lambda x, q: tq.qdot_bf16(x, q, mode),
                       lambda x, q: tq.qdot_bf16_plain(x, q, mode),
                       _x(m, 1024, dtype, m), qt, tol, (label, n, m, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [GGML_Q4_K, GGML_Q4_0])
def test_k2_matches_plain_at_bf16_scales_on_gpu(fmt):
    """K2 at M = 1, 7, 64 on packed values, aligned and ragged N."""
    _need_gpu()
    for n in NS:
        qt = _qt(fmt, True, n, 1024, seed=n).to("cuda")
        for m in (1, 7, 64):
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                _check(tq.qdot_split, tq.qdot_split_plain,
                       _x(m, 1024, dtype, m), qt, tol, (fmt, n, m, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("label,fmt,pack4", FORMATS)
def test_k3_k4_match_plain_at_bf16_scales_on_gpu(label, fmt, pack4):
    """K3 (bf16 x) and K4a / K4b (f32 and bf16 x) at M = 1, aligned and
    ragged N."""
    _need_gpu()
    for n in NS:
        qt = _qt(fmt, pack4, n, 1024, seed=n).to("cuda")
        _check(tq.qdot_group, tq.qdot_group_plain,
               _x(1, 1024, torch.bfloat16, 3), qt, BF16_TOL, (label, n, "K3"))
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            _check(tq.qdot_w8a8, tq.qdot_w8a8_plain, _x(1, 1024, dtype, 5),
                   qt, tol, (label, n, "K4", dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,pack4", [(GGML_Q8_0, False), (GGML_Q4_K, True),
                                       (GGML_Q6_K, False)])
def test_kernels_at_the_head_width_and_long_k_on_gpu(fmt, pack4):
    """The output head's N = 13059 (odd: scale rows start mid-word) at
    M = 1, 16, 64, and K = 8192 (the GEMV's cluster, the tile's split-K)."""
    _need_gpu()
    for n, k in ((13059, 2048), (2560, 8192)):
        qt = _qt(fmt, pack4, n, k, seed=k).to("cuda")
        for m in (1, 16, 64):
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                _check(tq.qdot, tq.qdot_plain, _x(m, k, dtype, m), qt, tol,
                       (fmt, n, k, m, dtype))
            _check(lambda x, q: tq.qdot_bf16(x, q, "after"),
                   lambda x, q: tq.qdot_bf16_plain(x, q, "after"),
                   _x(m, k, torch.bfloat16, m), qt, BF16_TOL, (fmt, n, k, m))


@pytest.mark.cuda
def test_bf16_scales_reach_their_instantiation_on_gpu():
    """One launch a call, no host-side copy of the scales in f32: every
    scale-type argument the wrappers form comes from the bf16 tensor's own
    storage."""
    _need_gpu()
    qt = _qt(GGML_Q4_K, True, 1024, 1024).to("cuda")
    seen = []
    real = tq._s_bf16
    try:
        tq._s_bf16 = lambda q: seen.append(q.scales.data_ptr()) or real(q)
        before = (tq.qdot.kernel_launches, tq.qdot_bf16.kernel_launches)
        tq.qdot(_x(1, 1024, torch.bfloat16, 0), qt)
        tq.qdot(_x(7, 1024, torch.bfloat16, 0), qt)
        tq.qdot_bf16(_x(1, 1024, torch.bfloat16, 0), qt, "after")
        torch.cuda.synchronize()
    finally:
        tq._s_bf16 = real
    assert len(seen) >= 3 and set(seen) == {qt.scales.data_ptr()}
    assert (tq.qdot.kernel_launches, tq.qdot_bf16.kernel_launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(2560, 3840), (8192, 2560), (2048, 13059),
                                 (768, 1000)])
def test_k8_matches_plain_at_bf16_scales_on_gpu(K, N):
    """K8 over bf16 scale rows (half the scale bytes) on its plan and on one
    split, within 1e-6, and bit for bit its f32-scale instantiation on the
    upcast scales."""
    _need_gpu()
    qt = _qt(GGML_Q8_0, False, N, K, seed=K).to("cuda")
    want = tq.qdot_dma_floor_plain(qt)
    for plan in (None, tq.GemvPlan(splits=1, k_split=K)):
        got = tq.qdot_dma_floor(qt, plan)
        torch.cuda.synchronize()
        assert got.shape == (1, N)
        assert _rel_err(got, want) < PROBE_TOL
        assert torch.equal(got, tq.qdot_dma_floor(
            qt.with_scale_dtype(torch.float32), plan))
