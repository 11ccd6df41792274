"""K1v (the bf16-dot quantized matmul, miotts_tpu_torch/ops/csrc/qdot_bf16.cu)
and the bandwidth-floor probes K7 / K8 (ops/csrc/dma_floor.cu) against
their plain torch versions.  Imports nothing of JAX, so it runs on a GPU
machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_qdot_bf16_cuda.py

The `cuda`-marked tests skip without a GPU; the wrappers' input checks run
everywhere (they raise before any build or launch)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from miotts_tpu_torch.gguf import (GGML_Q4_0, GGML_Q4_K, GGML_Q6_K, GGML_Q8_0,
                                   quantize)
from miotts_tpu_torch.ops import decode_attn as tda
from miotts_tpu_torch.ops import qmat as tq

FORMATS = [(GGML_Q8_0, False), (GGML_Q6_K, False), (GGML_Q4_K, False),
           (GGML_Q4_K, True), (GGML_Q4_0, True)]
MODES = ("1", "after")
F32_TOL = 1e-5      # f32 output: the order of the f32 sums only
BF16_TOL = 1e-2     # bf16 output: one 2^-8 rounding on either side


def _qt(gtype, pack4, n, k, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    raw = np.frombuffer(quantize(w, gtype), dtype=np.uint8)
    return tq.qtensor_from_raw(raw, gtype, n, k, pack4=pack4)


def _rel_err(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _x(m, k, dtype, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (m, k)).astype(np.float32))
    return x.to("cuda", dtype)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def test_wrappers_reject_cpu_tensors():
    """No wrapper falls back: a tensor that is not on the GPU is refused."""
    qt = _qt(GGML_Q8_0, False, 64, 256)
    with pytest.raises(ValueError, match="GPU"):
        tq._qdot_bf16_cuda(torch.zeros((1, 256), dtype=torch.bfloat16), qt,
                           "1")
    with pytest.raises(ValueError, match="GPU"):
        tq._qdot_dma_floor_cuda(qt)
    k = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="GPU"):
        tda._dma_floor_cuda(k, k)


@pytest.mark.parametrize("bad,err", [
    ("mode", ValueError), ("dtype", TypeError), ("group", ValueError),
    ("k", ValueError), ("values", TypeError)])
def test_bf16_wrapper_rejects_bad_inputs(bad, err):
    """Wrong mode, dtype, group, K or value type raise before any launch."""
    qt = _qt(GGML_Q4_K, True, 64, 256)
    x = torch.zeros((2, 256), dtype=torch.bfloat16)
    mode = "after"
    if bad == "mode":
        mode = ""
    elif bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "group":
        qt = dataclasses.replace(qt, group=64)
    elif bad == "k":
        x = torch.zeros((2, 128), dtype=torch.bfloat16)
    elif bad == "values":
        qt = dataclasses.replace(qt, values=qt.values.to(torch.int8))
    with pytest.raises(err):
        tq._qdot_bf16_cuda(x, qt, mode)


def _check(x, qt, mode, tol):
    before = tq.qdot_bf16.kernel_launches
    got = tq.qdot_bf16(x, qt, mode)
    torch.cuda.synchronize()
    assert tq.qdot_bf16.kernel_launches == before + 1
    want = tq.qdot_bf16_plain(x, qt, mode)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = _rel_err(got, want)
    assert err < tol, (mode, tuple(x.shape), err)


@pytest.mark.cuda
@pytest.mark.parametrize("gtype,pack4", FORMATS)
def test_bf16_kernel_matches_plain_on_gpu(gtype, pack4):
    """Both modes, f32 and bf16 x, at the decode GEMV (M=1), the ragged and
    slot tiles (7, 16) and the prefill tile (64), with a ragged N (1000)."""
    _need_gpu()
    qt = _qt(gtype, pack4, 1000, 1024).to("cuda")
    for mode in MODES:
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            for m in (1, 7, 16, 64):
                _check(_x(m, 1024, dtype, seed=m), qt, mode, tol)


@pytest.mark.cuda
def test_bf16_kernel_modes_differ_on_gpu():
    """The kernel's two modes are not one: > 1e-4 of the output scale apart
    at f32 x, each within 1e-5 of its own plain version."""
    _need_gpu()
    qt = _qt(GGML_Q4_K, True, 512, 1024).to("cuda")
    for m in (1, 16):
        x = _x(m, 1024, torch.float32, seed=20 + m)
        one, after = (tq.qdot_bf16(x, qt, mode) for mode in MODES)
        assert _rel_err(one, after) > 1e-4


def _rand_qt(k, n, fmt, gen):
    """A QTensor of GGUF format `fmt`'s planar layout, random on the card."""
    group = 16 if fmt == "q6_k" else 32
    lo, hi = {"q8_0": (-127, 128), "q6_k": (-32, 32), "q4_k": (0, 16)}[fmt]
    vals = torch.randint(lo, hi, (k, n), generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.int8)
    scales = (torch.rand((k // group, n), generator=gen, device="cuda")
              + 0.5) / (hi * math.sqrt(k))
    mins = None
    if fmt == "q4_k":
        mins = torch.rand((k // group, n), generator=gen, device="cuda") \
            * (8.0 / (hi * math.sqrt(k)))
    qt = tq.QTensor(values=vals, scales=scales, mins=mins, group=group,
                    n_out=n)
    return qt.pack4() if fmt == "q4_k" else qt


@pytest.mark.cuda
def test_bf16_kernel_at_2p6b_q4_k_m_shapes():
    """The 2.6B-Q4_K_M formats: fused QKV (Q4_K + Q6_K -> int8 g16 with
    mins), gate-up / output (packed Q4_K, N = 13059 not a multiple of 8),
    w_down (Q6_K, K = 8192), at M = 1, 7 and 64."""
    _need_gpu()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    wqkv = tq.concat_qtensors([_rand_qt(2560, 2560, "q4_k", gen),
                               _rand_qt(2560, 640, "q4_k", gen),
                               _rand_qt(2560, 640, "q6_k", gen)])
    assert not wqkv.packed and wqkv.group == 16 and wqkv.mins is not None
    for qt in (wqkv, _rand_qt(2560, 16384, "q4_k", gen),
               _rand_qt(8192, 2560, "q6_k", gen),
               _rand_qt(2560, 13059, "q4_k", gen)):
        for mode in MODES:
            for m in (1, 7, 64):
                for dtype, tol in ((torch.float32, F32_TOL),
                                   (torch.bfloat16, BF16_TOL)):
                    _check(_x(m, qt.k, dtype, seed=m), qt, mode, tol)


@pytest.mark.cuda
def test_bf16_route_reaches_the_kernel_on_gpu():
    """Under MIOTTS_QDOT_BF16 a bf16 x counts one K1v launch and no K1
    launch at every M; an f32 x counts one K1 launch."""
    _need_gpu()
    qt = _qt(GGML_Q4_K, True, 512, 1024).to("cuda")
    w = tq.with_route(qt, tq.QdotRoute.from_env({"MIOTTS_QDOT_BF16": "after"}))
    for x, moved in ((_x(1, 1024, torch.bfloat16, 1), "K1v"),
                     (_x(16, 1024, torch.bfloat16, 2), "K1v"),
                     (_x(16, 1024, torch.float32, 3), "K1")):
        before = (tq.qdot.kernel_launches, tq.qdot_bf16.kernel_launches)
        y = tq.qdot(x, w)
        torch.cuda.synchronize()
        after = (tq.qdot.kernel_launches, tq.qdot_bf16.kernel_launches)
        assert y.shape == (x.shape[0], 512)
        assert (after[0] - before[0], after[1] - before[1]) == (
            (0, 1) if moved == "K1v" else (1, 0))


# ---------------------------------------------------------------------------
# K7 / K8: the probes
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("B,H_kv,S,D", [
    (1, 8, 256, 64), (4, 8, 1536, 64), (2, 8, 1100, 80), (64, 4, 512, 64),
    (3, 2, 200, 128)])
def test_attn_dma_floor_matches_plain_on_gpu(B, H_kv, S, D, dtype):
    """K7 sums in the plain version's order: equal bit for bit."""
    _need_gpu()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S + D)
    if dtype == torch.int8:
        k, v = (torch.randint(-127, 128, (B, H_kv, S, D), generator=gen,
                              device="cuda", dtype=torch.int32).to(dtype)
                for _ in range(2))
    else:
        k, v = (torch.randn((B, H_kv, S, D), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
    before = tda.dma_floor.kernel_launches
    got = tda.dma_floor(k, v)
    torch.cuda.synchronize()
    assert tda.dma_floor.kernel_launches == before + 1
    assert torch.equal(got, tda.dma_floor_plain(k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(2560, 3840), (2560, 2560), (2560, 16384),
                                 (8192, 2560), (768, 13059), (2048, 1000)])
def test_qdot_dma_floor_matches_plain_on_gpu(K, N):
    """K8 at the 2.6B shapes of bench_qmat and two ragged widths: within
    1e-6 (the tiles' f32 sums in another order)."""
    _need_gpu()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(K + N)
    qt = tq.QTensor(
        values=torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8),
        scales=torch.rand((K // 32, N), generator=gen, device="cuda") * 0.02,
        mins=None, group=32, n_out=N)
    before = tq.qdot_dma_floor.kernel_launches
    got = tq.qdot_dma_floor(qt)
    torch.cuda.synchronize()
    assert tq.qdot_dma_floor.kernel_launches == before + 1
    want = tq.qdot_dma_floor_plain(qt)
    assert got.shape == (1, N) and _rel_err(got, want) < 1e-6
