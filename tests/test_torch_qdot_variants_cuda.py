"""The single-stream quantized-matmul kernels (K2 split, K3 group-dot, K4a /
K4b W8A8: miotts_tpu_torch/ops/csrc/qdot_gemv.cu) against their plain torch
versions.  Imports nothing of JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_qdot_variants_cuda.py

The `cuda`-marked tests skip without a GPU; the wrappers' input checks run
everywhere (they raise before any build or launch)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from miotts_tpu_torch.gguf import (GGML_Q4_0, GGML_Q4_K, GGML_Q6_K, GGML_Q8_0,
                                   quantize)
from miotts_tpu_torch.ops import qmat as tq

FORMATS = [(GGML_Q8_0, False), (GGML_Q6_K, False), (GGML_Q4_K, False),
           (GGML_Q4_K, True), (GGML_Q4_0, True)]
F32_TOL = 1e-5      # f32 output: summation order only
BF16_TOL = 1e-2     # bf16 output: one 2^-8 rounding on either side


def _qt(gtype, pack4, n, k, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    raw = np.frombuffer(quantize(w, gtype), dtype=np.uint8)
    return tq.qtensor_from_raw(raw, gtype, n, k, pack4=pack4)


def _rel_err(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _x(m, k, dtype, seed):
    """x on the card with an all-zero quant group (columns 32..63)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (m, k)).astype(np.float32))
    x[:, 32:64] = 0.0
    return x.to("cuda", dtype)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


WRAPPERS = {"split": tq._qdot_split_cuda, "group": tq._qdot_group_cuda,
            "w8a8": tq._qdot_w8a8_cuda}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_reject_cpu_tensors(name):
    """No wrapper falls back: a tensor that is not on the GPU is refused."""
    qt = _qt(GGML_Q4_K, True, 64, 256)
    x = torch.zeros((1, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="GPU"):
        WRAPPERS[name](x, qt)


@pytest.mark.parametrize("name,bad,err", [
    ("split", "unpacked", ValueError), ("split", "dtype", TypeError),
    ("split", "group", ValueError), ("split", "k", ValueError),
    ("group", "f32", TypeError), ("group", "m", ValueError),
    ("group", "group", ValueError), ("group", "dtype", TypeError),
    ("w8a8", "m", ValueError), ("w8a8", "dtype", TypeError),
    ("w8a8", "group", ValueError), ("w8a8", "values", TypeError),
])
def test_wrappers_reject_bad_inputs(name, bad, err):
    """Wrong dtype, group, M, packing or K raise before any launch."""
    qt = _qt(GGML_Q4_K, True, 64, 256)
    x = torch.zeros((1, 256), dtype=torch.bfloat16)
    if bad == "unpacked":
        qt = _qt(GGML_Q4_K, False, 64, 256)
    elif bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "f32":
        x = x.float()
    elif bad == "group":
        qt = dataclasses.replace(qt, group=64)
    elif bad == "k":
        x = torch.zeros((1, 128), dtype=torch.bfloat16)
    elif bad == "m":
        x = torch.zeros((2, 256), dtype=torch.bfloat16)
    elif bad == "values":
        qt = dataclasses.replace(qt, values=qt.values.to(torch.int8))
    with pytest.raises(err):
        WRAPPERS[name](x, qt)


def _check(fn, plain, x, qt, counter, tol):
    obj, attr = counter
    before = getattr(obj, attr)
    got = fn(x, qt)
    torch.cuda.synchronize()
    assert getattr(obj, attr) == before + 1
    want = plain(x, qt)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = _rel_err(got, want)
    assert err < tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("gtype", [GGML_Q4_K, GGML_Q4_0])
def test_split_kernel_matches_plain_on_gpu(gtype):
    """K2 vs its plain version at the decode (M=1), ragged (7) and prefill
    (64) forms with a ragged N (1000); f32 also against K1's plain version."""
    _need_gpu()
    qt = _qt(gtype, True, 1000, 1024).to("cuda")
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for m in (1, 7, 64):
            x = _x(m, 1024, dtype, seed=m)
            _check(tq.qdot_split, tq.qdot_split_plain, x, qt,
                   (tq.qdot_split, "kernel_launches"), tol)
            if dtype == torch.float32:
                assert _rel_err(tq.qdot_split(x, qt),
                                tq.qdot_plain(x, qt)) < F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("gtype,pack4", FORMATS)
def test_group_kernel_matches_plain_on_gpu(gtype, pack4):
    _need_gpu()
    qt = _qt(gtype, pack4, 1000, 1024).to("cuda")
    x = _x(1, 1024, torch.bfloat16, seed=5)
    _check(tq.qdot_group, tq.qdot_group_plain, x, qt,
           (tq.qdot_group, "kernel_launches"), BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("gtype,pack4", FORMATS)
def test_w8a8_kernel_matches_plain_on_gpu(gtype, pack4):
    """K4a (int8 values) / K4b (packed): f32 within 1e-5 (the same integer
    quantization, so the int32 partials are exact), bf16 within 1e-2."""
    _need_gpu()
    qt = _qt(gtype, pack4, 1000, 1024).to("cuda")
    counter = (tq.qdot_w8a8, "packed_launches" if pack4 else "kernel_launches")
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        x = _x(1, 1024, dtype, seed=6)
        _check(tq.qdot_w8a8, tq.qdot_w8a8_plain, x, qt, counter, tol)


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
def test_kernels_at_2p6b_q4_k_m_shapes():
    """Every kernel at the 2.6B-Q4_K_M decode shapes: fused QKV (Q4_K + Q6_K
    -> int8 g16 with mins), wo / gate-up / output (packed Q4_K, N = 13059
    not a multiple of 32), w_down (Q6_K, K = 8192)."""
    _need_gpu()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    wqkv = tq.concat_qtensors([_rand_qt(2560, 2560, "q4_k", gen),
                               _rand_qt(2560, 640, "q4_k", gen),
                               _rand_qt(2560, 640, "q6_k", gen)])
    assert not wqkv.packed and wqkv.group == 16 and wqkv.mins is not None
    cases = [wqkv, _rand_qt(2560, 2560, "q4_k", gen),
             _rand_qt(2560, 16384, "q4_k", gen),
             _rand_qt(8192, 2560, "q6_k", gen),
             _rand_qt(2560, 13059, "q4_k", gen)]
    for qt in cases:
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            x = _x(1, qt.k, dtype, seed=7)
            counter = (tq.qdot_w8a8, "packed_launches" if qt.packed
                       else "kernel_launches")
            _check(tq.qdot_w8a8, tq.qdot_w8a8_plain, x, qt, counter, tol)
            if dtype == torch.bfloat16:
                _check(tq.qdot_group, tq.qdot_group_plain, x, qt,
                       (tq.qdot_group, "kernel_launches"), tol)
            if qt.packed:
                for m in (1, 64):
                    xm = _x(m, qt.k, dtype, seed=m)
                    _check(tq.qdot_split, tq.qdot_split_plain, xm, qt,
                           (tq.qdot_split, "kernel_launches"), tol)


@pytest.mark.cuda
def test_group_kernel_large_k_on_gpu():
    """K = 16384: K3 stages x above 48 KB of shared memory."""
    _need_gpu()
    qt = _qt(GGML_Q8_0, False, 256, 16384).to("cuda")
    x = _x(1, 16384, torch.bfloat16, seed=8)
    _check(tq.qdot_group, tq.qdot_group_plain, x, qt,
           (tq.qdot_group, "kernel_launches"), BF16_TOL)
    _check(tq.qdot_w8a8, tq.qdot_w8a8_plain, x, qt,
           (tq.qdot_w8a8, "kernel_launches"), BF16_TOL)


@pytest.mark.cuda
def test_route_reaches_the_kernels_on_gpu():
    """qdot under each route counts a launch of the routed kernel only."""
    _need_gpu()
    q4 = _qt(GGML_Q4_K, True, 512, 1024).to("cuda")
    q8 = _qt(GGML_Q8_0, False, 512, 1024).to("cuda")
    x1 = _x(1, 1024, torch.bfloat16, seed=9)
    x7 = _x(7, 1024, torch.bfloat16, seed=10)
    counters = [(tq.qdot, "kernel_launches"),
                (tq.qdot_split, "kernel_launches"),
                (tq.qdot_group, "kernel_launches"),
                (tq.qdot_w8a8, "kernel_launches"),
                (tq.qdot_w8a8, "packed_launches")]
    cases = [  # route, weight, x, index of the counter that moves
        (tq.QdotRoute(), q4, x1, 0),
        (tq.QdotRoute(split=True), q4, x7, 1),
        (tq.QdotRoute(split=True), q8, x1, 0),
        (tq.QdotRoute(gemv="groupdot"), q8, x1, 2),
        (tq.QdotRoute(gemv="groupdot"), q8, x1.float(), 0),
        (tq.QdotRoute(gemv="w8a8"), q8, x1, 3),
        (tq.QdotRoute(gemv="w8a8"), q4, x1, 4),
        (tq.QdotRoute(gemv="w8a8"), q4, x7, 0),
        (tq.QdotRoute(gemv="w8a8", m8=True), q8, x1, 0),
    ]
    for route, qt, x, moved in cases:
        before = [getattr(o, a) for o, a in counters]
        y = tq.qdot(x, tq.with_route(qt, route))
        torch.cuda.synchronize()
        after = [getattr(o, a) for o, a in counters]
        assert y.shape == (x.shape[0], 512)
        assert [a - b for a, b in zip(after, before)] == [
            int(i == moved) for i in range(len(counters))], route
