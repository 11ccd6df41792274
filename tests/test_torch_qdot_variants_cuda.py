"""The single-stream quantized-matmul kernels (K2 split, K3 group-dot, K4a /
K4b W8A8: miotts_tpu_torch/ops/csrc/qdot_gemv.cu; at M = 1 all on the
split-K GEMV of qdot_gemv.cuh) against their plain torch versions.  Imports nothing of JAX, so it runs on a GPU machine without it:

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


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 7, 16, 17, 64, 65])
def test_split_kernel_is_k1_tile_at_m_gt_1_on_gpu(m):
    """K2 at M > 1 runs K1's tile under the same plan: the same bits as
    `_qdot_cuda` on the same packed weight, f32 and bf16 x, at K = 8192
    (split over blocks) and at the head's N = 13059."""
    _need_gpu()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(m)
    for k, n in ((8192, 640), (2560, 13059)):
        qt = _rand_qt(k, n, "q4_k", gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = _x(m, k, dtype, seed=m)
            before = tq.qdot_split.kernel_launches
            got = tq.qdot_split(x, qt)
            assert tq.qdot_split.kernel_launches == before + 1
            assert torch.equal(got, tq._qdot_cuda(x, qt)), (m, k, n, dtype)


# phase 14's linears (K, N, format) of the 2.6B-Q4_K_M, 0.1B and LFM2 models
GEMV_SHAPES = [(2560, 2560, "q4_k"), (2560, 16384, "q4_k"),
               (2560, 13059, "q4_k"), (8192, 2560, "q6_k"),
               (768, 1280, "q8_0"), (768, 768, "q8_0"), (768, 4096, "q8_0"),
               (2048, 768, "q8_0"), (768, 13059, "q8_0"),
               (2048, 6144, "q8_0"), (2048, 2048, "q8_0"),
               (2048, 3072, "q8_0"), (2048, 16384, "q8_0"),
               (8192, 2048, "q8_0"), (2048, 13059, "q8_0"),
               (8192, 640, "q4_k")]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,fmt", GEMV_SHAPES)
def test_gemv_matches_plain_at_path_shapes_on_gpu(k, n, fmt):
    """The split-K GEMV (K2 at M = 1 for packed weights, K3 for all) against
    the plain versions at every phase 14 shape (K = 8192, N = 13059
    included): f32 within 1e-5, bf16 within 1e-2; one launch per call, and a
    second call gives the same bits."""
    _need_gpu()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(k + n)
    qt = _rand_qt(k, n, fmt, gen)
    runs = [(tq.qdot_group, tq.qdot_group_plain, torch.bfloat16, BF16_TOL)]
    if qt.packed:
        runs += [(tq.qdot_split, tq.qdot_split_plain, dt, tol)
                 for dt, tol in ((torch.float32, F32_TOL),
                                 (torch.bfloat16, BF16_TOL))]
    for fn, plain, dtype, tol in runs:
        x = _x(1, k, dtype, seed=n)
        _check(fn, plain, x, qt, (fn, "kernel_launches"), tol)
        assert torch.equal(fn(x, qt), fn(x, qt))


@pytest.mark.cuda
def test_gemv_takes_any_plan_and_unaligned_rows_on_gpu():
    """The GEMV under other split counts than its plan's (1 to 8, a ragged
    last split), and with x, v and s not 16-byte aligned (views one row and
    one column in), stays within the plain version's bounds."""
    _need_gpu()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    qt = _rand_qt(2560, 1040, "q4_k", gen)
    x = _x(1, 2560, torch.float32, seed=12)
    want = tq.qdot_split_plain(x, qt)
    for splits in range(1, 9):
        per = -(-(2560 // 32) // splits)
        plan = tq.GemvPlan(splits=-(-(2560 // 32) // per), k_split=per * 32)
        assert _rel_err(tq._qdot_split_cuda(x, qt, plan), want) < F32_TOL
    # N = 1039 rows (not 16-byte multiples), x one element in
    odd = tq.QTensor(values=qt.values[:, 1:].contiguous(),
                     scales=qt.scales[:, 1:].contiguous(),
                     mins=qt.mins[:, 1:].contiguous(), group=32, n_out=1039,
                     packed=True)
    xb = torch.zeros((1, 2561), device="cuda", dtype=torch.bfloat16)
    xb[:, 1:] = x.to(torch.bfloat16)
    xo = xb[:, 1:]
    assert xo.data_ptr() % 16 and xo.is_contiguous()
    for fn, plain in ((tq.qdot_split, tq.qdot_split_plain),
                      (tq.qdot_group, tq.qdot_group_plain)):
        assert _rel_err(fn(xo, odd), plain(xo, odd)) < BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,fmt", GEMV_SHAPES)
def test_w8a8_gemv_matches_plain_at_path_shapes_on_gpu(k, n, fmt):
    """K4a (int8 values) / K4b (packed) on the GEMV's integer-partial form at
    every phase 14 shape (K = 8192, N = 13059 included) against
    `qdot_w8a8_plain`: f32 within 1e-5, bf16 within 1e-2; one launch per
    call on the kernel's own count, and a second call gives the same
    bits."""
    _need_gpu()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(k + n + 1)
    qt = _rand_qt(k, n, fmt, gen)
    counter = (tq.qdot_w8a8, "packed_launches" if qt.packed
               else "kernel_launches")
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        x = _x(1, k, dtype, seed=n + 1)
        _check(tq.qdot_w8a8, tq.qdot_w8a8_plain, x, qt, counter, tol)
        assert torch.equal(tq.qdot_w8a8(x, qt), tq.qdot_w8a8(x, qt))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["q4_k", "q6_k", "q8_0"])
def test_w8a8_takes_any_plan_and_unaligned_rows_on_gpu(fmt):
    """K4 under explicit plans of 1 to 8 splits at K = 8192 (a ragged last
    split included) within 1e-5 of the plain version at f32 x, each plan's
    repeat bit for bit; and on rows that are not 16-byte aligned (N = 1039:
    a view one column in; the head's N = 13059) with x one element in, at
    bf16 x within 1e-2."""
    _need_gpu()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    qt = _rand_qt(8192, 1040, fmt, gen)
    g = qt.group
    x = _x(1, 8192, torch.float32, seed=14)
    want = tq.qdot_w8a8_plain(x, qt)
    for splits in range(1, 9):
        per = -(-(8192 // g) // splits)
        plan = tq.GemvPlan(splits=-(-(8192 // g) // per), k_split=per * g)
        got = tq._qdot_w8a8_cuda(x, qt, plan)
        assert _rel_err(got, want) < F32_TOL, (splits, _rel_err(got, want))
        assert torch.equal(got, tq._qdot_w8a8_cuda(x, qt, plan)), splits
    cut = lambda t: None if t is None else t[:, 1:].contiguous()
    rows = 8192 // 2 if qt.packed else 8192
    odd = tq.QTensor(values=cut(qt.values), scales=cut(qt.scales),
                     mins=cut(qt.mins), group=g, n_out=1039,
                     packed=qt.packed)
    assert odd.values.shape == (rows, 1039)
    head = _rand_qt(2560, 13059, fmt, gen)
    for w, k in ((odd, 8192), (head, 2560)):
        xb = torch.zeros((1, k + 1), device="cuda", dtype=torch.bfloat16)
        xb[:, 1:] = _x(1, k, torch.bfloat16, seed=k)
        xo = xb[:, 1:]
        assert xo.data_ptr() % 16 and xo.is_contiguous()
        err = _rel_err(tq.qdot_w8a8(xo, w), tq.qdot_w8a8_plain(xo, w))
        assert err < BF16_TOL, (k, err)
