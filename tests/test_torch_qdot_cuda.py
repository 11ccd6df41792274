"""The `qdot` CUDA kernel (miotts_tpu_torch/ops/csrc/qdot.cu) against its
plain torch version.  Imports nothing of JAX, so it runs on a GPU machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_qdot_cuda.py

The `cuda`-marked tests skip without a GPU; the wrapper's input checks run
everywhere (they raise before any build or launch)."""

import dataclasses

import numpy as np
import pytest
import torch

from miotts_tpu_torch.gguf import (GGML_Q4_0, GGML_Q4_K, GGML_Q6_K, GGML_Q8_0,
                                   quantize)
from miotts_tpu_torch.ops import qmat as tq


def _qt(gtype, pack4, n, k, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    raw = np.frombuffer(quantize(w, gtype), dtype=np.uint8)
    return tq.qtensor_from_raw(raw, gtype, n, k, pack4=pack4)


def _rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def test_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never falls back: a tensor that is not on the GPU
    is refused."""
    qt = _qt(GGML_Q8_0, False, 64, 256)
    with pytest.raises(ValueError, match="GPU"):
        tq._qdot_cuda(torch.zeros((1, 256)), qt)


@pytest.mark.parametrize("bad", ["dtype", "k", "values"])
def test_wrapper_rejects_bad_inputs(bad):
    qt = _qt(GGML_Q6_K, False, 64, 256)
    x = torch.zeros((2, 256))
    if bad == "dtype":
        x, err = x.to(torch.float16), TypeError
    elif bad == "k":
        x, err = torch.zeros((2, 128)), ValueError
    else:
        qt = tq.QTensor(values=qt.values.to(torch.uint8), scales=qt.scales,
                        mins=None, group=qt.group, n_out=qt.n_out)
        err = TypeError
    with pytest.raises(err):
        tq._qdot_cuda(x, qt)


@pytest.mark.cuda
@pytest.mark.parametrize("gtype,pack4", [
    (GGML_Q8_0, False), (GGML_Q6_K, False), (GGML_Q4_K, True),
    (GGML_Q4_K, False), (GGML_Q4_0, True),
])
def test_qdot_kernel_matches_plain_on_gpu(gtype, pack4):
    """Kernel vs qdot_plain on the card for f32 and bf16 x at the decode
    (M=1), ragged (7) and prefill (64) forms, with a ragged N (1000).
    Tolerance: f32 within 1e-5 of the output scale (summation order only);
    bf16 within 1e-2 (one 2^-8 rounding of the output on either side)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    qt = _qt(gtype, pack4, 1000, 1024).to("cuda")
    rng = np.random.default_rng(4)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for m in (1, 7, 64):
            x = torch.from_numpy(rng.standard_normal((m, 1024)).astype(
                np.float32)).to("cuda", dtype)
            before = tq.qdot.kernel_launches
            got = tq.qdot(x, qt)
            torch.cuda.synchronize()
            assert tq.qdot.kernel_launches == before + 1
            assert got.dtype == dtype and got.shape == (m, 1000)
            want = tq.qdot_plain(x, qt)
            assert _rel_err(got.float().cpu(), want.float().cpu()) < tol


@pytest.mark.cuda
def test_qdot_kernel_leading_dims_and_large_k_on_gpu():
    """[B, S, K] input and K = 16384 (the GEMV's K split over a cluster of
    whole quant groups)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    qt = _qt(GGML_Q8_0, False, 256, 16384).to("cuda")
    x = torch.randn((2, 1, 16384), device="cuda")
    got = tq.qdot(x, qt)
    want = tq.qdot_plain(x.reshape(2, -1), qt).reshape(2, 1, 256)
    assert _rel_err(got.cpu(), want.cpu()) < 1e-5
    x1 = torch.randn((1, 16384), device="cuda")
    assert _rel_err(tq.qdot(x1, qt).cpu(), tq.qdot_plain(x1, qt).cpu()) < 1e-5


# ---------------------------------------------------------------------------
# The M > 1 tile (ops/csrc/qdot_tile.cuh): tensor cores, cp.async ring,
# deterministic split-K
# ---------------------------------------------------------------------------

TILE_FORMATS = ("q8_0", "q6_k", "q4_k", "q4_k_packed", "q4_0_packed")
TILE_MS = (2, 8, 16, 17, 64, 65)


def _rand_qt(k, n, fmt, seed):
    """A QTensor of GGUF format `fmt`'s planar layout, random on the card
    (values in the format's range, scales ~1 / sqrt(K))."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    base = fmt.split("_packed")[0]
    group = 16 if base == "q6_k" else 32
    lo, hi = {"q8_0": (-127, 128), "q6_k": (-32, 32), "q4_k": (0, 16),
              "q4_0": (-8, 8)}[base]
    vals = torch.randint(lo, hi, (k, n), generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.int8)
    scales = (torch.rand((k // group, n), generator=gen, device="cuda")
              + 0.5) / (hi * k ** 0.5)
    mins = None
    if base == "q4_k":
        mins = torch.rand((k // group, n), generator=gen, device="cuda") \
            * (8.0 / (hi * k ** 0.5))
    qt = tq.QTensor(values=vals, scales=scales, mins=mins, group=group,
                    n_out=n)
    return qt.pack4() if fmt.endswith("_packed") else qt


def _x_gpu(m, k, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    return torch.from_numpy(x).to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", TILE_FORMATS)
def test_qdot_tile_matches_plain_at_long_k_on_gpu(fmt):
    """The tile at M = 2, 8, 16, 17, 64, 65 (both tile heights, ragged M),
    K = 8192 (the sums the tensor cores' truncation would drift over) and a
    ragged N (1000): f32 x within 1e-5 of the output scale, bf16 within
    1e-2; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    qt = _rand_qt(8192, 1000, fmt, seed=len(fmt))
    for m in TILE_MS:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            x = _x_gpu(m, 8192, dtype, seed=m)
            before = tq.qdot.kernel_launches
            got = tq.qdot(x, qt)
            torch.cuda.synchronize()
            assert tq.qdot.kernel_launches == before + 1
            assert got.dtype == dtype and got.shape == (m, 1000)
            err = _rel_err(got.float().cpu(), tq.qdot_plain(x, qt).float().cpu())
            assert err < tol, (fmt, m, dtype, err)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ("q8_0", "q4_k_packed"))
def test_qdot_tile_at_the_head_width_on_gpu(fmt):
    """The output head's N = 13059 (odd: no weight row is 16-byte aligned)
    at M = 16 and 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    qt = _rand_qt(2048, 13059, fmt, seed=3)
    for m in (16, 64):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            x = _x_gpu(m, 2048, dtype, seed=m + 1)
            got = tq.qdot(x, qt)
            err = _rel_err(got.float().cpu(), tq.qdot_plain(x, qt).float().cpu())
            assert err < tol, (fmt, m, dtype, err)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(16, 2048, 2048), (64, 8192, 2560),
                                   (7, 2560, 3840)])
def test_qdot_tile_split_k_is_deterministic_on_gpu(m, k, n):
    """Shapes whose plan splits K over blocks: two calls give the same bits
    (the last block of a tile sums the splits in split order), and each is
    one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    assert tq._tile_plan(m, k, n, 32).splits > 1
    qt = _rand_qt(k, n, "q8_0", seed=k)
    for dtype in (torch.float32, torch.bfloat16):
        x = _x_gpu(m, k, dtype, seed=n)
        before = tq.qdot.kernel_launches
        a = tq.qdot(x, qt)
        b = tq.qdot(x, qt)
        torch.cuda.synchronize()
        assert tq.qdot.kernel_launches == before + 2
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bm", [16, 64])
def test_qdot_tile_either_height_and_any_split_on_gpu(bm):
    """Plans the plan function does not pick at this shape: either tile
    height at M = 65 (ragged), K unsplit, in 4 parts or one stage a split.
    f32 x within 1e-5, bf16 within 1e-2, and a repeat bit for bit equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    k, n = 2560, 1000
    qt = _rand_qt(k, n, "q4_k_packed", seed=bm)
    base = tq._plan_for(bm, 65, k, n, qt.group)
    steps = k // tq.TILE_BK
    for splits in (1, 4, steps):
        per = -(-steps // splits)
        plan = dataclasses.replace(base, splits=-(-steps // per),
                                   k_split=per * tq.TILE_BK)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            x = _x_gpu(65, k, dtype, seed=splits)
            got = tq._qdot_cuda(x, qt, plan)
            assert torch.equal(got, tq._qdot_cuda(x, qt, plan))
            err = _rel_err(got.float().cpu(), tq.qdot_plain(x, qt).float().cpu())
            assert err < tol, (bm, splits, dtype, err)


# ---------------------------------------------------------------------------
# K1 at M = 1: the split-K GEMV of ops/csrc/qdot_gemv.cuh, shared with K1v,
# K2 and K3
# ---------------------------------------------------------------------------

# chip_smoke.py phase 2's and 17's linears (K, N, format): the 0.1B-Q8_0 and
# LFM2-1.2B-Q8_0 models, the 2.6B-Q4_K_M mix (fused QKV q4_k + q6_k: int8
# g16 with mins), the output heads (N = 13059: no row 16-byte aligned)
GEMV_SHAPES = [(768, 1280, "q8_0"), (768, 768, "q8_0"), (768, 4096, "q8_0"),
               (2048, 768, "q8_0"), (768, 13059, "q8_0"),
               (2560, 3840, "q4_k+q6_k"), (2560, 16384, "q4_k_packed"),
               (8192, 2560, "q6_k"), (2560, 2560, "q4_0_packed"),
               (2560, 2560, "q4_k_packed"), (2560, 13059, "q4_k_packed"),
               (2048, 6144, "q8_0"), (2048, 2048, "q8_0"),
               (2048, 3072, "q8_0"), (2048, 16384, "q8_0"),
               (8192, 2048, "q8_0"), (2048, 13059, "q8_0")]


def _path_qt(k, n, fmt, seed):
    if fmt == "q4_k+q6_k":       # the 2.6B fused QKV: q, k in Q4_K, v in Q6_K
        return tq.concat_qtensors([
            _rand_qt(k, n - 1280, "q4_k", seed), _rand_qt(k, 640, "q4_k", seed + 1),
            _rand_qt(k, 640, "q6_k", seed + 2)])
    return _rand_qt(k, n, fmt, seed)


def _zero_group_x(k, dtype, seed):
    """x [1, k] on the card with an all-zero quant group (columns 32..63)."""
    x = _x_gpu(1, k, torch.float32, seed)
    x[:, 32:64] = 0.0
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,fmt", GEMV_SHAPES)
def test_qdot_gemv_matches_plain_at_path_shapes_on_gpu(k, n, fmt):
    """K1 at M = 1 against `qdot_plain` at every phase 2 / 17 shape: f32 x
    within 1e-5 of the output scale, bf16 x within 1e-2; one launch a call,
    and a second call gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    qt = _path_qt(k, n, fmt, seed=k + n)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        x = _zero_group_x(k, dtype, seed=n)
        before = tq.qdot.kernel_launches
        got = tq.qdot(x, qt)
        torch.cuda.synchronize()
        assert tq.qdot.kernel_launches == before + 1
        assert got.dtype == dtype and got.shape == (1, n)
        err = _rel_err(got.float().cpu(), tq.qdot_plain(x, qt).float().cpu())
        assert err < tol, (k, n, fmt, dtype, err)
        assert torch.equal(tq.qdot(x, qt), got)


# the 2.6B-Q4_K_M linears a speculative verify runs at M = k + 1 (chip_smoke
# phase 21 a: k = 1, 3, 6)
VERIFY_SHAPES = [(2560, 3840, "q4_k+q6_k"), (2560, 2560, "q4_k_packed"),
                 (2560, 16384, "q4_k_packed"), (8192, 2560, "q6_k"),
                 (2560, 13059, "q4_k_packed")]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,fmt", VERIFY_SHAPES)
def test_qdot_tile_at_the_verify_shapes_on_gpu(k, n, fmt):
    """K1's tile at M = 2, 4, 7 on the speculative verify's 2.6B linears:
    f32 x within 1e-5 of the output scale, bf16 x within 1e-2; one launch a
    call, and a second call gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    qt = _path_qt(k, n, fmt, seed=k + n + 1)
    for m in (2, 4, 7):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            x = _x_gpu(m, k, dtype, seed=m + n)
            before = tq.qdot.kernel_launches
            got = tq.qdot(x, qt)
            torch.cuda.synchronize()
            assert tq.qdot.kernel_launches == before + 1
            assert got.dtype == dtype and got.shape == (m, n)
            err = _rel_err(got.float().cpu(),
                           tq.qdot_plain(x, qt).float().cpu())
            assert err < tol, (k, n, fmt, m, dtype, err)
            assert torch.equal(tq.qdot(x, qt), got)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,fmt", GEMV_SHAPES)
def test_qdot_gemv_is_k3_and_k2_bit_for_bit_on_gpu(k, n, fmt):
    """On one plan K1 at M = 1 launches K3's GEMV for bf16 x (int8 and
    packed values) and K2's for f32 x on packed values: the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    qt = _path_qt(k, n, fmt, seed=k + n)
    plan = tq._gemv_plan(k, n, qt.group, tq._sm_count(torch.device("cuda")))
    xb = _zero_group_x(k, torch.bfloat16, seed=n + 1)
    assert torch.equal(tq._qdot_cuda(xb, qt, plan),
                       tq._qdot_group_cuda(xb, qt, plan)), (k, n, fmt)
    if qt.packed:
        for dtype in (torch.float32, torch.bfloat16):
            x = _zero_group_x(k, dtype, seed=n + 2)
            assert torch.equal(tq._qdot_cuda(x, qt, plan),
                               tq._qdot_split_cuda(x, qt, plan)), (k, n, fmt,
                                                                   dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["q8_0", "q6_k", "q4_k_packed"])
def test_qdot_gemv_takes_any_plan_and_unaligned_rows_on_gpu(fmt):
    """K1 at M = 1 under every split count from 1 to 8 (a ragged last split)
    stays within the plain version's bounds and repeats bit for bit; with
    x, v and s not 16-byte aligned (views one element and one column in,
    N = 1039) it still does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    k = 2560
    qt = _rand_qt(k, 1040, fmt, seed=len(fmt))
    groups = k // qt.group
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        x = _zero_group_x(k, dtype, seed=12)
        want = tq.qdot_plain(x, qt).float().cpu()
        for splits in range(1, 9):
            per = -(-groups // splits)
            plan = tq.GemvPlan(splits=-(-groups // per), k_split=per * qt.group)
            got = tq._qdot_cuda(x, qt, plan)
            assert _rel_err(got.float().cpu(), want) < tol, (fmt, splits)
            assert torch.equal(got, tq._qdot_cuda(x, qt, plan))
        odd = tq.QTensor(values=qt.values[:, 1:].contiguous(),
                         scales=qt.scales[:, 1:].contiguous(),
                         mins=None if qt.mins is None
                         else qt.mins[:, 1:].contiguous(),
                         group=qt.group, n_out=1039, packed=qt.packed)
        xp = torch.zeros((1, k + 1), device="cuda", dtype=dtype)
        xp[:, 1:] = x
        xo = xp[:, 1:]
        assert xo.data_ptr() % 16 and xo.is_contiguous()
        got = tq.qdot(xo, odd)
        err = _rel_err(got.float().cpu(), tq.qdot_plain(xo, odd).float().cpu())
        assert err < tol, (fmt, dtype, err)
