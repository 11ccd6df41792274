"""The `qdot` CUDA kernel (miotts_tpu_torch/ops/csrc/qdot.cu) against its
plain torch version.  Imports nothing of JAX, so it runs on a GPU machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_qdot_cuda.py

The `cuda`-marked tests skip without a GPU; the wrapper's input checks run
everywhere (they raise before any build or launch)."""

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
    """[B, S, K] input and K = 16384 (shared memory above 48 KB for the
    GEMV's staged x)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    qt = _qt(GGML_Q8_0, False, 256, 16384).to("cuda")
    x = torch.randn((2, 1, 16384), device="cuda")
    got = tq.qdot(x, qt)
    want = tq.qdot_plain(x.reshape(2, -1), qt).reshape(2, 1, 256)
    assert _rel_err(got.cpu(), want.cpu()) < 1e-5
    x1 = torch.randn((1, 16384), device="cuda")
    assert _rel_err(tq.qdot(x1, qt).cpu(), tq.qdot_plain(x1, qt).cpu()) < 1e-5
