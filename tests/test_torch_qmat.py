"""miotts_tpu_torch.ops.qmat against miotts_tpu.ops.qmat: the repacked
planar layout, the plain dequant-matmul, mixed-format fusion, and the
CPU / CUDA dispatch of `qdot`."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from miotts_tpu.gguf import (GGML_Q4_0, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K,
                             GGML_Q8_0)
from miotts_tpu.gguf.quants import quantize
from miotts_tpu.ops import qmat as jq
from miotts_tpu_torch.ops import qmat as tq
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

N, K = 200, 512          # N not a multiple of 128: exercises the JAX lane pad


def _raw(gtype, n, k, seed):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return np.frombuffer(quantize(w, gtype), dtype=np.uint8)


def _pair(gtype, pack4, n=N, k=K, seed=0):
    raw = _raw(gtype, n, k, seed)
    return (jq.qtensor_from_raw(raw, gtype, n, k, pack4=pack4),
            tq.qtensor_from_raw(raw, gtype, n, k, pack4=pack4))


@pytest.mark.parametrize("gtype,pack4", [
    (GGML_Q8_0, False), (GGML_Q6_K, False), (GGML_Q5_K, False),
    (GGML_Q4_0, False), (GGML_Q4_0, True), (GGML_Q4_K, False),
    (GGML_Q4_K, True),
])
def test_qtensor_from_raw_bit_identical(gtype, pack4):
    """Same GGUF bytes -> the same planar values / scales / mins, bit for
    bit (the port drops only the TPU's 128-lane padding)."""
    jt, pt = _pair(gtype, pack4)
    assert (pt.group, pt.packed, pt.shape) == (jt.group, jt.packed, jt.shape)
    n = jt.shape[0]
    np.testing.assert_array_equal(pt.values.numpy(),
                                  np.asarray(jt.values)[:, :n])
    np.testing.assert_array_equal(pt.scales.numpy(),
                                  np.asarray(jt.scales)[:, :n])
    if jt.mins is None:
        assert pt.mins is None
    else:
        np.testing.assert_array_equal(pt.mins.numpy(),
                                      np.asarray(jt.mins)[:, :n])


def test_qtensor_from_raw_packs_4bit_by_default():
    for gtype, packed in ((GGML_Q4_K, True), (GGML_Q4_0, True),
                          (GGML_Q8_0, False), (GGML_Q6_K, False)):
        jt, pt = _pair(gtype, None)
        assert pt.packed == jt.packed == packed
        np.testing.assert_array_equal(pt.dequant().numpy(),
                                      np.asarray(jt.dequant()))


@pytest.mark.parametrize("gtype,pack4", [
    (GGML_Q8_0, False), (GGML_Q6_K, False), (GGML_Q4_K, True),
    (GGML_Q4_0, True),
])
def test_qdot_plain_matches_pallas_and_xla(gtype, pack4):
    """f32: qdot_plain == _qdot_pallas (interpret mode) == _qdot_xla within
    1e-5 of the output scale at every M — the three differ only in the
    order of their f32 sums (the Pallas kernel subtracts the mins term
    after its dot, the plain version folds it into the dequant)."""
    jt, pt = _pair(gtype, pack4, n=256)
    rng = np.random.default_rng(1)
    for m in (1, 2, 5, 7, 9, 64):
        x = rng.standard_normal((m, K)).astype(np.float32)
        got = tq.qdot_plain(torch.from_numpy(x), pt).numpy()
        want_p = np.asarray(jq._qdot_pallas(jnp.asarray(x), jt, interpret=True))
        want_x = np.asarray(jq._qdot_xla(jnp.asarray(x), jt))
        assert got.shape == (m, 256)
        assert rel_err(got, want_p) < 1e-5, (m, rel_err(got, want_p))
        assert rel_err(got, want_x) < 1e-5, (m, rel_err(got, want_x))


def test_qdot_plain_bf16_rounds_output_once():
    """bf16 x: f32 dequant and f32 sums, one rounding of the output (the
    TPU kernel's bf16_dot=False path), so it equals the f32 product of the
    same bf16-valued x rounded to bf16."""
    _, pt = _pair(GGML_Q8_0, False)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, K)).astype(np.float32)).to(torch.bfloat16)
    got = tq.qdot_plain(x, pt)
    assert got.dtype == torch.bfloat16
    want = (x.float() @ pt.dequant_t()).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_concat_qtensors_mixed_formats():
    """Q4_K (packed) + Q6_K + Q8_0 fuse to one unpacked g=16 tensor with
    zero mins for the symmetric siblings; the dequantized weight equals the
    JAX fusion and the row-stack of the parts, bit for bit."""
    parts = [(GGML_Q4_K, 96, 3), (GGML_Q6_K, 64, 4), (GGML_Q8_0, 40, 5)]
    jts, pts = [], []
    for gtype, n, seed in parts:
        jt, pt = _pair(gtype, None, n=n, seed=seed)
        jts.append(jt)
        pts.append(pt)
    jf, pf = jq.concat_qtensors(jts), tq.concat_qtensors(pts)
    assert (pf.group, pf.packed, pf.shape) == (16, False, (200, K))
    assert pf.mins is not None
    n = jf.n_out
    for a, b in ((pf.values, jf.values), (pf.scales, jf.scales),
                 (pf.mins, jf.mins)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:, :n])
    want = np.concatenate([p.dequant().numpy() for p in pts], axis=0)
    np.testing.assert_array_equal(pf.dequant().numpy(), want)
    np.testing.assert_array_equal(pf.dequant().numpy(),
                                  np.asarray(jf.dequant()))


def test_concat_qtensors_packed_siblings_stay_packed():
    jts, pts = zip(*[_pair(g, True, n=n, seed=s)
                     for g, n, s in ((GGML_Q4_K, 64, 6), (GGML_Q4_0, 72, 7))])
    jf, pf = jq.concat_qtensors(list(jts)), tq.concat_qtensors(list(pts))
    assert pf.packed and jf.packed and pf.group == 32
    np.testing.assert_array_equal(pf.values.numpy(),
                                  np.asarray(jf.values)[:, :jf.n_out])
    np.testing.assert_array_equal(pf.dequant().numpy(),
                                  np.asarray(jf.dequant()))


def test_qdot_cpu_tensor_takes_plain_path():
    """A CPU tensor goes through qdot_plain (leading dims kept) and never
    counts a kernel launch."""
    _, pt = _pair(GGML_Q4_K, True)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 3, K)).astype(np.float32))
    before = tq.qdot.kernel_launches
    y = tq.qdot(x, pt)
    assert y.shape == (2, 3, N)
    assert torch.equal(y.reshape(6, N), tq.qdot_plain(x.reshape(6, K), pt))
    assert tq.qdot.kernel_launches == before


def test_pack4_folds_centred_values_into_mins():
    """Q4_0's centred values become biased nibbles with 8*s in mins; the
    dequantized weight is unchanged."""
    _, pt = _pair(GGML_Q4_0, False)
    packed = pt.pack4()
    assert packed.packed and packed.values.dtype == torch.uint8
    torch.testing.assert_close(packed.mins, pt.scales * 8.0, rtol=0, atol=0)
    torch.testing.assert_close(packed.dequant(), pt.dequant(), rtol=0,
                               atol=1e-6)
