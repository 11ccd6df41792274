"""The bandwidth-floor probes K7 (miotts_tpu_torch.ops.decode_attn.
dma_floor_plain) and K8 (miotts_tpu_torch.ops.qmat.qdot_dma_floor_plain)
against the JAX probes they port, `miotts_tpu/ops/decode_attn.py:_dma_floor`
and `benchmarks/bench_qmat.py:dma_floor` (imported by path), run under
`pltpu.force_tpu_interpret_mode()` at small shapes of several tiles."""

import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from miotts_tpu.ops import decode_attn as jda
from miotts_tpu.ops import qmat as jq
from miotts_tpu_torch.ops import decode_attn as tda
from miotts_tpu_torch.ops import qmat as tq
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

TOL = 1e-6               # f32 sums in another order


@pytest.fixture(scope="module")
def bench_qmat():
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "bench_qmat.py"
    spec = importlib.util.spec_from_file_location("bench_qmat_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# K7: K5's k / v blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("B,H_kv,S,D", [
    (2, 2, 1536, 64),    # three 512-row tiles
    (1, 3, 1100, 80),    # two whole tiles, 76 trailing rows not read
    (3, 2, 200, 64),     # one tile of S rows
])
def test_attn_dma_floor_matches_jax(B, H_kv, S, D, dtype):
    rng = np.random.default_rng(S + D)
    if dtype == "int8":
        k = rng.integers(-127, 128, (B, H_kv, S, D)).astype(np.int8)
        v = rng.integers(-127, 128, (B, H_kv, S, D)).astype(np.int8)
        jk, jv = jnp.asarray(k), jnp.asarray(v)
    else:
        k = rng.standard_normal((B, H_kv, S, D)).astype(np.float32)
        v = rng.standard_normal((B, H_kv, S, D)).astype(np.float32)
        jk, jv = jnp.asarray(k, dtype), jnp.asarray(v, dtype)
        k, v = np.array(jk, np.float32), np.array(jv, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jda._dma_floor(jnp.zeros((B, 4 * H_kv, D)), jk, jv))
    tdt = getattr(torch, dtype)
    got = tda.dma_floor_plain(torch.from_numpy(k).to(tdt),
                              torch.from_numpy(v).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (B, H_kv, 8, D)
    assert rel_err(got.numpy(), want) < TOL
    assert torch.equal(tda.dma_floor(torch.from_numpy(k).to(tdt),
                                     torch.from_numpy(v).to(tdt)), got)


def test_attn_dma_floor_rejects_cpu_and_bad_rows():
    k = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="GPU"):
        tda._dma_floor_cuda(k, k)
    with pytest.raises(TypeError):
        tda._dma_floor_cuda(k, k.float())
    with pytest.raises(ValueError, match="16-byte"):
        tda._dma_floor_cuda(torch.zeros((1, 2, 64, 4), dtype=torch.bfloat16),
                            torch.zeros((1, 2, 64, 4), dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# K8: K1's value / scale blocks
# ---------------------------------------------------------------------------

def _q8(k, n, seed):
    """bench_qmat.make_qt's tensor (values 0..15 int8, g32, f32 scales and
    mins) on both sides."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 16, (k, n), dtype=np.int64).astype(np.int8)
    s = rng.random((k // 32, n), np.float32) * 0.02 + 0.01
    m = rng.random((k // 32, n), np.float32) * 0.01
    jt = jq.QTensor(values=jnp.asarray(v), scales=jnp.asarray(s),
                    mins=jnp.asarray(m), group=32, n_out=n)
    pt = tq.QTensor(values=torch.from_numpy(v), scales=torch.from_numpy(s),
                    mins=torch.from_numpy(m), group=32, n_out=n)
    return jt, pt


@pytest.mark.parametrize("K,N,tile_k", [
    (4096, 1024, 1024),   # TILE_N 512: four K tiles
    (2560, 768, 1280),    # TILE_N 256 (768 is not a multiple of 512)
    (8192, 512, 1024),    # eight K tiles
    (768, 256, 768),      # one K tile (the 0.1B hidden width)
])
def test_qdot_dma_floor_matches_jax(bench_qmat, K, N, tile_k):
    assert tq._k8_tile_k(K, N) == tile_k
    jt, pt = _q8(K, N, seed=K + N)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bench_qmat.dma_floor(None, jt))
    got = tq.qdot_dma_floor_plain(pt)
    assert got.dtype == torch.float32 and got.shape == (1, N)
    assert rel_err(got.numpy(), want) < TOL
    assert torch.equal(tq.qdot_dma_floor(pt), got)


def test_qdot_dma_floor_tile_rule_at_the_2p6b_shapes(bench_qmat):
    """bench_qmat.SHAPES, the 2.6B per-layer shapes the JAX probe runs."""
    assert [tq._k8_tile_k(k, n) for k, n in bench_qmat.SHAPES] == [
        1280, 1280, 1280, 1024]


def test_qdot_dma_floor_rejects_other_layouts():
    _, pt = _q8(512, 64, seed=1)
    for bad in (tq.QTensor(values=pt.values, scales=pt.scales.repeat(2, 1),
                           mins=None, group=16),
                pt.pack4(),
                tq.QTensor(values=pt.values[:128], scales=pt.scales[:4],
                           mins=None, group=32)):
        with pytest.raises(ValueError):
            tq._qdot_dma_floor_cuda(bad)
    with pytest.raises(ValueError, match="GPU"):
        tq._qdot_dma_floor_cuda(pt)
