"""The bandwidth-floor probes K7 (miotts_tpu_torch.ops.decode_attn.
dma_floor_plain) and K8 (miotts_tpu_torch.ops.qmat.qdot_dma_floor_plain)
against the JAX probes they port, `miotts_tpu/ops/decode_attn.py:_dma_floor`
and `benchmarks/bench_qmat.py:dma_floor` (imported by path), run under
`pltpu.force_tpu_interpret_mode()` at small shapes of several tiles; and
the kernels' decompositions (miotts_tpu_torch/ops/csrc/dma_floor.cu)
emulated in torch against both.

K7's kernel splits the n_s * s_tile rows it reads over a cluster of R
blocks in contiguous shares (K5's rule, read from the source), and rank 0
reads the 8 * n_s output rows itself and sums them from 0 in t order: bit
for bit the plain version.  K8's kernel splits K over `splits` blocks of
k_split rows (K1's GEMV plan); each sums the output rows t * TILE_K of its
slice in t order, and rank 0 sums the partials in rank order: within 1e-6
of the output scale of both (f32 sums in another order)."""

import functools
import importlib.util
import re
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
CSRC = Path(tda.__file__).resolve().parent / "csrc"
SMS = 132                # an H100 SXM


def _src(name: str) -> str:
    return (CSRC / name).read_text()


def _const(name: str, src: str = "dma_floor.cu") -> int:
    m = re.search(rf"constexpr int {name} = (\d+)( \* 1024)?;", _src(src))
    return int(m.group(1)) * (1024 if m.group(2) else 1)


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


# ---------------------------------------------------------------------------
# The kernels' decompositions, emulated
# ---------------------------------------------------------------------------

def k7_shares(total: int, ranks: int) -> list[tuple[int, int]]:
    """The rows [lo, hi) each rank of K7 streams of the `total` rows the
    probe reads, as the kernel cuts them (K5's share rule)."""
    per = -(-total // ranks)
    shares = []
    for r in range(ranks):
        lo = min(total, r * per)
        shares.append((lo, min(total, lo + per)))
    return shares


def k7_emulate(k: torch.Tensor, v: torch.Tensor, ranks: int) -> torch.Tensor:
    """K7 on R = `ranks`: the shares cover the n_s * s_tile rows once, in
    order, and rank 0 sums rows t * s_tile + r of every tile from 0 in t
    order (f32 adds, as its threads do)."""
    B, H_kv, S, D = k.shape
    s_tile = min(S, 512)
    n_s = S // s_tile
    shares = k7_shares(n_s * s_tile, ranks)
    assert shares[0][0] == 0 and shares[-1][1] == n_s * s_tile
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    out = torch.zeros((B, H_kv, 8, D), dtype=torch.float32)
    for t in range(n_s):
        rows = slice(t * s_tile, t * s_tile + 8)
        out = out + (k[:, :, rows].float() + v[:, :, rows].float())
    return out


def k8_emulate(qt, splits: int, k_split: int) -> torch.Tensor:
    """K8 under a plan of `splits` x k_split rows: each split sums
    v[t * TILE_K] + s[t * TILE_K / 32] over the tiles whose first row lies
    in its slice, in t order, and rank 0 sums the splits' partials in rank
    order."""
    K, N = qt.values.shape
    tile_k = tq._k8_tile_k(K, N)
    assert (splits - 1) * k_split < K <= splits * k_split
    total = torch.zeros((1, N), dtype=torch.float32)
    for r in range(splits):
        k0, k1 = r * k_split, min(K, (r + 1) * k_split)
        part = torch.zeros((1, N), dtype=torch.float32)
        for t in range(-(-k0 // tile_k), K // tile_k):
            if t * tile_k >= k1:
                break
            part = part + (qt.values[t * tile_k].float()
                           + qt.scales[t * tile_k // 32].float())
        total = total + part
    return total


def test_kernel_constants_match_k5_and_k1():
    """K7's block, cluster cap, chunk rule and ring are K5's (decode_attn_
    single.cu); its share rule is the one `k7_shares` emulates; K8's block,
    columns and split cap are K1's GEMV's (qdot_gemv.cuh, ops/qmat.py)."""
    k5 = "decode_attn_single.cu"
    assert _const("K7_THREADS") == _const("THREADS", k5) == 256
    assert _const("MAX_RANKS") == _const("MAX_RANKS", k5) == tda.ATTN_MAX_RANKS
    for name in ("CHUNK_BYTES", "MAX_SUB", "NCH"):
        assert _const(name) == _const(name, k5)
    share = re.search(r"// the rank's share \[lo, hi\) of the rows the probe "
                      r"reads\n(.*?)\n  const int n_rows", _src("dma_floor.cu"),
                      re.S).group(1)
    assert [" ".join(line.split()) for line in share.splitlines()] == [
        "const int total = n_s * s_tile;",
        "const int per = (total + R - 1) / R;",
        "const int lo = min(total, rank * per);",
        "const int hi = min(total, lo + per);"]
    assert k7_shares(256, 8) == [(32 * r, 32 * (r + 1)) for r in range(8)]
    assert k7_shares(1024, 3) == [(0, 342), (342, 684), (684, 1024)]
    assert k7_shares(8, 8)[-1] == (7, 8) and k7_shares(5, 8)[-1] == (5, 5)
    gemv = "qdot_gemv.cuh"
    assert _const("K8_THREADS") == 32 * _const("GEMV_WARPS", gemv) == 128
    assert _const("K8_MAX_SPLITS") == _const("GEMV_MAX_SPLITS", gemv) \
        == tq.GEMV_MAX_SPLITS
    cols = re.search(r"static constexpr int COLS = ALIGNED \? (\d+) : (\d+);",
                     _src("dma_floor.cu")).groups()
    assert (int(cols[0]), int(cols[1])) == (tq._gemv_cols(2560),
                                            tq._gemv_cols(13059)) == (32, 128)
    # K8's chunks: whole quant groups; its ring fits 48 KB (no opt-in)
    assert _const("K8_STAGES") >= 2 and _const("K8_CHUNK_GROUPS") >= 1


@functools.lru_cache(maxsize=None)
def _k7_case(S, D, dtype):
    """(k, v as torch, the JAX probe's output) on B = 1, H_kv = 2."""
    rng = np.random.default_rng(S + D)
    shape = (1, 2, S, D)
    if dtype == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        jk, jv = jnp.asarray(k), jnp.asarray(v)
    else:
        jk = jnp.asarray(rng.standard_normal(shape, np.float32), dtype)
        jv = jnp.asarray(rng.standard_normal(shape, np.float32), dtype)
        k, v = np.array(jk, np.float32), np.array(jv, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jda._dma_floor(jnp.zeros((1, 8, D)), jk, jv))
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt), want)


@pytest.mark.parametrize("ranks", [1, 3, 8])
@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("S", [200, 1100, 1536, 2048])
def test_k7_split_emulation_matches_jax_and_plain(S, dtype, D, ranks):
    """The rank split at S = 200 (one tile, shares ending mid-chunk), 1100
    (two tiles, 76 rows unread), 1536 and 2048: bit for bit the plain
    version, within 1e-6 of the JAX probe."""
    k, v, want = _k7_case(S, D, dtype)
    got = k7_emulate(k, v, ranks)
    assert torch.equal(got, tda.dma_floor_plain(k, v))
    assert rel_err(got.numpy(), want) < TOL


@functools.lru_cache(maxsize=None)
def _k8_case(bench_qmat, K, N):
    jt, pt = _q8(K, N, seed=K ^ N)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bench_qmat.dma_floor(None, jt))
    return pt, want


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("K,N", [(4096, 1024), (4096, 13059)])
def test_k8_split_emulation_matches_jax_and_plain(bench_qmat, K, N, splits):
    """The rank-order combine at 1-8 splits (K1's plan rule: whole quant
    groups, the last split ragged) on aligned rows and on the heads' 13059
    columns, two K tiles: within 1e-6 of the JAX probe (on the N // TILE_N
    whole column tiles its grid covers) and of the plain version."""
    pt, want = _k8_case(bench_qmat, K, N)
    groups = K // 32
    per = -(-groups // splits)
    got = k8_emulate(pt, -(-groups // per), per * 32)
    covered = N // 256 * 256 if N % 512 else N
    assert rel_err(got[:, :covered].numpy(), want[:, :covered]) < TOL
    assert rel_err(got.numpy(), tq.qdot_dma_floor_plain(pt).numpy()) < TOL


def test_probe_plans_at_the_probe_shapes():
    """The plans the wrappers take by default: K7 K5's `_single_plan` (8
    ranks at LFM2's B = 1 rows, 4 at B = 4, one rank where the batched
    shapes fill the card), K8 K1's `_gemv_plan` at bench_qmat.py's 2.6B
    shapes."""
    ranks = [tda._single_plan(B, H_kv, S, SMS).ranks for B, H_kv, S in (
        (1, 8, 256), (1, 8, 2048), (4, 8, 512), (1, 4, 256), (2, 8, 512),
        (64, 4, 256), (16, 8, 2048), (128, 8, 256))]
    assert ranks == [8, 8, 4, 8, 8, 1, 1, 1]
    plans = [tq._gemv_plan(K, N, 32, SMS) for K, N in (
        (2560, 3840), (2560, 2560), (2560, 16384), (8192, 2560))]
    assert [(p.splits, p.k_split) for p in plans] == [
        (3, 864), (4, 640), (1, 2560), (4, 2048)]


@pytest.mark.parametrize("ranks", [0, 9])
def test_attn_dma_floor_refuses_a_plan_outside_one_to_eight(ranks):
    """Checked first: raises on the CPU, before any build or launch."""
    k = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ranks"):
        tda._dma_floor_cuda(k, k, tda.AttnPlan(ranks=ranks))


@pytest.mark.parametrize("splits", [0, 9])
def test_qdot_dma_floor_refuses_a_plan_outside_one_to_eight(splits):
    """Checked first: raises on the CPU, before any build or launch."""
    _, pt = _q8(512, 64, seed=2)
    with pytest.raises(ValueError, match="splits"):
        tq._qdot_dma_floor_cuda(pt, tq.GemvPlan(splits=splits, k_split=64))
