"""The M > 1 tile of K1 and K1v (miotts_tpu_torch/ops/csrc/qdot_tile.cuh),
on the CPU: its plan (ops/qmat.py:_tile_plan) covers every output and every
K exactly, and its order of sums, emulated in plain torch, meets the
kernel's bounds against the JAX package's Pallas kernel in interpret mode.

The emulation follows the kernel step for step: x split into exact bf16
parts (three for an f32 x in K1, one otherwise), each quant group's partial
sum of exact products rounded once to f32 (the tensor cores' sum), folded
into the split's f32 accumulator by fused multiply-adds (K1: s * P, then
- mins * X; K1v: + Q, then - mins * X), and the splits' partials summed in
split order.  The kernel's own tests on the card are in
tests/test_torch_qdot_cuda.py and tests/test_torch_qdot_bf16_cuda.py."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGML_Q4_0, GGML_Q4_K, GGML_Q6_K, GGML_Q8_0
from miotts_tpu.gguf.quants import quantize
from miotts_tpu.ops import qmat as jq
from miotts_tpu_torch.ops import qmat as tq
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

PLAN_MS = (2, 7, 16, 17, 64, 65)
PLAN_NS = (768, 1000, 13059, 16384)
PLAN_KS = (768, 2048, 8192)


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m", PLAN_MS)
def test_tile_plan_covers_outputs_and_k_exactly(m, group):
    """Tiles cover N and M exactly (no whole tile past the edge), splits are
    whole stages of whole quant groups, cover K exactly (none empty), and
    the 16-row tile serves M <= 16 and small weights."""
    for n in PLAN_NS:
        for k in PLAN_KS:
            p = tq._tile_plan(m, k, n, group)
            bn = tq.TILE_BN
            assert p.bm == (16 if m <= 16 or k * n < tq.TILE_BM16_MAX_KN
                            else 64)
            assert (p.n_tiles - 1) * bn < n <= p.n_tiles * bn
            assert (p.m_tiles - 1) * p.bm < m <= p.m_tiles * p.bm
            assert p.k_split % tq.TILE_BK == 0 and p.k_split % group == 0
            assert (p.splits - 1) * p.k_split < k <= p.splits * p.k_split
            steps = -(-k // tq.TILE_BK)
            assert p.k_split // tq.TILE_BK >= min(tq.SPLIT_MIN_STEPS, steps)
            assert p.splits == 1 or (p.n_tiles * p.m_tiles
                                     < tq.TILE_BLOCKS_PER_SM[p.bm] * tq.H100_SMS)


def test_tile_plan_splits_narrow_outputs_only():
    """A narrow linear at the serving shapes is split over blocks; a wide
    one at M = 64 whose tiles fill the card is not split further than its
    stage count asks."""
    narrow = tq._tile_plan(16, 2048, 2048, 32)
    assert narrow.splits > 1
    assert (narrow.n_tiles * narrow.splits
            >= tq.TILE_BLOCKS_PER_SM[16] * tq.H100_SMS // 2)
    wide = tq._tile_plan(128, 768, 16384, 32)
    assert wide.splits == 1
    with pytest.raises(ValueError):
        tq._tile_plan(1, 2048, 2048, 32)
    with pytest.raises(ValueError):
        tq._tile_plan(16, 2040, 2048, 32)


def test_tile_constants_match_the_kernel_header():
    """The plan's tile width and stage depth are the kernel's: the wrapper
    sizes the split-K workspace by TILE_BN, so a header with a wider tile
    would write past it."""
    header = (Path(tq.__file__).parent / "csrc" / "qdot_tile.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (BN|BK) = (\d+);", header))
    assert consts == {"BN": str(tq.TILE_BN), "BK": str(tq.TILE_BK)}


def test_tile_plan_follows_the_sm_count():
    """The split count aims at blocks per SM of the card it is given: half
    the SMs, half the splits of a narrow linear; the tile height does not
    change."""
    full = tq._tile_plan(16, 2048, 2048, 32)
    assert full == tq._tile_plan(16, 2048, 2048, 32, tq.H100_SMS)
    half = tq._tile_plan(16, 2048, 2048, 32, tq.H100_SMS // 2)
    assert (half.bm, half.n_tiles) == (full.bm, full.n_tiles)
    assert half.splits * 2 == full.splits


def _split3(x: torch.Tensor) -> list:
    """f32 x as three bf16-valued parts, smallest first; exact."""
    x0 = x.bfloat16().float()
    x1 = (x - x0).bfloat16().float()
    x2 = (x - x0 - x1).bfloat16().float()
    assert torch.equal(x0.double() + x1.double() + x2.double(), x.double())
    return [x2, x1, x0]


def tile_emulation(x: torch.Tensor, qt, bf16_mode: str = "") -> torch.Tensor:
    """K1 (bf16_mode "") or K1v ("1" / "after") in the tile's order of
    sums, under the plan of ops/qmat.py:_tile_plan."""
    M, K = x.shape
    g = qt.group
    plan = tq._tile_plan(M, K, qt.values.shape[1], g)
    xf = x.float()
    v = qt.unpacked_values().double()
    s = qt.scales.double()
    if bf16_mode:
        sp = qt.scales if bf16_mode == "after" else qt.scales.bfloat16().float()
        w = (v.float().reshape(K // g, g, -1) * sp[:, None, :]).reshape(K, -1)
        v = w.bfloat16().double()
        parts = [xf.bfloat16().float()]
    else:
        parts = _split3(xf) if x.dtype == torch.float32 else [xf]
    mins = None if qt.mins is None else qt.mins.double()
    total = torch.zeros((M, v.shape[1]), dtype=torch.float32)
    for z in range(plan.splits):
        acc = torch.zeros_like(total)
        for b in range(z * plan.k_split // g, min(K, (z + 1) * plan.k_split) // g):
            ks = slice(b * g, (b + 1) * g)
            # the group's partial: exact products, one f32 rounding
            part = sum(p[:, ks].double() @ v[ks] for p in parts).float()
            acc = (acc.double() + (part.double() if bf16_mode
                                   else s[b] * part.double())).float()
            if mins is not None:
                xg = xf[:, ks].sum(dim=1).double()
                acc = (acc.double() - xg[:, None] * mins[b]).float()
        total = total + acc
    return total.to(x.dtype)


def _pair(fmt: str, n: int, k: int, seed: int):
    """(JAX QTensor, port QTensor) of the same GGUF bytes; "q4_k+q6_k" is
    the 2.6B-Q4_K_M fused QKV's mix (int8 values, g16, mins)."""
    def one(gtype, pack4, rows, sd):
        w = np.random.default_rng(sd).standard_normal((rows, k)).astype(
            np.float32)
        raw = np.frombuffer(quantize(w, gtype), dtype=np.uint8)
        return (jq.qtensor_from_raw(raw, gtype, rows, k, pack4=pack4),
                tq.qtensor_from_raw(raw, gtype, rows, k, pack4=pack4))
    if fmt == "q4_k+q6_k":
        a, b = one(GGML_Q4_K, True, n // 2, seed), one(GGML_Q6_K, False,
                                                       n - n // 2, seed + 1)
        jt, pt = (jq.concat_qtensors([a[0], b[0]]),
                  tq.concat_qtensors([a[1], b[1]]))
        assert pt.group == 16 and not pt.packed and pt.mins is not None
        return jt, pt
    gtype, pack4 = {"q8_0": (GGML_Q8_0, False), "q4_0": (GGML_Q4_0, True),
                    "q4_k": (GGML_Q4_K, True)}[fmt]
    return one(gtype, pack4, n, seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["q4_k+q6_k", "q8_0", "q4_0", "q4_k"])
def test_tile_order_of_sums_matches_pallas(fmt, dtype):
    """K1's tile order at K = 8192 (split over blocks) and M = 16 / 65
    against `_qdot_pallas(..., interpret=True)`: f32 x within 1e-5 of the
    output scale, bf16 x within 1e-2 (one rounding of the output on either
    side); and against the port's plain version within the same bounds."""
    jt, pt = _pair(fmt, 200, 8192, seed=len(fmt))
    rng = np.random.default_rng(3)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for m in (16, 65):
        assert tq._tile_plan(m, 8192, 200, pt.group).splits > 1
        x = rng.standard_normal((m, 8192)).astype(np.float32)
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        got = tile_emulation(xt, pt).float().numpy()
        want = np.asarray(jq._qdot_pallas(
            jnp.asarray(xt.float().numpy()).astype(dtype), jt,
            interpret=True).astype(jnp.float32))[:, :200]
        assert got.shape == want.shape == (m, 200)
        assert rel_err(got, want) < tol, (m, rel_err(got, want))
        plain = tq.qdot_plain(xt, pt).float().numpy()
        assert rel_err(got, plain) < tol


@pytest.mark.parametrize("mode", ["1", "after"])
def test_tile_order_of_sums_k1v_matches_pallas(mode):
    """K1v's tile order (bf16 weights rounded as the mode says, the mins
    term in f32 per group) against `_qdot_pallas(bf16_dot=...)` in
    interpret mode at K = 8192, f32 x: within 1e-5 of the output scale."""
    jt, pt = _pair("q4_k+q6_k", 200, 8192, seed=9)
    x = np.random.default_rng(4).standard_normal((16, 8192)).astype(np.float32)
    got = tile_emulation(torch.from_numpy(x), pt, mode).numpy()
    want = np.asarray(jq._qdot_pallas(
        jnp.asarray(x), jt, interpret=True,
        bf16_dot=True if mode == "1" else "after"))[:, :200]
    assert rel_err(got, want) < 1e-5, rel_err(got, want)
    plain = tq.qdot_bf16_plain(torch.from_numpy(x), pt, mode).numpy()
    assert rel_err(got, plain) < 1e-5
