"""The split-K GEMV shared by K1, K1v, K2 (M = 1), K3, K4a and K4b
(miotts_tpu_torch/ops/csrc/qdot_gemv.cuh), on the CPU: its plan
(ops/qmat.py:_gemv_plan) covers K in whole quant groups with enough blocks
for the card, and its order of sums, emulated in plain torch, meets the
kernel's bounds against the JAX package's Pallas kernels in interpret mode.

The emulation follows the kernel step for step: each chunk (8 byte rows of
one quant group) sums x_k * q in f32 fused multiply-adds in row order (a
packed row's low nibble, then its high one) beside the f32 sum X of its x;
the chunk folds into its team's f32 accumulator as s * P, then - mins * X.
K1v's bf16-weight form sums bf16(x_k) * bf16(q * s') instead (s' = bf16(s)
in mode 1, s in mode after; X still of the unrounded x) and folds P as it
is, then - mins * X.  K4's integer-partial form quantizes each split's K
slice of x per quant group (sx = amax / 127, or 1; xq = clip(rint(x /
sx), -127, 127)), sums the chunk's int32 D = sum xq * q and Xq = sum xq
exactly, and folds (s * sx) * D, then - mins * (sx * Xq), each scale
formed in f32 first.  Chunk i of a split goes to team i % T of warp
(i / T) % 4 (T teams a warp: 16 of two lanes, fewer but wider where the
rows are not 16-byte aligned); the teams meet by the warp's xor-shuffle
tree and the warps in order, and the splits (the cluster's blocks) in rank
order.  The
kernels' own tests on the card are in tests/test_torch_qdot_cuda.py (K1),
tests/test_torch_qdot_bf16_cuda.py (K1v) and
tests/test_torch_qdot_variants_cuda.py (K2, K3, K4a, K4b)."""

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

PLAN_NS = (768, 2560, 3840, 13059, 16384)
PLAN_KS = (768, 2048, 2560, 8192)
WARPS, THREADS = 4, 128   # warps and threads of a block


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("k", PLAN_KS)
def test_gemv_plan_covers_k_in_whole_groups(k, group):
    """Splits are whole quant groups, cover K exactly (none empty), stay
    within the portable cluster, and the blocks reach about two an SM: two
    or more wherever the cluster's 8 splits allow it, and 1.4 or more at
    every path shape (N = 768 caps at 24 x 8 = 192 blocks)."""
    for n in PLAN_NS:
        p = tq._gemv_plan(k, n, group)
        assert p.k_split % group == 0
        assert (p.splits - 1) * p.k_split < k <= p.splits * p.k_split
        assert 1 <= p.splits <= tq.GEMV_MAX_SPLITS
        n_tiles = -(-n // tq._gemv_cols(n))
        blocks = n_tiles * p.splits
        assert blocks >= min(2 * tq.H100_SMS,
                             n_tiles * tq.GEMV_MAX_SPLITS)
        assert blocks >= 1.4 * tq.H100_SMS, (k, n, p)


def test_gemv_plan_follows_the_sm_count_and_rejects_bad_shapes():
    """Fewer SMs, fewer splits for a narrow linear; a wide one is not
    split; shapes the kernel does not take raise."""
    full = tq._gemv_plan(2560, 2560, 32)
    assert full == tq._gemv_plan(2560, 2560, 32, tq.H100_SMS)
    half = tq._gemv_plan(2560, 2560, 32, tq.H100_SMS // 2)
    assert half.splits * 2 == full.splits
    assert tq._gemv_plan(2560, 16384, 32).splits == 1
    assert tq._gemv_plan(64, 768, 32).splits == 2    # one group a split
    for bad in ((2040, 2048, 32), (2048, 2048, 64), (0, 2048, 32)):
        with pytest.raises(ValueError):
            tq._gemv_plan(*bad)


def test_gemv_constants_match_the_kernel_source():
    """The plan's column widths (rows 16-byte aligned or not) and split cap
    are the kernel's (the shared header of K1, K1v, K2 and K3): a wider
    block or a larger cluster would leave the plan's arithmetic wrong."""
    src = (Path(tq.__file__).parent / "csrc" / "qdot_gemv.cuh").read_text()
    consts = dict(re.findall(
        r"constexpr int (GEMV_TEAM|GEMV_TEAM_UNALIGNED|GEMV_MAX_SPLITS|"
        r"GEMV_WARPS) = (\d+);", src))
    assert "constexpr int GEMV_COLS = 16 * GEMV_TEAM;" in src
    assert "return aligned ? GEMV_TEAM : GEMV_TEAM_UNALIGNED;" in src
    assert consts == {"GEMV_TEAM": str(tq.GEMV_COLS // 16),
                      "GEMV_TEAM_UNALIGNED": str(tq.GEMV_TEAM_UNALIGNED),
                      "GEMV_MAX_SPLITS": str(tq.GEMV_MAX_SPLITS),
                      "GEMV_WARPS": str(WARPS)}
    assert tq._gemv_cols(2560) == tq.GEMV_COLS
    assert tq._gemv_cols(13059) == 16 * tq.GEMV_TEAM_UNALIGNED


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def gemv_emulation(x: torch.Tensor, qt, mode: str | None = None) -> torch.Tensor:
    """The GEMV in its order of sums under the plan of
    ops/qmat.py:_gemv_plan: the group-partial form of K1, K2 and K3 (mode
    None), K1v's bf16-weight form (mode "1" or "after"), or K4's
    integer-partial form (mode "w8a8").  x [1, K] f32 or bf16."""
    K, g, packed = x.shape[1], qt.group, qt.packed
    N = qt.values.shape[1]
    plan = tq._gemv_plan(K, N, g)
    teams = THREADS // (tq._gemv_cols(N) // 16)   # the block's teams
    xf = x.float()[0]
    rpg = g // 2 if packed else g            # byte rows of a group
    R = min(8, rpg)                           # byte rows of a chunk
    rows_total = K // 2 if packed else K
    vals = qt.values.to(torch.int32)
    s, mins = qt.scales, qt.mins
    total = torch.zeros(N, dtype=torch.float32)
    per = plan.k_split // 2 if packed else plan.k_split
    for z in range(plan.splits):
        r0, r1 = z * per, min(rows_total, (z + 1) * per)
        acc = torch.zeros((teams, N), dtype=torch.float32)
        if mode == "w8a8":    # the block's K slice, quantized per group
            k0 = z * plan.k_split
            xs = xf[k0:min(K, k0 + plan.k_split)].reshape(-1, g)
            amax = xs.abs().amax(dim=1)
            sx = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            xq = torch.clamp(torch.round(xs / sx[:, None]), -127, 127)
            xq = xq.to(torch.int64).reshape(-1)
        for ci in range((r1 - r0) // R):
            row0 = r0 + ci * R
            b = row0 // rpg
            k_lo = b * g + row0 % rpg if packed else row0
            p = ci % teams
            if mode == "w8a8":
                kk = torch.arange(k_lo, k_lo + R) - k0
                q = vals[row0:row0 + R].to(torch.int64)
                D = (xq[kk, None] * (q & 0xF if packed else q)).sum(0)
                Xq = xq[kk].sum()
                if packed:
                    D = D + (xq[kk + g // 2, None] * (q >> 4)).sum(0)
                    Xq = Xq + xq[kk + g // 2].sum()
                sxb = sx[b - k0 // g]
                # one f32 rounding of the exact acc + (s * sx) * D (the FMA)
                a = _f32(acc[p].double()
                         + (s[b] * sxb).double() * D.double())
                if mins is not None:
                    a = _f32(a.double() - mins[b].double()
                             * (sxb * Xq.float()).double())
                acc[p] = a
                continue
            sp = s[b] if mode in (None, "after") else _bf16(s[b])
            P = torch.zeros(N, dtype=torch.float32)
            X = torch.zeros((), dtype=torch.float32)
            for r in range(R):
                q = vals[row0 + r]
                terms = [(xf[k_lo + r], q & 0xF if packed else q)]
                if packed:
                    terms.append((xf[k_lo + g // 2 + r], q >> 4))
                for xv, qv in terms:
                    if mode is None:
                        xa, w = xv, qv.double()
                    else:    # bf16(q * s'), the f32 product rounded alone
                        xa, w = _bf16(xv), _bf16(qv.float() * sp).double()
                    # one f32 rounding of the exact P + x * w (the FMA)
                    P = _f32(P.double() + xa.double() * w)
                    X = _f32(X + xv)
            if mode is None:
                a = _f32(acc[p].double() + s[b].double() * P.double())
            else:
                a = acc[p] + P
            if mins is not None:
                a = _f32(a.double() - mins[b].double() * X.double())
            acc[p] = a
        # team p = tpw * warp + q: the xor tree over q, then the warps
        tpw = teams // WARPS
        lanes = acc.reshape(WARPS, tpw, N)
        m = 1
        while m < tpw:
            lanes = lanes + lanes[:, torch.arange(tpw) ^ m]
            m *= 2
        t = torch.zeros(N, dtype=torch.float32)
        for w in range(WARPS):
            t = t + lanes[w, 0]
        total = total + t
    return total[None].to(x.dtype)


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
        return (jq.concat_qtensors([a[0], b[0]]),
                tq.concat_qtensors([a[1], b[1]]))
    gtype, pack4 = {"q8_0": (GGML_Q8_0, False), "q4_0": (GGML_Q4_0, True),
                    "q4_k": (GGML_Q4_K, True)}[fmt]
    return one(gtype, pack4, n, seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["q4_k", "q4_0"])
def test_gemv_order_of_sums_matches_split_pallas(fmt, dtype):
    """K2 at M = 1 in the GEMV's order at K = 8192 (split over a cluster)
    against `_qdot_pallas_split(..., interpret=True)`: f32 x within 1e-5 of
    the output scale, bf16 x within 1e-2 (one rounding of the output on
    either side); and against the port's plain version within the same
    bounds."""
    jt, pt = _pair(fmt, 200, 8192, seed=len(fmt))
    assert tq._gemv_plan(8192, 200, pt.group).splits > 1 and pt.packed
    tol = 1e-5 if dtype == "float32" else 1e-2
    x = np.random.default_rng(5).standard_normal((1, 8192)).astype(np.float32)
    x[:, 32:64] = 0.0
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = gemv_emulation(xt, pt).float().numpy()
    want = np.asarray(jq._qdot_pallas_split(
        jnp.asarray(xt.float().numpy()).astype(dtype), jt,
        interpret=True).astype(jnp.float32))[:, :200]
    assert got.shape == want.shape == (1, 200)
    assert rel_err(got, want) < tol, rel_err(got, want)
    plain = tq.qdot_split_plain(xt, pt).float().numpy()
    assert rel_err(got, plain) < tol


@pytest.mark.parametrize("fmt", ["q4_k+q6_k", "q8_0", "q4_k", "q4_0"])
def test_gemv_order_of_sums_matches_group_pallas(fmt):
    """K3 (bf16 x, int8 or packed values) in the GEMV's order at K = 8192
    against `_qdot_group_pallas(..., interpret=True)` within 1e-2 (its
    output is bf16: one rounding), and against the port's plain version."""
    jt, pt = _pair(fmt, 200, 8192, seed=7 + len(fmt))
    x = np.random.default_rng(6).standard_normal((1, 8192)).astype(np.float32)
    x[:, 32:64] = 0.0
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    got = gemv_emulation(xt, pt).float().numpy()
    want = np.asarray(jq._qdot_group_pallas(xb, jt, interpret=True),
                      np.float32)[:, :200]
    assert rel_err(got, want) < 1e-2, rel_err(got, want)
    plain = tq.qdot_group_plain(xt, pt).float().numpy()
    assert rel_err(got, plain) < 1e-2


FORMATS = ["q4_k+q6_k", "q8_0", "q4_k", "q4_0"]
MODES = {"1": True, "after": "after"}       # port mode -> JAX bf16_dot


def _x_with_zero_group(seed: int, dtype: str) -> torch.Tensor:
    """x [1, 8192] from a seed, quant group 32..63 all zero, in `dtype`."""
    x = np.random.default_rng(seed).standard_normal((1, 8192)).astype(
        np.float32)
    x[:, 32:64] = 0.0
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_gemv_order_of_sums_matches_qdot_pallas(fmt, dtype):
    """K1 at M = 1 in the GEMV's group-partial order at K = 8192 (split over
    a cluster) against `_qdot_pallas(..., interpret=True)`, the TPU
    kernel's f32 dequantize-first path: f32 x within 1e-5 of the output
    scale, bf16 x within 1e-2 (one rounding of the output on either side);
    and against the port's `qdot_plain` within the same bounds."""
    jt, pt = _pair(fmt, 200, 8192, seed=11 + len(fmt))
    assert tq._gemv_plan(8192, 200, pt.group).splits > 1
    tol = 1e-5 if dtype == "float32" else 1e-2
    xt = _x_with_zero_group(8, dtype)
    got = gemv_emulation(xt, pt).float().numpy()
    want = np.asarray(jq._qdot_pallas(
        jnp.asarray(xt.float().numpy()).astype(dtype), jt,
        interpret=True).astype(jnp.float32))[:, :200]
    assert got.shape == want.shape == (1, 200)
    assert rel_err(got, want) < tol, rel_err(got, want)
    plain = tq.qdot_plain(xt, pt).float().numpy()
    assert rel_err(got, plain) < tol, rel_err(got, plain)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_gemv_order_of_sums_matches_bf16_pallas(fmt, dtype, mode):
    """K1v at M = 1 in the GEMV's bf16-weight order at K = 8192 (split over
    a cluster) against `_qdot_pallas(..., bf16_dot=True | "after",
    interpret=True)`: f32 x within 1e-5 of the output scale, bf16 x within
    1e-2; and against the port's `qdot_bf16_plain` within the same
    bounds."""
    jt, pt = _pair(fmt, 200, 8192, seed=13 + len(fmt))
    tol = 1e-5 if dtype == "float32" else 1e-2
    xt = _x_with_zero_group(9, dtype)
    got = gemv_emulation(xt, pt, mode).float().numpy()
    want = np.asarray(jq._qdot_pallas(
        jnp.asarray(xt.float().numpy()).astype(dtype), jt, interpret=True,
        bf16_dot=MODES[mode]).astype(jnp.float32))[:, :200]
    assert got.shape == want.shape == (1, 200)
    assert rel_err(got, want) < tol, rel_err(got, want)
    plain = tq.qdot_bf16_plain(xt, pt, mode).float().numpy()
    assert rel_err(got, plain) < tol, rel_err(got, plain)



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_gemv_order_of_sums_matches_w8a8_pallas(fmt, dtype):
    """K4a (int8 values) / K4b (packed) in the GEMV's integer-partial order
    at K = 8192 (split over a cluster) with an all-zero quant group (sx = 1)
    against `_qdot_w8a8_pallas(..., interpret=True)`: f32 x within 1e-5 of
    the output scale, bf16 x within 1e-2; and against the port's
    `qdot_w8a8_plain` within the same bounds."""
    jt, pt = _pair(fmt, 200, 8192, seed=17 + len(fmt))
    assert tq._gemv_plan(8192, 200, pt.group).splits > 1
    tol = 1e-5 if dtype == "float32" else 1e-2
    xt = _x_with_zero_group(10, dtype)
    got = gemv_emulation(xt, pt, "w8a8").float().numpy()
    want = np.asarray(jq._qdot_w8a8_pallas(
        jnp.asarray(xt.float().numpy()).astype(dtype), jt,
        interpret=True).astype(jnp.float32))[:, :200]
    assert got.shape == want.shape == (1, 200)
    assert rel_err(got, want) < tol, rel_err(got, want)
    plain = tq.qdot_w8a8_plain(xt, pt).float().numpy()
    assert rel_err(got, plain) < tol, rel_err(got, plain)


def test_gemv_w8a8_unaligned_rows_match_pallas():
    """K4b at the 2.6B head's N = 13059 (rows not 16-byte aligned: 8-lane
    teams, 128 columns a block, 3 splits), f32 x: within 1e-5 of
    `_qdot_w8a8_pallas(..., interpret=True)` and of `qdot_w8a8_plain`."""
    jt, pt = _pair("q4_k", 13059, 2560, seed=19)
    assert tq._gemv_cols(13059) == 128
    assert tq._gemv_plan(2560, 13059, pt.group).splits > 1 and pt.packed
    x = np.random.default_rng(11).standard_normal((1, 2560)).astype(
        np.float32)
    x[:, 32:64] = 0.0
    xt = torch.from_numpy(x)
    got = gemv_emulation(xt, pt, "w8a8").numpy()
    want = np.asarray(jq._qdot_w8a8_pallas(jnp.asarray(x), jt,
                                           interpret=True))[:, :13059]
    assert got.shape == want.shape == (1, 13059)
    assert rel_err(got, want) < 1e-5, rel_err(got, want)
    plain = tq.qdot_w8a8_plain(xt, pt).numpy()
    assert rel_err(got, plain) < 1e-5, rel_err(got, plain)
