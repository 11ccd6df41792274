"""K6's cluster split (miotts_tpu_torch/ops/csrc/decode_attn.cu) on the CPU:
its plan (`_attn_plan`, and the ranks' key shares, `rank_keys`, which
mirrors the kernel's `share`), and a torch emulation of the split
kernel's order of operations held against the JAX package's Pallas kernel
in interpret mode and against the port's plain version.

The emulation follows the kernel: per 512-key tile, each rank takes its
share of the valid keys; the ranks swap their row maxima (the tile's
m_new), and in int8 mode their ps maxima (the tile's psc); each rank sums
its own p and its own PV partial; the int8 partials meet as integers
(exact), the float ones in rank order; rank 0 rescales its accumulator.
Tolerances: f32 1e-5 of the output scale (sums in another order); int8
1e-2 of each row's scale against JAX (a quantized probability may flip one
step of 127 where exp differs in the last bit), 1e-5 against the port's
plain version (the same quantizations, integer sums exact); the
emulation's p_i8 identical to the p_i8 the plain version computes for the
same tile."""

import re
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models import llm as jl
from miotts_tpu.ops.decode_attn import decode_attention_batched as jax_k6
from miotts_tpu_torch.ops import decode_attn as tda
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

CSRC = Path(tda.__file__).resolve().parent / "csrc" / "decode_attn.cu"
SMS = 132                       # an H100 SXM


def rank_keys(n: int, ranks: int) -> list[tuple[int, int]]:
    """The keys [lo, hi) of each rank among a tile's n valid keys, as the
    kernel's `share` cuts them: contiguous shares of 4 * ceil(n / 4R) keys
    (a quad of keys never straddles two ranks), in rank order; the last
    ranks' may be empty."""
    per = 4 * -(-n // (4 * ranks))
    return [(min(n, r * per), min(n, r * per + per)) for r in range(ranks)]


def test_split_constants_match_the_kernel_source():
    """The plan's cluster cap and the tile are the kernel's, and
    `rank_keys` cuts a tile as the kernel's `share` does."""
    src = CSRC.read_text()
    const = lambda name: int(re.search(
        rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("MAX_RANKS") == tda.ATTN_MAX_RANKS == 8
    assert const("TILE") == tda.S_TILE
    assert const("MAX_REP") == tda.MAX_REP
    share = re.search(r"auto share = \[&\]\(int t, int& lo, int& hi\) \{"
                      r"(.*?)\n  \};", src, re.S).group(1)
    assert [" ".join(line.split()) for line in share.strip().splitlines()] == [
        "const int n = min(TILE, limit - t * TILE);",
        "const int per = 4 * ((n + 4 * R - 1) / (4 * R));",
        "lo = min(n, rank * per);",
        "hi = min(n, lo + per);"]


@pytest.mark.parametrize("S", [1, 64, 128, 256, 512, 1024, 2048, 4096, 32768])
@pytest.mark.parametrize("B,H_kv", [(1, 1), (1, 8), (4, 2), (16, 8), (64, 4),
                                    (64, 8), (128, 8)])
def test_attn_plan_takes_a_portable_cluster(B, H_kv, S):
    """1 to 8 ranks at every shape, one rank per ATTN_MIN_RANK_KEYS keys of
    a tile at most; one rank where B * H_kv already gives two blocks an SM
    (whatever the row's length)."""
    r = tda._attn_plan(B, H_kv, S, SMS).ranks
    assert 1 <= r <= tda.ATTN_MAX_RANKS
    assert r <= max(1, min(S, tda.S_TILE) // tda.ATTN_MIN_RANK_KEYS)
    if B * H_kv >= 2 * SMS:
        assert r == 1


@pytest.mark.parametrize("S", [256, 1024, 2048])
def test_attn_plan_splits_lfm2_serving(S):
    """LFM2's 16 slots x 8 kv heads are 128 clusters, under one a SM: its
    256-key bucket and its long rows split, the longer the more."""
    assert tda._attn_plan(16, 8, S, SMS).ranks > 1
    assert (tda._attn_plan(16, 8, 2048, SMS).ranks
            >= tda._attn_plan(16, 8, 1024, SMS).ranks
            >= tda._attn_plan(16, 8, 256, SMS).ranks)


@pytest.mark.parametrize("B,H_kv", [(16, 8), (64, 4), (1, 8)])
def test_attn_plan_keeps_short_rows_whole(B, H_kv):
    """A row of fewer than 2 x ATTN_MIN_RANK_KEYS keys is one rank's (LFM2's
    and the 0.1B's 128-key bucket)."""
    assert tda._attn_plan(B, H_kv, 128, SMS).ranks == 1


@pytest.mark.parametrize("B,H_kv,S,float_ranks",
                         [(64, 4, 256, 2), (16, 8, 256, 2), (64, 4, 512, 2),
                          (16, 8, 1024, 3), (16, 8, 2048, 4), (64, 8, 256, 1)])
def test_attn_plan_keeps_short_int8_rows_whole(B, H_kv, S, float_ranks):
    """An int8 cache's rows under ATTN_INT8_MIN_SPLIT keys are one rank's
    (at 0.1B and LFM2 serving's 256-key bucket, where a float cache
    splits); from there on the int8 plan is the float one."""
    assert tda._attn_plan(B, H_kv, S, SMS).ranks == float_ranks
    int8 = tda._attn_plan(B, H_kv, S, SMS, int8=True).ranks
    assert int8 == (1 if S < tda.ATTN_INT8_MIN_SPLIT else float_ranks)


def test_attn_plan_follows_the_sm_count():
    """More SMs, more ranks for the same clusters (up to the caps); the
    plan reads shapes only, so it is one cached object per shape."""
    ranks = [tda._attn_plan(16, 8, 1024, sms).ranks
             for sms in (16, 66, 132, 264, 528)]
    assert ranks == sorted(ranks) and ranks[0] < ranks[-1]
    assert tda._attn_plan(16, 8, 1024, 16).ranks == 1     # already full
    assert tda._attn_plan(16, 8, 1024, 66).ranks == 2
    assert tda._attn_plan(16, 8, 1024, 132).ranks == 3
    assert tda._attn_plan(64, 4, 512, 132).ranks == 2
    assert tda._attn_plan(64, 4, 512, 528).ranks == 4     # the cap
    assert tda._attn_plan(16, 8, 256, 132) is tda._attn_plan(16, 8, 256, 132)


@pytest.mark.parametrize("ranks", range(1, 9))
def test_rank_keys_cover_each_tile_in_order(ranks):
    """For every count of valid keys in a tile, the ranks' shares are
    contiguous, in rank order and cover [0, n); a share with keys starts on
    a quad of keys (the last ranks' may be empty)."""
    for n in range(0, tda.S_TILE + 1):
        shares = rank_keys(n, ranks)
        assert len(shares) == ranks
        pos = 0
        for lo, hi in shares:
            assert lo == pos and lo <= hi and (lo % 4 == 0 or lo == hi == n)
            pos = hi
        assert pos == n


def split_emulation(q, k, v, fill, q_pos, k_scale, v_scale, ranks,
                    return_stats=False, p8_log=None):
    """The split kernel's order of operations in torch (see the module
    docstring).  With p8_log, p8_log[b, t0] is row b's p_i8 of the tile
    from key t0."""
    B, H, D = q.shape
    H_kv, S = k.shape[1], k.shape[2]
    rep = H // H_kv
    int8 = k.dtype == torch.int8
    scale = 1.0 / np.sqrt(D)
    if int8:
        qq, qs = tda.quantize_query(q)
        qg = qq.reshape(B, H_kv, rep, D)
        qss = (qs * scale).reshape(B, H_kv, rep, 1)
    else:
        qg = q.to(k.dtype).float().reshape(B, H_kv, rep, D)
    acc = torch.zeros((B, H_kv, rep, D))
    m = torch.full((B, H_kv, rep), tda.NEG)
    l = torch.zeros((B, H_kv, rep))
    for b in range(B):
        limit = max(0, min(int(fill[b]), int(q_pos[b]) + 1, S))
        for t0 in range(0, limit, tda.S_TILE):
            n = min(tda.S_TILE, limit - t0)
            kt = k[b, :, t0:t0 + n].float()
            vt = v[b, :, t0:t0 + n].float()
            s = torch.einsum("grd,gtd->grt", qg[b], kt)
            if int8:
                s = s * qss[b] * k_scale[b, :, None, t0:t0 + n]
            else:
                s = s * scale
            shares = rank_keys(n, ranks)
            # each rank's row maxima, swapped: the tile's own m_new
            tmax = torch.stack([s[..., lo:hi].amax(-1) if hi > lo
                                else torch.full_like(m[b], tda.NEG)
                                for lo, hi in shares]).amax(0)
            m_new = torch.maximum(m[b], tmax)
            p = torch.exp(s - m_new[..., None])
            psum = [p[..., lo:hi].sum(-1) for lo, hi in shares]
            if int8:
                ps = p * v_scale[b, :, None, t0:t0 + n]
                pmax = torch.stack([ps[..., lo:hi].amax(-1) if hi > lo
                                    else torch.zeros_like(m[b])
                                    for lo, hi in shares]).amax(0)
                psc = pmax.clamp(min=1e-20)[..., None] / 127.0
                p8 = torch.trunc(ps / psc + 0.5)
                if p8_log is not None:
                    p8_log[b, t0] = p8
                # integer partials, summed across ranks as integers
                total = sum(torch.einsum("grt,gtd->grd",
                                         p8[..., lo:hi].double(),
                                         vt[:, lo:hi].double())
                            for lo, hi in shares)
                pv = total.float() * psc
            else:
                pr = p.to(k.dtype).float()
                pv = torch.zeros((H_kv, rep, D))
                for lo, hi in shares:              # rank order
                    pv = pv + torch.einsum("grt,gtd->grd", pr[..., lo:hi],
                                           vt[:, lo:hi])
            alpha = torch.exp(m[b] - m_new)
            acc[b] = acc[b] * alpha[..., None] + pv
            lsum = torch.zeros_like(l[b])
            for ps_r in psum:                      # rank order
                lsum = lsum + ps_r
            l[b] = l[b] * alpha + lsum
            m[b] = m_new
    if return_stats:
        return acc.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)
    return (acc / l.clamp(min=1e-20)[..., None]).reshape(B, H, D)


B, H, H_KV, D = 4, 8, 2, 64


def _inputs(S, int8, seed=0):
    """Numpy inputs: staggered fills, an idle row, a q_pos below fill;
    at S = 1024 rows of two tiles."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, H_KV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, H_KV, S, D)).astype(np.float32)
    fill = np.asarray([S, 0, S * 3 // 5 + 1, S // 2 + 3], np.int32)
    q_pos = fill.copy()
    q_pos[3] = fill[3] // 3
    ks = vs = None
    if int8:
        (k, ks), (v, vs) = (tuple(np.asarray(a) for a in
                                  jl._kv_quantize(jnp.asarray(x)))
                            for x in (k, v))
    return q, k, v, fill, q_pos, ks, vs


@lru_cache(maxsize=None)
def _jax_stats(S, int8):
    """JAX's (acc, m, l) in interpret mode, once per case."""
    arrs = _inputs(S, int8)
    args = [jnp.asarray(a) for a in arrs if a is not None]
    acc, m, l = jax_k6(*args, b_tile=4, interpret=True, return_stats=True)
    return np.asarray(acc), np.asarray(m), np.asarray(l)


def _t(arrs):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrs]


def _row_rel(got, want) -> float:
    scale = np.abs(want).max(axis=-1, keepdims=True) + 1e-30
    return float(np.max(np.abs(got - want) / scale))


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("S", [256, 1024])
def test_split_emulation_matches_jax_and_plain(S, ranks, int8, stats,
                                              monkeypatch):
    args = _t(_inputs(S, int8))
    log = {}
    got = split_emulation(*args, ranks, return_stats=stats, p8_log=log)
    plain_p8 = []            # the plain version's p_i8 [B, H_kv, rep, tile]
    quantize = tda.quantize_probs

    def quantize_probs(ps):
        p8, psc = quantize(ps)
        plain_p8.append(p8)
        return p8, psc
    monkeypatch.setattr(tda, "quantize_probs", quantize_probs)
    plain = tda.decode_attention_batched_plain(*args, return_stats=stats)
    acc_j, m_j, l_j = _jax_stats(S, int8)
    if stats:
        want_j = (acc_j, m_j, l_j)
    else:
        want_j = (acc_j / np.maximum(l_j, 1e-20)[..., None],)
        got, plain = (got,), (plain,)
    out, out_p, out_j = got[0].numpy(), plain[0].numpy(), want_j[0]
    if int8:
        assert _row_rel(out, out_j) < 1e-2
        assert _row_rel(out, out_p) < 1e-5
        # p_i8: the plain version's for the same row and tile, its masked
        # keys 0
        assert log and len(plain_p8) == -(-S // tda.S_TILE)
        for (b, t0), p8 in log.items():
            want = plain_p8[t0 // tda.S_TILE][b]
            n = p8.shape[-1]
            assert torch.equal(p8, want[..., :n])
            assert not want[..., n:].any()
    else:
        assert rel_err(out, out_j) < 1e-5 and rel_err(out, out_p) < 1e-5
    if stats:
        live = np.asarray(_inputs(S, int8)[3]) > 0
        assert np.array_equal(got[1].numpy()[live], plain[1].numpy()[live])
        assert rel_err(got[1].numpy()[live], want_j[1][live]) < 1e-5
        assert rel_err(got[2].numpy(), want_j[2]) < 1e-5
