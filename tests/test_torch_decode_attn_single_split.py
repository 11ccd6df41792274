"""K5's cluster split (miotts_tpu_torch/ops/csrc/decode_attn_single.cu) on
the CPU: its plan (`_single_plan`), the ranks' key shares (`rank_keys`,
which mirrors the kernel's share rule, read from the source), and a torch
emulation of the split kernel's order of operations held against the JAX
package's Pallas kernel in interpret mode and against the port's plain
version.

The emulation follows the kernel: rank r takes the contiguous share
[r * per, (r + 1) * per) of the row's valid keys, per = ceil(limit / R);
it walks its share in chunks of SUB keys, keeping its own flash state (the
running row maxima m_r, the p sums l_r and the PV accumulator acc_r, all
f32, p never rounded; int8: p * v_scale weights the values); the ranks
then meet once, in rank order: m = max m_r, l = sum exp(m_r - m) l_r, acc =
sum exp(m_r - m) acc_r, out = acc / max(l, 1e-20).  An empty share is
(-1e9, 0, 0).  Tolerance 1e-5 of the output scale against both (f32 sums
in another order, nothing rounded)."""

import re
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models import llm as jl
from miotts_tpu.ops.decode_attn import decode_attention as jax_k5
from miotts_tpu_torch.ops import decode_attn as tda
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

CSRC = Path(tda.__file__).resolve().parent / "csrc" / "decode_attn_single.cu"
SMS = 132                       # an H100 SXM
TOL = 1e-5


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+)( \* 1024)?;",
                  CSRC.read_text())
    return int(m.group(1)) * (1024 if m.group(2) else 1)


def chunk_keys(D: int, element_size: int) -> int:
    """The kernel's SUB: the largest power of two of keys whose k rows fit
    CHUNK_BYTES, at most MAX_SUB."""
    n = min(_const("MAX_SUB"), _const("CHUNK_BYTES") // (D * element_size))
    return 1 << (n.bit_length() - 1)


def rank_keys(limit: int, ranks: int) -> list[tuple[int, int]]:
    """The keys [lo, hi) of each rank among a row's `limit` valid keys, as
    the kernel cuts them: contiguous shares of ceil(limit / R) keys in rank
    order; the last ranks' may be empty."""
    per = -(-limit // ranks)
    shares = []
    for r in range(ranks):
        lo = min(limit, r * per)
        shares.append((lo, min(limit, lo + per)))
    return shares


def test_split_constants_match_the_kernel_source():
    """The plan's cluster cap and the group cap are the kernel's, and
    `rank_keys` cuts a row as the kernel's share rule does."""
    assert _const("MAX_RANKS") == tda.ATTN_MAX_RANKS == 8
    assert _const("MAX_REP") == tda.MAX_REP
    src = CSRC.read_text()
    share = re.search(r"// the rank's share \[lo, hi\) of the row's valid keys"
                      r"\n(.*?)\n  const int n_keys", src, re.S).group(1)
    assert [" ".join(line.split()) for line in share.splitlines()] == [
        "const int per = (limit + R - 1) / R;",
        "const int lo = min(limit, rank * per);",
        "const int hi = min(limit, lo + per);"]
    # the chunk sizes the emulation walks: LFM2's bf16 D = 64 rows 128 keys
    assert chunk_keys(64, 2) == 128 and chunk_keys(64, 1) == 256
    assert chunk_keys(80, 2) == 64 and chunk_keys(128, 4) == 32


@pytest.mark.parametrize("B,H_kv,S,ranks",
                         [(1, 8, 256, 8), (1, 8, 512, 8), (1, 8, 1024, 8),
                          (1, 8, 2048, 8), (4, 8, 512, 4), (1, 4, 256, 8),
                          (2, 8, 512, 8)])
def test_single_plan_at_the_phase_10_shapes(B, H_kv, S, ranks):
    """chip_smoke.py's phase 10 rows: the LFM2 decode's 8 kv heads take 8
    ranks (64 blocks) from S = 256 on, 4 staggered rows 4."""
    assert tda._single_plan(B, H_kv, S, SMS).ranks == ranks


@pytest.mark.parametrize("S", [1, 31, 32, 64, 100, 128, 256, 4096])
@pytest.mark.parametrize("B,H_kv", [(1, 1), (1, 8), (4, 8), (16, 8), (64, 4),
                                    (64, 8), (200, 8)])
def test_single_plan_takes_a_portable_cluster(B, H_kv, S):
    """1 to 8 ranks at every shape, no more blocks than SMs once split, one
    rank per SINGLE_MIN_RANK_KEYS keys of S at most."""
    r = tda._single_plan(B, H_kv, S, SMS).ranks
    assert 1 <= r <= tda.ATTN_MAX_RANKS
    assert r == 1 or B * H_kv * r <= SMS
    assert r == 1 or r <= S // tda.SINGLE_MIN_RANK_KEYS


def test_single_plan_follows_the_sm_count():
    ranks = [tda._single_plan(4, 8, 1024, sms).ranks
             for sms in (16, 32, 66, 132, 264)]
    assert ranks == [1, 1, 2, 4, 8]
    assert tda._single_plan(1, 8, 256, 132) is tda._single_plan(1, 8, 256, 132)
    with pytest.raises(ValueError):
        tda._single_plan(0, 8, 256, 132)


@pytest.mark.parametrize("ranks", range(1, 9))
def test_rank_keys_cover_the_row_in_order(ranks):
    """For every count of valid keys, the ranks' shares are contiguous, in
    rank order and cover [0, limit); 3 keys over 8 ranks give the first
    three ranks a key each."""
    for limit in range(0, 600):
        shares = rank_keys(limit, ranks)
        assert len(shares) == ranks
        pos = 0
        for lo, hi in shares:
            assert lo == pos and lo <= hi
            pos = hi
        assert pos == limit
    if ranks == 8:
        assert [hi - lo for lo, hi in rank_keys(3, 8)] == [1, 1, 1] + [0] * 5


def split_emulation(q, k, v, fill, q_pos, k_scale, v_scale, ranks):
    """The split kernel's order of operations in torch (see the module
    docstring)."""
    B, H, D = q.shape
    H_kv, S = k.shape[1], k.shape[2]
    rep = H // H_kv
    int8 = k.dtype == torch.int8
    sub = chunk_keys(D, k.element_size())
    scale = 1.0 / np.sqrt(D)
    qg = q.float().reshape(B, H_kv, rep, D)
    out = torch.zeros((B, H_kv, rep, D))
    for b in range(B):
        limit = max(0, min(int(fill[b]), int(q_pos[b]) + 1, S))
        states = []
        for lo, hi in rank_keys(limit, ranks):
            m = torch.full((H_kv, rep), tda.NEG)
            l = torch.zeros((H_kv, rep))
            acc = torch.zeros((H_kv, rep, D))
            for c0 in range(lo, hi, sub):
                c1 = min(hi, c0 + sub)
                kt = k[b, :, c0:c1].float()
                vt = v[b, :, c0:c1].float()
                s = torch.einsum("grd,gtd->grt", qg[b], kt)
                if int8:
                    s = s * k_scale[b, :, None, c0:c1] * scale
                else:
                    s = s * scale
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                w = p * v_scale[b, :, None, c0:c1] if int8 else p
                acc = acc * alpha[..., None] + torch.einsum("grt,gtd->grd",
                                                            w, vt)
                l = l * alpha + p.sum(-1)
                m = m_new
            states.append((m, l, acc))
        m_all = torch.stack([st[0] for st in states]).amax(0)
        l_tot = torch.zeros((H_kv, rep))
        acc_tot = torch.zeros((H_kv, rep, D))
        for m_r, l_r, acc_r in states:             # rank order
            wgt = torch.exp(m_r - m_all)
            l_tot = l_tot + wgt * l_r
            acc_tot = acc_tot + wgt[..., None] * acc_r
        out[b] = acc_tot / l_tot.clamp(min=1e-20)[..., None]
    return out.reshape(B, H, D)


# (B, H, H_kv, D, S, fills, q_pos below fill - 1 in row 0): the LFM2 decode's
# rows (190 keys of 256, 766 of 1024), a row with fill 0 beside one of 3
# keys (fewer than the ranks), 4 staggered rows, head dim 80
CASES = {
    "b1_s256": (1, 8, 2, 64, 256, [190], False),
    "b1_s1024": (1, 8, 2, 64, 1024, [766], False),
    "idle_and_3_keys": (2, 8, 2, 64, 256, [0, 3], False),
    "b4_staggered": (4, 8, 2, 64, 512, [512, 0, 301, 97], True),
    "d80": (2, 8, 2, 80, 256, [150, 77], False),
}


@lru_cache(maxsize=None)
def _inputs(case, mode, seed=0):
    """Numpy inputs: q_pos = fill - 1 (the hybrid decode's), or row 0's
    q_pos at fill // 3; bf16 values rounded once and handed to both sides;
    int8 the cache write's quantization (JAX's _kv_quantize)."""
    B, H, H_kv, D, S, fills, low_qpos = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, H_kv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, H_kv, S, D)).astype(np.float32)
    fill = np.asarray(fills, np.int32)
    q_pos = fill - 1
    if low_qpos:
        q_pos[0] = fill[0] // 3
    ks = vs = None
    if mode == "int8":
        (k, ks), (v, vs) = (tuple(np.asarray(a) for a in
                                  jl._kv_quantize(jnp.asarray(x)))
                            for x in (k, v))
    elif mode == "bf16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))
    return q, k, v, fill, q_pos, ks, vs


@lru_cache(maxsize=None)
def _jax_out(case, mode):
    """JAX's K5 in interpret mode, once per case."""
    x = _inputs(case, mode)
    return np.asarray(jax_k5(*(None if a is None else jnp.asarray(a)
                               for a in x), interpret=True))


def _torch(arrays):
    """numpy (bf16 included) -> torch, bf16 staying bf16."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
        elif a.dtype.name == "bfloat16":
            out.append(torch.from_numpy(a.astype(np.float32)).bfloat16())
        else:
            out.append(torch.from_numpy(np.array(a)))
    return out


@pytest.mark.parametrize("ranks", [1, 3, 8])
@pytest.mark.parametrize("mode", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_emulation_matches_jax_and_plain(case, mode, ranks):
    args = _torch(_inputs(case, mode))
    got = split_emulation(*args, ranks)
    plain = tda.decode_attention_plain(*args)
    want = _jax_out(case, mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) < TOL
    assert rel_err(got.numpy(), plain.numpy()) < TOL
    idle = np.asarray(CASES[case][5]) == 0
    assert (got.numpy()[idle] == 0).all() and (want[idle] == 0).all()
