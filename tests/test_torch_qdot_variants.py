"""The single-stream routes of miotts_tpu_torch.ops.qmat (K2 split, K3
group-dot, K4 W8A8) against the JAX package's Pallas entries run in
interpret mode, and the route `qdot` takes under each switch."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from miotts_tpu.gguf import GGML_Q4_0, GGML_Q4_K, GGML_Q6_K, GGML_Q8_0
from miotts_tpu.gguf.quants import quantize
from miotts_tpu.ops import qmat as jq
from miotts_tpu_torch.ops import qmat as tq
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

N, K = 200, 512          # N not a multiple of 128: exercises the JAX lane pad

FORMATS = [(GGML_Q8_0, False), (GGML_Q6_K, False), (GGML_Q4_K, False),
           (GGML_Q4_K, True), (GGML_Q4_0, True)]
PACKED = [(GGML_Q4_K, True), (GGML_Q4_0, True)]


def _pair(gtype, pack4, n=N, k=K, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    raw = np.frombuffer(quantize(w, gtype), dtype=np.uint8)
    return (jq.qtensor_from_raw(raw, gtype, n, k, pack4=pack4),
            tq.qtensor_from_raw(raw, gtype, n, k, pack4=pack4))


def _x(m, k, seed, zero_group=32):
    """x [m, k] from a seed, with one all-zero quant group (columns 32..63
    cover a whole group of 16 or 32)."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    x[:, zero_group: zero_group + 32] = 0.0
    return x


def _jax_bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


# ---------------------------------------------------------------------------
# K2: split-x packed matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gtype,pack4", PACKED)
def test_split_plain_matches_pallas(gtype, pack4):
    """f32 x within 1e-5 of the output scale at every M (the order of the f32
    sums only); bf16 x within 1e-2 (one output rounding); K2 equals K1's
    plain version at 1e-5."""
    jt, pt = _pair(gtype, pack4, n=256)
    for m in (1, 7, 64):
        x = _x(m, K, seed=m)
        got = tq.qdot_split_plain(torch.from_numpy(x), pt).numpy()
        want = np.asarray(jq._qdot_pallas_split(jnp.asarray(x), jt,
                                                interpret=True))
        assert got.shape == (m, 256)
        assert rel_err(got, want) < 1e-5, (m, rel_err(got, want))
        k1 = tq.qdot_plain(torch.from_numpy(x), pt).numpy()
        assert rel_err(got, k1) < 1e-5
    xb = _jax_bf16(_x(3, K, seed=9))
    got = tq.qdot_split_plain(torch.from_numpy(np.asarray(xb, np.float32)).to(
        torch.bfloat16), pt)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jq._qdot_pallas_split(xb, jt, interpret=True),
                      np.float32)
    assert rel_err(got.float().numpy(), want) < 1e-2


def test_split_plain_multi_ktile():
    """K = 8192 forces two K tiles in the Pallas kernel."""
    jt, pt = _pair(GGML_Q4_K, True, n=136, k=8192, seed=3)
    x = _x(2, 8192, seed=4) * 0.1
    got = tq.qdot_split_plain(torch.from_numpy(x), pt).numpy()
    want = np.asarray(jq._qdot_pallas_split(jnp.asarray(x), jt,
                                            interpret=True))
    assert rel_err(got, want) < 1e-5


def test_split_rejects_unpacked():
    _, pt = _pair(GGML_Q4_K, False)
    with pytest.raises(ValueError, match="packed"):
        tq.qdot_split_plain(torch.zeros((1, K)), pt)
    with pytest.raises(ValueError, match="packed"):
        tq.qdot_split(torch.zeros((1, K)), pt)


# ---------------------------------------------------------------------------
# K3: scale-after-dot GEMV
# ---------------------------------------------------------------------------

def _group_f64(x, pt):
    """The per-group arithmetic of K3 in float64: d = sum bf16(x) * q per
    group, sum_b d * s, minus the f32 group sums of x times mins."""
    g = pt.group
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()[0]
    q = pt.unpacked_values().double().numpy()
    d = (xb.reshape(-1, g, 1) * q.reshape(-1, g, q.shape[1])).sum(axis=1)
    out = (d * pt.scales.double().numpy()).sum(axis=0)
    if pt.mins is not None:
        out -= x[0].astype(np.float64).reshape(-1, g).sum(1) @ \
            pt.mins.double().numpy()
    return out[None]


@pytest.mark.parametrize("gtype,pack4", FORMATS)
def test_group_plain_matches_pallas(gtype, pack4):
    """bf16 x: within 1e-2 of JAX's interpret-mode kernel (its output is
    bf16: one rounding); f32 x (the plain version takes it as JAX does):
    within 1e-5 of the same arithmetic in float64."""
    jt, pt = _pair(gtype, pack4)
    xb = _jax_bf16(_x(1, K, seed=5))
    got = tq.qdot_group_plain(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16), pt)
    assert got.dtype == torch.bfloat16 and got.shape == (1, N)
    want = np.asarray(jq._qdot_group_pallas(xb, jt, interpret=True),
                      np.float32)[:, :N]
    assert rel_err(got.float().numpy(), want) < 1e-2
    x = _x(1, K, seed=6)
    got32 = tq.qdot_group_plain(torch.from_numpy(x), pt).numpy()
    assert rel_err(got32, _group_f64(x, pt)) < 1e-5


def test_group_plain_multi_ktile():
    jt, pt = _pair(GGML_Q4_K, True, n=136, k=8192, seed=7)
    xb = _jax_bf16(_x(1, 8192, seed=8))
    got = tq.qdot_group_plain(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16), pt)
    want = np.asarray(jq._qdot_group_pallas(xb, jt, interpret=True),
                      np.float32)[:, :136]
    assert rel_err(got.float().numpy(), want) < 1e-2
    x = _x(1, 8192, seed=8)
    assert rel_err(tq.qdot_group_plain(torch.from_numpy(x), pt).numpy(),
                   _group_f64(x, pt)) < 1e-5


def test_group_rejects_m_gt_1():
    _, pt = _pair(GGML_Q8_0, False)
    with pytest.raises(ValueError, match="M=1"):
        tq.qdot_group_plain(torch.zeros((2, K), dtype=torch.bfloat16), pt)
    with pytest.raises(ValueError, match="M=1"):
        tq.qdot_group(torch.zeros((2, K), dtype=torch.bfloat16), pt)


# ---------------------------------------------------------------------------
# K4: W8A8 GEMV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", [16, 32])
def test_quantize_groups_matches_jax_bit_for_bit(group):
    """sx and xq equal `_qdot_w8a8_pallas`'s quantization exactly, an
    all-zero group included (sx = 1, xq = 0)."""
    x = _x(1, K, seed=10) * 3.0
    xq, sx = tq.quantize_groups(torch.from_numpy(x), group)
    xf = jnp.asarray(x).reshape(K // group, group)
    amax = jnp.max(jnp.abs(xf), axis=1)
    jsx = jnp.where(amax > 0, amax / 127.0, 1.0)
    jxq = jnp.clip(jnp.round(xf / jsx[:, None]), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq, np.float32))
    assert float(sx[1 if group == 32 else 2]) == 1.0


@pytest.mark.parametrize("gtype,pack4", FORMATS)
def test_w8a8_plain_matches_pallas(gtype, pack4):
    """f32 x within 1e-5 of JAX's interpret-mode K4 (the integer partials
    are identical; the f32 sums differ in order only), bf16 x within 1e-2
    (one output rounding)."""
    jt, pt = _pair(gtype, pack4)
    x = _x(1, K, seed=11)
    got = tq.qdot_w8a8_plain(torch.from_numpy(x), pt).numpy()
    want = np.asarray(jq._qdot_w8a8_pallas(jnp.asarray(x), jt,
                                           interpret=True))[:, :N]
    assert got.shape == (1, N)
    assert rel_err(got, want) < 1e-5
    xb = _jax_bf16(x)
    gotb = tq.qdot_w8a8_plain(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16), pt)
    assert gotb.dtype == torch.bfloat16
    wantb = np.asarray(jq._qdot_w8a8_pallas(xb, jt, interpret=True),
                       np.float32)[:, :N]
    assert rel_err(gotb.float().numpy(), wantb) < 1e-2


def test_w8a8_plain_multi_ktile():
    for pack4 in (False, True):
        jt, pt = _pair(GGML_Q4_K, pack4, n=136, k=8192, seed=12)
        x = _x(1, 8192, seed=13) * 0.1
        got = tq.qdot_w8a8_plain(torch.from_numpy(x), pt).numpy()
        want = np.asarray(jq._qdot_w8a8_pallas(jnp.asarray(x), jt,
                                               interpret=True))[:, :136]
        assert rel_err(got, want) < 1e-5, pack4


def test_w8a8_rejects_m_gt_1():
    _, pt = _pair(GGML_Q8_0, False)
    with pytest.raises(ValueError, match="M=1"):
        tq.qdot_w8a8_plain(torch.zeros((2, K)), pt)
    with pytest.raises(ValueError, match="M=1"):
        tq.qdot_w8a8(torch.zeros((2, K)), pt)


# ---------------------------------------------------------------------------
# The route: QdotRoute.from_env and the dispatch of qdot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,want", [
    ({}, tq.QdotRoute()),
    ({"MIOTTS_QDOT_GEMV": "w8a8"}, tq.QdotRoute(gemv="w8a8")),
    ({"MIOTTS_QDOT_GEMV": "groupdot"}, tq.QdotRoute(gemv="groupdot")),
    ({"MIOTTS_QDOT_GROUPDOT": "1"}, tq.QdotRoute(gemv="groupdot")),
    ({"MIOTTS_QDOT_GROUPDOT": "1", "MIOTTS_QDOT_GEMV": "plain"},
     tq.QdotRoute()),
    ({"MIOTTS_QDOT_GROUPDOT": "1", "MIOTTS_QDOT_GEMV": "w8a8"},
     tq.QdotRoute(gemv="w8a8")),
    ({"MIOTTS_QDOT_GEMV": "bogus"}, tq.QdotRoute()),
    ({"MIOTTS_PACK4_SPLIT": "1"}, tq.QdotRoute(split=True)),
    ({"MIOTTS_PACK4_SPLIT": "0"}, tq.QdotRoute()),
    ({"MIOTTS_GEMV_M8": "1"}, tq.QdotRoute(m8=True)),
])
def test_route_from_env_reads_the_jax_switches(env, want, monkeypatch):
    """The same variables, values and alias as `_gemv_mode`,
    `_use_pack4_split` and `_gemv_m8`, read from os.environ or a mapping."""
    assert tq.QdotRoute.from_env(env) == want
    for name in ("MIOTTS_QDOT_GEMV", "MIOTTS_QDOT_GROUPDOT",
                 "MIOTTS_PACK4_SPLIT", "MIOTTS_GEMV_M8"):
        monkeypatch.delenv(name, raising=False)
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    assert tq.QdotRoute.from_env() == want
    with pytest.raises(ValueError):
        tq.QdotRoute(gemv="bogus")


@pytest.fixture
def calls(monkeypatch):
    """Record which plain version each qdot reached, by name."""
    seen = []
    for name in ("qdot_plain", "qdot_split", "qdot_group", "qdot_w8a8"):
        fn = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda x, w, _f=fn, _n=name: (
            seen.append((_n, tuple(x.shape))) or _f(x, w)))
    return seen


def _routed(qt, route):
    return tq.with_route(qt, route)


def test_qdot_groupdot_route_dispatch(calls):
    """Mirrors test_qdot_groupdot_env_dispatch: M=1 bf16 GEMVs (packed or
    not) take K3, M>1 and f32 take K1, and an explicit plain wins over the
    alias."""
    _, qt = _pair(GGML_Q8_0, False, n=128, k=256)
    _, q4 = _pair(GGML_Q4_K, True, n=128, k=256)
    route = tq.QdotRoute.from_env({"MIOTTS_QDOT_GROUPDOT": "1"})
    a, b = _routed(qt, route), _routed(q4, route)
    tq.qdot(torch.zeros((1, 256), dtype=torch.bfloat16), a)
    tq.qdot(torch.zeros((2, 256), dtype=torch.bfloat16), a)
    tq.qdot(torch.zeros((1, 256)), a)
    tq.qdot(torch.zeros((1, 1, 256), dtype=torch.bfloat16), b)
    plain = tq.QdotRoute.from_env({"MIOTTS_QDOT_GROUPDOT": "1",
                                   "MIOTTS_QDOT_GEMV": "plain"})
    tq.qdot(torch.zeros((1, 256), dtype=torch.bfloat16), _routed(qt, plain))
    assert [c[0] for c in calls] == ["qdot_group", "qdot_plain", "qdot_plain",
                                     "qdot_group", "qdot_plain"]


def test_qdot_gemv_m8_pads_to_mtile(calls):
    """Mirrors test_qdot_gemv_m8_pads_to_mtile: under m8 the M=1 row reaches
    K1 padded to 8 rows, the result equals the unpadded one, and m8
    overrides w8a8."""
    _, qt = _pair(GGML_Q8_0, False, n=128, k=256)
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (1, 256)).astype(np.float32))
    base = tq.qdot(x, qt)
    got = tq.qdot(x, _routed(qt, tq.QdotRoute(m8=True)))
    assert [c[1] for c in calls] == [(1, 256), (8, 256)]
    assert got.shape == (1, 128)
    assert rel_err(got.numpy(), base.numpy()) < 1e-5
    got2 = tq.qdot(x.to(torch.bfloat16),
                   _routed(qt, tq.QdotRoute(gemv="w8a8", m8=True)))
    assert calls[-1] == ("qdot_plain", (8, 256)) and got2.shape == (1, 128)


def test_pack4_split_route_dispatch(calls):
    """Mirrors test_pack4_split_env_dispatch: packed weights take K2 at any
    M, unpacked ones K1."""
    _, q4 = _pair(GGML_Q4_K, True, n=128, k=256)
    _, qu = _pair(GGML_Q4_K, False, n=128, k=256)
    route = tq.QdotRoute.from_env({"MIOTTS_PACK4_SPLIT": "1"})
    tq.qdot(torch.zeros((1, 256)), _routed(q4, route))
    tq.qdot(torch.zeros((5, 256)), _routed(q4, route))
    tq.qdot(torch.zeros((1, 256)), _routed(qu, route))
    assert [c[0] for c in calls] == ["qdot_split", "qdot_split", "qdot_plain"]


def test_qdot_w8a8_route_dispatch(calls):
    """Mirrors test_qdot_w8a8_env_dispatch: M=1 GEMVs of any dtype, packed
    or not, take K4; M>1 takes K1; w8a8 goes before split."""
    _, qt = _pair(GGML_Q8_0, False, n=128, k=256)
    _, q4 = _pair(GGML_Q4_K, True, n=128, k=256)
    route = tq.QdotRoute(gemv="w8a8", split=True)
    a, b = _routed(qt, route), _routed(q4, route)
    tq.qdot(torch.zeros((1, 256), dtype=torch.bfloat16), a)
    tq.qdot(torch.zeros((1, 256)), a)
    tq.qdot(torch.zeros((2, 256), dtype=torch.bfloat16), a)
    tq.qdot(torch.zeros((1, 256), dtype=torch.bfloat16), b)
    tq.qdot(torch.zeros((4, 256), dtype=torch.bfloat16), b)
    assert [c[0] for c in calls] == ["qdot_w8a8", "qdot_w8a8", "qdot_plain",
                                     "qdot_w8a8", "qdot_split"]


def test_with_route_shares_tensors_and_keeps_route():
    """with_route stamps every QTensor of a tree and copies no tensor;
    .to() and pack4() keep the route; a CPU call counts no launch."""
    _, qu = _pair(GGML_Q4_K, False, n=64, k=256)
    route = tq.QdotRoute(gemv="w8a8")
    tree = {"a": [qu, {"b": qu}], "c": torch.zeros(3)}
    out = tq.with_route(tree, route)
    assert out["a"][0].route == out["a"][1]["b"].route == route
    assert out["a"][0].values is qu.values and out["c"] is tree["c"]
    assert qu.route == tq.QdotRoute()
    assert out["a"][0].to("cpu").route == route
    assert out["a"][0].pack4().route == route
    counts = (tq.qdot.kernel_launches, tq.qdot_w8a8.kernel_launches,
              tq.qdot_w8a8.packed_launches)
    tq.qdot(torch.zeros((1, 256)), out["a"][0])
    assert counts == (tq.qdot.kernel_launches, tq.qdot_w8a8.kernel_launches,
                      tq.qdot_w8a8.packed_launches)
