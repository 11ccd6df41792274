"""K1v, the bf16-dot variants of the quantized matmul
(miotts_tpu_torch.ops.qmat.qdot_bf16_plain, MIOTTS_QDOT_BF16=1 / after),
against the JAX package's `_qdot_pallas(bf16_dot=True | "after")` run in
interpret mode, and the place of the variant in `qdot`'s dispatch."""

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
# (GGUF type, packed): Q8_0 / Q4_0 g32 without mins, Q6_K g16 without, Q4_K
# g32 with mins, packed Q4_K / Q4_0 (Q4_0's centring folds into mins)
FORMATS = [(GGML_Q8_0, False), (GGML_Q6_K, False), (GGML_Q4_K, False),
           (GGML_Q4_0, False), (GGML_Q4_K, True), (GGML_Q4_0, True)]
MODES = {"1": True, "after": "after"}       # port mode -> JAX bf16_dot
F32_TOL = 1e-5           # f32 output: the order of the f32 sums only
BF16_TOL = 1e-2          # bf16 output: one 2^-8 rounding on either side


def _pair(gtype, pack4, n=N, k=K, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    raw = np.frombuffer(quantize(w, gtype), dtype=np.uint8)
    return (jq.qtensor_from_raw(raw, gtype, n, k, pack4=pack4),
            tq.qtensor_from_raw(raw, gtype, n, k, pack4=pack4))


def _fused_pair(seed=1):
    """The Q4_K_M fused QKV: Q4_K q / k beside Q6_K v -> int8 g16 with
    mins."""
    parts = [_pair(GGML_Q4_K, False, n=96, seed=seed),
             _pair(GGML_Q4_K, False, n=48, seed=seed + 1),
             _pair(GGML_Q6_K, False, n=48, seed=seed + 2)]
    jt = jq.concat_qtensors([p[0] for p in parts])
    pt = tq.concat_qtensors([p[1] for p in parts])
    assert pt.group == 16 and pt.mins is not None and not pt.packed
    return jt, pt


def _x(m, k, seed):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)


def _jax(x, jt, mode, n):
    return np.asarray(jq._qdot_pallas(x, jt, interpret=True,
                                      bf16_dot=MODES[mode]),
                      np.float32)[:, :n]


def _check(jt, pt, mode, ms=(1, 3, 8), seed=0):
    n = pt.shape[0]
    for m in ms:
        x = _x(m, pt.k, seed=seed + m)
        got = tq.qdot_bf16_plain(torch.from_numpy(x), pt, mode)
        assert got.dtype == torch.float32 and got.shape == (m, n)
        want = _jax(jnp.asarray(x), jt, mode, n)
        assert rel_err(got.numpy(), want) < F32_TOL, (m, rel_err(
            got.numpy(), want))
        xb = jnp.asarray(x, jnp.bfloat16)
        gotb = tq.qdot_bf16_plain(
            torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
            pt, mode)
        assert gotb.dtype == torch.bfloat16
        assert rel_err(gotb.float().numpy(), _jax(xb, jt, mode, n)) < BF16_TOL


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("gtype,pack4", FORMATS)
def test_bf16_plain_matches_pallas(gtype, pack4, mode):
    """f32 x within 1e-5 of JAX's interpret-mode kernel at M = 1, 3, 8 (the
    same bf16 operands, f32 sums in another order); bf16 x within 1e-2."""
    jt, pt = _pair(gtype, pack4)
    _check(jt, pt, mode)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bf16_plain_fused_g16_with_mins(mode):
    jt, pt = _fused_pair()
    _check(jt, pt, mode, seed=20)


def test_bf16_plain_multi_ktile():
    """K = 8192 takes several K tiles in the Pallas kernel."""
    jt, pt = _pair(GGML_Q4_K, True, n=136, k=8192, seed=3)
    for mode in MODES:
        _check(jt, pt, mode, ms=(2,), seed=30)


@pytest.mark.parametrize("gtype,pack4", [(GGML_Q8_0, False),
                                         (GGML_Q4_K, True)])
def test_bf16_modes_stay_distinct(gtype, pack4):
    """Each mode is > 1e-4 of the output scale away from the other mode's
    JAX output (the modes differ by ~2e-3), so a port that computed one
    mode for both would fail the 1e-5 check above."""
    jt, pt = _pair(gtype, pack4)
    x = _x(8, K, seed=40)
    for mode, other in (("1", "after"), ("after", "1")):
        got = tq.qdot_bf16_plain(torch.from_numpy(x), pt, mode).numpy()
        assert rel_err(got, _jax(jnp.asarray(x), jt, mode, N)) < F32_TOL
        assert rel_err(got, _jax(jnp.asarray(x), jt, other, N)) > 1e-4


def test_bf16_rejects_bad_mode():
    _, pt = _pair(GGML_Q8_0, False)
    for bad in ("", "0", "before"):
        with pytest.raises(ValueError, match="mode"):
            tq.qdot_bf16_plain(torch.zeros((1, K)), pt, bad)
        with pytest.raises(ValueError, match="mode"):
            tq.qdot_bf16(torch.zeros((1, K)), pt, bad)


# ---------------------------------------------------------------------------
# The route: MIOTTS_QDOT_BF16 and the variant's place in qdot's dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,want", [
    ({"MIOTTS_QDOT_BF16": "1"}, tq.QdotRoute(bf16="1")),
    ({"MIOTTS_QDOT_BF16": "after"}, tq.QdotRoute(bf16="after")),
    ({"MIOTTS_QDOT_BF16": "0"}, tq.QdotRoute()),
    ({"MIOTTS_QDOT_BF16": "true"}, tq.QdotRoute()),
    ({"MIOTTS_QDOT_BF16": "after", "MIOTTS_QDOT_GEMV": "w8a8"},
     tq.QdotRoute(gemv="w8a8", bf16="after")),
])
def test_route_reads_qdot_bf16(env, want, monkeypatch):
    """`_use_bf16_dot`'s reading: "1" -> mode 1, "after" -> mode after,
    anything else off; from a mapping or from os.environ."""
    assert tq.QdotRoute.from_env(env) == want
    for name in ("MIOTTS_QDOT_GEMV", "MIOTTS_QDOT_GROUPDOT",
                 "MIOTTS_PACK4_SPLIT", "MIOTTS_GEMV_M8", "MIOTTS_QDOT_BF16"):
        monkeypatch.delenv(name, raising=False)
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    assert tq.QdotRoute.from_env() == want
    with pytest.raises(ValueError):
        tq.QdotRoute(bf16="true")


@pytest.fixture
def calls(monkeypatch):
    """Record which plain version each qdot reached (K1v with its mode)."""
    seen = []
    for name in ("qdot_plain", "qdot_split", "qdot_group", "qdot_w8a8"):
        fn = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda x, w, _f=fn, _n=name: (
            seen.append(_n) or _f(x, w)))
    fn = tq.qdot_bf16
    monkeypatch.setattr(tq, "qdot_bf16", lambda x, w, mode: (
        seen.append(f"qdot_bf16:{mode}") or fn(x, w, mode)))
    return seen


def test_bf16dot_route_dispatch(calls):
    """Mirrors test_bf16dot_env_dispatch: bf16 x takes K1v at any M, f32 x
    keeps K1."""
    _, qt = _pair(GGML_Q8_0, False, n=128, k=256)
    w = tq.with_route(qt, tq.QdotRoute.from_env({"MIOTTS_QDOT_BF16": "1"}))
    tq.qdot(torch.zeros((1, 256), dtype=torch.bfloat16), w)
    tq.qdot(torch.zeros((1, 256)), w)
    tq.qdot(torch.zeros((2, 5, 256), dtype=torch.bfloat16), w)
    assert calls == ["qdot_bf16:1", "qdot_plain", "qdot_bf16:1"]


def test_bf16dot_after_the_other_routes(calls):
    """The JAX order: w8a8 at M = 1, then groupdot at M = 1 for bf16 x, then
    split for packed weights, then K1v; m8 pads M = 1 into K1v."""
    _, q8 = _pair(GGML_Q8_0, False, n=128, k=256)
    _, q4 = _pair(GGML_Q4_K, True, n=128, k=256)
    xb1 = torch.zeros((1, 256), dtype=torch.bfloat16)
    xb4 = torch.zeros((4, 256), dtype=torch.bfloat16)
    cases = [
        (tq.QdotRoute(gemv="w8a8", bf16="after"), q8, xb1, "qdot_w8a8"),
        (tq.QdotRoute(gemv="w8a8", bf16="after"), q8, xb4, "qdot_bf16:after"),
        (tq.QdotRoute(gemv="groupdot", bf16="1"), q8, xb1, "qdot_group"),
        (tq.QdotRoute(gemv="groupdot", bf16="1"), q4, xb4, "qdot_bf16:1"),
        (tq.QdotRoute(split=True, bf16="after"), q4, xb1, "qdot_split"),
        (tq.QdotRoute(split=True, bf16="after"), q8, xb4, "qdot_bf16:after"),
        (tq.QdotRoute(m8=True, bf16="1"), q8, xb1, "qdot_bf16:1"),
        (tq.QdotRoute(gemv="w8a8", m8=True, bf16="1"), q4, xb1,
         "qdot_bf16:1"),
    ]
    for route, qt, x, want in cases:
        y = tq.qdot(x, tq.with_route(qt, route))
        assert calls[-1] == want, (route, calls[-1])
        assert y.shape == (x.shape[0], 128) and y.dtype == torch.bfloat16


def test_bf16dot_route_result_equals_plain():
    """Through qdot, a bf16 x under the route gives K1v's plain result (the
    n_out slice and leading dims as for K1)."""
    _, qt = _pair(GGML_Q4_K, True)
    x = torch.from_numpy(_x(6, K, seed=50)).to(torch.bfloat16)
    for mode in MODES:
        got = tq.qdot(x.reshape(2, 3, K),
                      tq.with_route(qt, tq.QdotRoute(bf16=mode)))
        want = tq.qdot_bf16_plain(x, qt, mode)
        assert got.shape == (2, 3, N)
        assert torch.equal(got.reshape(6, N), want)
