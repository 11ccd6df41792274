"""The port's TTSEngine on a Q4_K_M model (packed Q4_K beside fused Q4_K +
Q6_K, as llama.cpp writes it) under each single-stream kernel route,
against the JAX package's TTSEngine on its Pallas route: `_use_pallas`
forced on and every Pallas entry of `qdot` run in interpret mode (a
test-only monkeypatch; nothing in the JAX package changes).  The JAX route
is read from the environment when its functions are traced, so every route
starts and ends with empty jit caches."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGML_Q4_K
from miotts_tpu.models import llm as jl
from miotts_tpu.models.synthetic import (synthetic_llm_config,
                                         write_synthetic_codec,
                                         write_synthetic_llm)
from miotts_tpu.ops import qmat as jq
from miotts_tpu.runtime import engine as je
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.ops import qmat as tq
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

N_SPEECH = 64
PALLAS_ENTRIES = ("_qdot_pallas", "_qdot_pallas_split", "_qdot_group_pallas",
                  "_qdot_w8a8_pallas")
ROUTE_ENV = ("MIOTTS_QDOT_GEMV", "MIOTTS_QDOT_GROUPDOT", "MIOTTS_PACK4_SPLIT",
             "MIOTTS_GEMV_M8", "MIOTTS_QDOT_BF16")
# route: (environment, dtype, logits tolerance of the output scale, the
# JAX entry the route must reach, with the bf16_dot it must be given)
ROUTES = {
    # f32, the same arithmetic up to the order of the sums
    "split": ({"MIOTTS_PACK4_SPLIT": "1"}, "float32", 1e-4,
              ("_qdot_pallas_split", False)),
    # f32; a 1e-7 difference upstream can move one activation across a
    # rounding tie of its int8 quantization (1/254 of the group's amax)
    "w8a8": ({"MIOTTS_QDOT_GEMV": "w8a8"}, "float32", 1e-3,
             ("_qdot_w8a8_pallas", False)),
    # bf16 activations (the route's only dtype): bf16 rounding
    "groupdot": ({"MIOTTS_QDOT_GROUPDOT": "1"}, "bfloat16", 2e-2,
                 ("_qdot_group_pallas", False)),
    # K1v (bf16 activations, the variant's only ones): bf16 rounding
    "bf16dot": ({"MIOTTS_QDOT_BF16": "1"}, "bfloat16", 2e-2,
                ("_qdot_pallas", True)),
    "bf16after": ({"MIOTTS_QDOT_BF16": "after"}, "bfloat16", 2e-2,
                  ("_qdot_pallas", "after")),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny Q4_K_M of test_torch_engine (dim 256, 4/2 heads of 64, ff
    256): wqkv unpacked int8 g16 with mins, w_down Q6_K, wo / gate-up /
    output packed Q4_K."""
    d = tmp_path_factory.mktemp("q4km")
    cfg = dataclasses.replace(synthetic_llm_config(n_speech=N_SPEECH),
                              dim=256, n_heads=4, n_kv_heads=2, head_dim=64,
                              ff_dim=256)
    paths = {"llm": str(d / "llm.gguf"), "codec": str(d / "codec.gguf")}
    write_synthetic_llm(paths["llm"], cfg=cfg, quant_type=GGML_Q4_K, seed=9,
                        mixed_k=True)
    write_synthetic_codec(paths["codec"], n_codes=N_SPEECH, seed=3)
    return paths


@pytest.fixture
def route_env(monkeypatch):
    """Set a route's environment for both packages, the JAX package on its
    Pallas route in interpret mode, with its jit caches emptied on entry
    and exit.  Records each entry traced, with the bf16_dot it was given
    (`_qdot_pallas` is traced on every route: the name alone does not show
    the variant)."""
    for name in ROUTE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jq, "_use_pallas", lambda: True)
    traced = set()
    for name in PALLAS_ENTRIES:
        entry = partial(getattr(jq, name), interpret=True)
        monkeypatch.setattr(jq, name, lambda *a, _n=name, _e=entry, **kw: (
            traced.add((_n, kw.get("bf16_dot", False))) or _e(*a, **kw)))
    jax.clear_caches()

    def set_route(env):
        for name, val in env.items():
            monkeypatch.setenv(name, val)
        return traced
    yield set_route
    jax.clear_caches()


def _engines(files, dtype):
    kw = dict(model_path=files["llm"], codec_path=files["codec"],
              max_tokens=24, llm_dtype=dtype, prompt_bucket=32,
              code_bucket=16)
    return (je.TTSEngine(je.EngineConfig(**kw)),
            te.TTSEngine(te.EngineConfig(device="cpu", **kw)))


def _prefill_and_step(jeng, teng, dtype):
    """(prefill logits, first greedy step's logits) of both engines for one
    32-token prompt of 19 real tokens: the prefill runs the M = 32 route,
    the step the M = 1 one."""
    toks = (np.arange(32) * 37 + 11) % jeng.llm_cfg.n_vocab
    toks[19:] = 0
    n_real = np.array([19], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jc = jl.init_kv_cache(jeng.llm_cfg, 1, 64, dtype=jdt)
    jlast, jc = jl.llm_prefill(jeng.llm_params, jnp.asarray(toks[None]),
                               jnp.asarray(n_real), jc, jeng.llm_cfg)
    tc = tl.init_kv_cache(teng.llm_cfg, 1, 64, dtype=tdt)
    tlast, tc = tl.llm_prefill(teng.llm_params, torch.from_numpy(toks[None]),
                               torch.from_numpy(n_real), tc, teng.llm_cfg)
    tok = int(np.argmax(np.asarray(jlast)[0]))
    jstep, _ = jl.llm_decode_step(jeng.llm_params, jnp.asarray([tok]), jc,
                                  jeng.llm_cfg)
    tstep, _ = tl.llm_decode_step(teng.llm_params, torch.tensor([tok]), tc,
                                  teng.llm_cfg)
    return ((np.asarray(jlast), tlast.float().numpy()),
            (np.asarray(jstep), tstep.float().numpy()))


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_matches_jax_pallas_route(name, files, route_env):
    """Under each route: the port's engine resolves the route from the
    environment, its prefill and first-step logits are within the route's
    tolerance of the JAX package's, and in f32 the greedy tokens of a
    24-token generation are identical."""
    env, dtype, tol, entry = ROUTES[name]
    traced = route_env(env)
    jeng, teng = _engines(files, dtype)
    assert teng.config.qdot_route == tq.QdotRoute.from_env(env)
    wqkv = teng.llm_params["blocks"][0]["wqkv"]
    assert wqkv.route == teng.config.qdot_route and not wqkv.packed
    assert teng.llm_params["blocks"][0]["w_gateup"].packed
    (jp, tp), (js, ts) = _prefill_and_step(jeng, teng, dtype)
    assert entry in traced, traced
    if entry[1] is False:   # the prefill's K1 besides an M = 1 route
        assert ("_qdot_pallas", False) in traced, traced
    assert rel_err(tp, jp) < tol, rel_err(tp, jp)
    assert rel_err(ts, js) < tol, rel_err(ts, js)
    if dtype == "float32":
        opts = dict(temperature=0.0, max_tokens=24)
        jids = jeng.generate_tokens("hello world", je.Options(**opts))
        tids = teng.generate_tokens("hello world", te.Options(**opts))
        assert tids == jids and len(tids) == 24


def test_engine_with_qdot_route_shares_weights(files, monkeypatch):
    """with_qdot_route: an engine over the same tensors under another route,
    with its own cache; the original keeps its route.  Greedy tokens of the
    K1 route and the split route agree in f32 (K2 computes K1's function)."""
    for name in ROUTE_ENV:
        monkeypatch.delenv(name, raising=False)
    teng = te.TTSEngine(te.EngineConfig(
        model_path=files["llm"], codec_path=files["codec"], device="cpu",
        llm_dtype="float32", prompt_bucket=32))
    assert teng.config.qdot_route == tq.QdotRoute()
    split = teng.with_qdot_route(tq.QdotRoute(split=True))
    a, b = (e.llm_params["blocks"][1]["w_gateup"] for e in (teng, split))
    assert a.values is b.values and b.route.split and not a.route.split
    assert split.config.qdot_route.split and split._cache is None
    assert not teng.config.qdot_route.split
    opts = te.Options(temperature=0.0, max_tokens=16)
    calls = []
    monkeypatch.setattr(tq, "qdot_split", lambda x, w: calls.append(
        x.shape[0]) or tq.qdot_split_plain(x, w))
    want = teng.generate_tokens("hello", opts)
    assert not calls
    assert split.generate_tokens("hello", opts) == want
    # 5 packed linears (2 x wo, gate-up; the output) in the M = 32
    # prefill, then in every M = 1 step
    assert calls[:5] == [32, 32, 32, 32, 32] and set(calls[5:]) == {1}
