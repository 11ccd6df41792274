"""The JAX package's environment switches in miotts_tpu_torch, held against
miotts_tpu on the CPU: MIOTTS_NO_PACK4 (unpacked int8 storage of 4-bit
formats), MIOTTS_FORCE_XLA_QDOT (dequantize, then one matmul), MIOTTS_ATTN_NOCAT
(the no-concatenate softmax merge) and MIOTTS_WARMUP_VERBOSE (warmup's stage
timings on stderr).  The environment is set through monkeypatch only, so
every test restores it."""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGUFReader as jGGUFReader
from miotts_tpu.gguf.quants import quantize as jquantize
from miotts_tpu.models import llm as jl
from miotts_tpu.ops import qmat as jq
from miotts_tpu.runtime import engine as je
from miotts_tpu_torch.convert import llm_params_from_numpy
from miotts_tpu_torch.gguf import GGUFReader
from miotts_tpu_torch.gguf.reader import (GGML_Q4_0, GGML_Q4_K, GGML_Q6_K,
                                          GGML_Q8_0)
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.models.synthetic import (synthetic_llm_config,
                                               write_synthetic_codec,
                                               write_synthetic_llm)
from miotts_tpu_torch.ops import qmat as tq
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import (few_torch_threads, jax_tree_to_numpy,  # noqa: F401
                             rel_err)

N_SPEECH = 64
SWITCHES = ("MIOTTS_NO_PACK4", "MIOTTS_FORCE_XLA_QDOT", "MIOTTS_ATTN_NOCAT",
            "MIOTTS_WARMUP_VERBOSE", "MIOTTS_QDOT_GEMV", "MIOTTS_QDOT_GROUPDOT",
            "MIOTTS_PACK4_SPLIT", "MIOTTS_GEMV_M8", "MIOTTS_QDOT_BF16",
            "MIOTTS_CODEC_FAST")
BF16_STEP = 2.0 ** -8      # one bf16 rounding step of the output scale


@pytest.fixture
def env(monkeypatch):
    """No switch set on entry; `env(name=value, ...)` sets some."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)

    def set_env(**kw):
        for name, val in kw.items():
            monkeypatch.setenv(name, val)
    return set_env


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny Q4_K_M model written by the port's writer (fused QKV of Q4_K
    and Q6_K, w_down Q6_K, wo / gate-up / output Q4_K) and a tiny codec."""
    d = tmp_path_factory.mktemp("switches")
    cfg = dataclasses.replace(synthetic_llm_config(n_speech=N_SPEECH),
                              dim=256, n_heads=4, n_kv_heads=2, head_dim=64,
                              ff_dim=256)
    paths = {"llm": str(d / "llm.gguf"), "codec": str(d / "codec.gguf")}
    write_synthetic_llm(paths["llm"], cfg=cfg, quant_type=GGML_Q4_K, seed=9,
                        mixed_k=True)
    write_synthetic_codec(paths["codec"], n_codes=N_SPEECH, seed=3)
    return paths


def _raw(fmt: int, rows: int, cols: int, seed: int) -> np.ndarray:
    w = np.random.default_rng(seed).standard_normal((rows, cols)).astype(
        np.float32)
    return np.frombuffer(jquantize(w, fmt), dtype=np.uint8)


def _port_of(jqt) -> tq.QTensor:
    """A JAX QTensor carried through the port's convert (N padding cut)."""
    tree = {"blocks": [{"w": jax_tree_to_numpy(jqt)}]}
    return llm_params_from_numpy(tree)["blocks"][0]["w"]


# ---------------------------------------------------------------------------
# MIOTTS_NO_PACK4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", [GGML_Q4_K, GGML_Q4_0])
def test_no_pack4_storage_matches_jax(fmt, env):
    """Under the switch both packages keep a 4-bit tensor's values int8 [K,
    N] (Q4_K 0..15 with its mins, Q4_0 centred), and after convert the
    JAX tensor's values, scales and mins equal the port's bit for bit;
    without it both pack, the same dequantized weight either way."""
    rows, cols = 200, 512           # N = 200 pads to 256 lanes in JAX
    raw = _raw(fmt, rows, cols, seed=fmt)
    packed = tq.qtensor_from_raw(raw, fmt, rows, cols)
    env(MIOTTS_NO_PACK4="1")
    got = tq.qtensor_from_raw(raw, fmt, rows, cols)
    want = _port_of(jq.qtensor_from_raw(raw, fmt, rows, cols))
    assert not got.packed and not want.packed and packed.packed
    assert got.values.dtype == want.values.dtype == torch.int8
    assert got.values.shape == (cols, rows)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.scales, want.scales)
    if fmt == GGML_Q4_K:
        assert torch.equal(got.mins, want.mins)
        assert 0 <= int(got.values.min()) and int(got.values.max()) <= 15
    else:
        assert got.mins is None and want.mins is None
        assert int(got.values.min()) >= -8 and int(got.values.max()) <= 7
    assert torch.equal(got.dequant_t(), packed.dequant_t())
    # a packed tensor unpacked on its device: the same values (the route
    # chip_smoke's unpacked engine takes)
    assert torch.equal(packed.unpacked_values().to(torch.int8),
                       got.values if fmt == GGML_Q4_K else got.values + 8)


@pytest.mark.parametrize("fmt", [GGML_Q8_0, GGML_Q6_K])
def test_no_pack4_leaves_other_formats(fmt, env):
    raw = _raw(fmt, 64, 512, seed=fmt)
    assert not tq.qtensor_from_raw(raw, fmt, 64, 512).packed
    env(MIOTTS_NO_PACK4="1")
    got = tq.qtensor_from_raw(raw, fmt, 64, 512)
    want = _port_of(jq.qtensor_from_raw(raw, fmt, 64, 512))
    assert not got.packed and not want.packed
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.scales, want.scales)


def test_no_pack4_model_matches_jax(files, env):
    """The tiny Q4_K_M model read by both packages under the switch: no
    packed linear in the port, the loader's fusion carries unpacked Q4_K
    (int8 values with mins), and the f32 greedy tokens of 24 steps are
    JAX's."""
    env(MIOTTS_NO_PACK4="1")
    kw = dict(model_path=files["llm"], codec_path=files["codec"],
              max_tokens=24, llm_dtype="float32", prompt_bucket=32,
              code_bucket=16)
    jeng = je.TTSEngine(je.EngineConfig(**kw))
    teng = te.TTSEngine(te.EngineConfig(device="cpu", **kw))
    blocks = teng.llm_params["blocks"]
    qts = [w for b in blocks for w in b.values() if isinstance(w, tq.QTensor)]
    assert qts and not any(w.packed for w in qts)
    assert not teng.llm_params["output"].packed
    wo = blocks[0]["wo"]
    assert wo.values.dtype == torch.int8 and wo.mins is not None
    assert "packed 4-bit linears 0 of" in teng.route_line()
    opts = dict(temperature=0.0, max_tokens=24)
    jids = jeng.generate_tokens("hello world", je.Options(**opts))
    tids = teng.generate_tokens("hello world", te.Options(**opts))
    assert tids == jids and len(tids) == 24


@pytest.mark.parametrize("route,entry", [
    (tq.QdotRoute(split=True), None),
    (tq.QdotRoute(gemv="w8a8"), "qdot_w8a8"),
])
def test_no_pack4_routes(files, env, monkeypatch, route, entry):
    """An unpacked weight never takes K2: under split every linear goes to
    K1's plain version at every M; under w8a8 K4 takes every linear at
    M = 1 (the int8-values body on the card)."""
    env(MIOTTS_NO_PACK4="1")
    teng = te.TTSEngine(te.EngineConfig(
        model_path=files["llm"], codec_path=files["codec"], device="cpu",
        llm_dtype="float32", prompt_bucket=32, qdot_route=route))
    calls = {"qdot_split": [], "qdot_w8a8": []}
    for name in calls:
        plain = getattr(tq, f"{name}_plain")
        monkeypatch.setattr(tq, name, lambda x, w, _n=name, _p=plain: (
            calls[_n].append((x.shape[0], w.packed)) or _p(x, w)))
    teng.generate_tokens("hello", te.Options(temperature=0.0, max_tokens=4))
    assert not calls["qdot_split"]
    n_linear = 4 * teng.llm_cfg.n_layers + 1
    if entry is None:
        assert not calls["qdot_w8a8"]
    else:
        # 3 decode steps after the prefill (the first token is sampled
        # from the prefill's logits)
        assert len(calls[entry]) >= n_linear
        assert len(calls[entry]) % n_linear == 0
        assert {c for c in calls[entry]} == {(1, False)}


# ---------------------------------------------------------------------------
# MIOTTS_FORCE_XLA_QDOT
# ---------------------------------------------------------------------------

def _weights():
    """(name, JAX QTensor, port QTensor) of each format the models load."""
    out = []
    for name, fmt, rows, cols in (("q8_0", GGML_Q8_0, 200, 256),
                                  ("q4_k", GGML_Q4_K, 128, 512),
                                  ("q6_k", GGML_Q6_K, 96, 256),
                                  ("q4_0", GGML_Q4_0, 64, 256)):
        raw = _raw(fmt, rows, cols, seed=rows)
        jqt = jq.qtensor_from_raw(raw, fmt, rows, cols)
        out.append((name, jqt, _port_of(jqt)))
    return out


def test_force_xla_route_from_env(env):
    assert not tq.QdotRoute.from_env().xla
    env(MIOTTS_FORCE_XLA_QDOT="1")
    assert tq.QdotRoute.from_env() == tq.QdotRoute(xla=True)
    assert tq.QdotRoute.from_env({"MIOTTS_FORCE_XLA_QDOT": "yes",
                                  "MIOTTS_QDOT_GEMV": "w8a8"}) == \
        tq.QdotRoute(gemv="w8a8", xla=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 5])
def test_qdot_xla_matches_jax(dtype, m, env):
    """qdot under the xla route against the JAX package's CPU qdot, which
    is its `_qdot_xla`: f32 within 1e-5 of the output scale, bf16 within
    one bf16 step (the weight dequantized in bf16 on both sides)."""
    tol = 1e-5 if dtype == "float32" else BF16_STEP
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    for name, jqt, tqt in _weights():
        x = np.random.default_rng(m).standard_normal(
            (m, tqt.k)).astype(np.float32)
        want = np.asarray(jq.qdot(jnp.asarray(x, jdt), jqt).astype(
            jnp.float32))
        before = tq.qdot_xla.calls
        got = tq.qdot(torch.from_numpy(x).to(tdt),
                      dataclasses.replace(tqt, route=tq.QdotRoute(xla=True)))
        assert tq.qdot_xla.calls == before + 1
        assert got.dtype == tdt and got.shape == want.shape
        err = rel_err(got.float().numpy(), want)
        assert err < tol, (name, dtype, m, err)


def test_qdot_xla_overrides_every_route(monkeypatch, env):
    """With xla set, w8a8 / groupdot / split / bf16 / m8 are ignored, as in
    the JAX package's dispatch: only `qdot_xla` runs, no kernel or plain
    version of one, and no kernel counter moves."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel route ran under xla")
    for name in ("qdot_split", "qdot_group", "qdot_w8a8", "qdot_bf16",
                 "qdot_plain", "_qdot_cuda"):
        monkeypatch.setattr(tq, name, refuse)
    counters = [(tq.qdot, "kernel_launches"),
                (tq.qdot_split, "kernel_launches"),
                (tq.qdot_group, "kernel_launches"),
                (tq.qdot_w8a8, "kernel_launches"),
                (tq.qdot_w8a8, "packed_launches"),
                (tq.qdot_bf16, "kernel_launches")]
    before = [getattr(o, a, 0) for o, a in counters]
    _, jqt, tqt = _weights()[1]              # packed Q4_K
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, tqt.k)).astype(np.float32)).to(torch.bfloat16)
    want = tq.qdot_xla(x, tqt)
    for route in (tq.QdotRoute(gemv="w8a8", xla=True),
                  tq.QdotRoute(gemv="groupdot", xla=True),
                  tq.QdotRoute(split=True, xla=True),
                  tq.QdotRoute(bf16="after", xla=True),
                  tq.QdotRoute(m8=True, xla=True),
                  tq.QdotRoute(gemv="w8a8", split=True, m8=True, bf16="1",
                               xla=True)):
        got = tq.qdot(x, dataclasses.replace(tqt, route=route))
        assert torch.equal(got, want), route
    assert [getattr(o, a, 0) for o, a in counters] == before


def test_force_xla_engine_matches_jax(files, env):
    """An engine built under the switch resolves xla, says so in its route
    line, runs every linear through qdot_xla (4 per layer and the output,
    per prefill and step) and gives JAX's f32 greedy tokens."""
    env(MIOTTS_FORCE_XLA_QDOT="1")
    kw = dict(model_path=files["llm"], codec_path=files["codec"],
              max_tokens=16, llm_dtype="float32", prompt_bucket=32)
    teng = te.TTSEngine(te.EngineConfig(device="cpu", **kw))
    assert teng.config.qdot_route.xla
    assert "xla=True" in teng.route_line()
    before = tq.qdot_xla.calls
    opts = dict(temperature=0.0, max_tokens=16)
    tids = teng.generate_tokens("hello world", te.Options(**opts))
    n_linear = 4 * teng.llm_cfg.n_layers + 1
    calls = tq.qdot_xla.calls - before
    assert calls >= n_linear * 16 and calls % n_linear == 0
    jids = je.TTSEngine(je.EngineConfig(**kw)).generate_tokens(
        "hello world", je.Options(**opts))
    assert tids == jids


# ---------------------------------------------------------------------------
# MIOTTS_ATTN_NOCAT
# ---------------------------------------------------------------------------

def _attn_inputs(int8: bool, seed: int = 5):
    B, H, H_kv, D, S = 4, 8, 4, 80, 256
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(B, 1, H, D), f(B, H_kv, S, D), f(B, H_kv, S, D)
    k_cur, v_cur = f(B, 1, H_kv, D), f(B, 1, H_kv, D)
    fill = np.array([S, 100, 7, 200], np.int32)
    q_pos = fill[:, None].copy()
    ks = vs = None
    if int8:
        kq, ks = jl._kv_quantize(jnp.asarray(k))
        vq, vs = jl._kv_quantize(jnp.asarray(v))
        k, v = np.asarray(kq), np.asarray(vq)
        ks, vs = np.asarray(ks), np.asarray(vs)
    return dict(q=q, k=k, v=v, fill=fill, q_pos=q_pos, ks=ks, vs=vs,
                k_cur=k_cur, v_cur=v_cur)


def _attend_jax(a):
    c = lambda x: None if x is None else jnp.asarray(x)   # noqa: E731
    out = jl._attend(c(a["q"]), c(a["k"]), c(a["v"]), c(a["fill"]),
                     c(a["q_pos"]), c(a["ks"]), c(a["vs"]),
                     k_cur=c(a["k_cur"]), v_cur=c(a["v_cur"]))
    return np.asarray(out)


def _attend_port(a):
    t = lambda x: None if x is None else torch.from_numpy(   # noqa: E731
        np.array(x))
    out = tl._attend(t(a["q"]), t(a["k"]), t(a["v"]), t(a["fill"]),
                     t(a["q_pos"]), t(a["ks"]), t(a["vs"]),
                     k_cur=t(a["k_cur"]), v_cur=t(a["v_cur"]))
    return out.numpy()


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_attend_nocat_matches_jax_f32(int8, env):
    """The port's `_attend` with the current-token column under the switch
    against JAX's `_attend` under it, f32 (an f32 or int8 cache): within
    1e-6 of the output scale."""
    a = _attn_inputs(int8)
    env(MIOTTS_ATTN_NOCAT="1")
    want = _attend_jax(a)
    got = _attend_port(a)
    assert got.shape == want.shape
    assert rel_err(got, want) < 1e-6, rel_err(got, want)


def test_attend_nocat_matches_jax_bf16(files, env):
    """bf16: the tiny model's prefill and four teacher-forced decode steps
    (each layer's `_attend` with the current-token column) under the
    switch in both packages, logits within 2e-2 of their scale: both round
    the unnormalized p to bf16.  (JAX's CPU runtime runs bf16 x bf16 -> f32
    dots only inside a larger program, so the attention is held through
    the model.)  The port's linears take the xla route, JAX's CPU path, so
    that the bf16 dequantization does not part the two."""
    env(MIOTTS_ATTN_NOCAT="1")
    with jGGUFReader(files["llm"]) as r:
        jp, jcfg = jl.load_llm_params(r, dtype=jnp.bfloat16)
    with GGUFReader(files["llm"]) as r:
        tp, tcfg = tl.load_llm_params(r, dtype=torch.bfloat16)
    tp = tq.with_route(tp, tq.QdotRoute(xla=True))
    toks = (np.arange(32) * 37 + 11) % jcfg.n_vocab
    toks[19:] = 0
    jc = jl.init_kv_cache(jcfg, 1, 64, dtype=jnp.bfloat16)
    jlast, jc = jl.llm_prefill(jp, jnp.asarray(toks[None]),
                               jnp.asarray([19], jnp.int32), jc, jcfg)
    tc = tl.init_kv_cache(tcfg, 1, 64, dtype=torch.bfloat16)
    tlast, tc = tl.llm_prefill(tp, torch.from_numpy(toks[None]),
                               torch.tensor([19]), tc, tcfg)
    pairs = [(np.asarray(jlast.astype(jnp.float32)), tlast.float().numpy())]
    for tok in (5, 77, 130, 9):
        jlast, jc = jl.llm_decode_step(jp, jnp.asarray([tok]), jc, jcfg)
        tlast, tc = tl.llm_decode_step(tp, torch.tensor([tok]), tc, tcfg)
        pairs.append((np.asarray(jlast.astype(jnp.float32)),
                      tlast.float().numpy()))
    for i, (want, got) in enumerate(pairs):
        assert np.isfinite(got).all()
        assert rel_err(got, want) < 2e-2, (i, rel_err(got, want))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_attend_nocat_matches_cat(int8, env, monkeypatch):
    """At f32 the no-concatenate merge and the concatenated softmax agree
    within 1e-6 of the output scale; NOCAT really takes the merge."""
    a = _attn_inputs(int8, seed=9)
    cat = _attend_port(a)
    env(MIOTTS_ATTN_NOCAT="1")
    seen = []
    merge = tl._attend_nocat
    monkeypatch.setattr(tl, "_attend_nocat", lambda *x: (
        seen.append(1) or merge(*x)))
    nocat = _attend_port(a)
    assert seen
    assert rel_err(nocat, cat) < 1e-6, rel_err(nocat, cat)


def test_attend_nocat_engine_tokens(files, env):
    """The tiny model's f32 greedy tokens under the switch equal the cat
    path's (and JAX's under it), and the route line says nocat."""
    kw = dict(model_path=files["llm"], codec_path=files["codec"],
              max_tokens=16, llm_dtype="float32", prompt_bucket=32)
    opts = dict(temperature=0.0, max_tokens=16)
    teng = te.TTSEngine(te.EngineConfig(device="cpu", **kw))
    cat = teng.generate_tokens("hello world", te.Options(**opts))
    assert "attention cat" in teng.route_line()
    env(MIOTTS_ATTN_NOCAT="1")
    assert "attention nocat" in teng.route_line()
    nocat = teng.generate_tokens("hello world", te.Options(**opts))
    jids = je.TTSEngine(je.EngineConfig(**kw)).generate_tokens(
        "hello world", je.Options(**opts))
    assert nocat == cat == jids


# ---------------------------------------------------------------------------
# MIOTTS_WARMUP_VERBOSE
# ---------------------------------------------------------------------------

LINE = re.compile(r"^warmup: (.+): (\d+\.\d)s$")


def _labels(err: str) -> list:
    lines = [s for s in err.splitlines() if s.startswith("warmup:")]
    assert all(LINE.match(s) for s in lines), lines
    return [LINE.match(s).group(1) for s in lines]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_warmup_verbose_labels_match_jax(files, env, capsys, fused):
    """Under the switch warmup writes one `warmup: <label>: <s>s` line a
    stage to stderr with the JAX package's labels, in its order; without
    it, nothing."""
    kw = dict(model_path=files["llm"], codec_path=files["codec"],
              max_tokens=32, prompt_bucket=16, code_bucket=16,
              fused_streaming=fused)
    teng = te.TTSEngine(te.EngineConfig(device="cpu", **kw))
    teng.warmup(max_codes=32, prompt_len=16)
    out = capsys.readouterr()
    assert "warmup:" not in out.err and "warmup:" not in out.out
    env(MIOTTS_WARMUP_VERBOSE="1")
    teng.warmup(max_codes=32, prompt_len=16)
    got = _labels(capsys.readouterr().err)
    jeng = je.TTSEngine(je.EngineConfig(**kw))
    jeng.warmup(max_codes=32, prompt_len=16)
    want = _labels(capsys.readouterr().err)
    chunk = teng.config.stream_check_interval
    expect = (["codec bucket T=16", "codec bucket T=32",
               "llm prefill bucket=16", f"llm chunk={chunk} + codec "
               "interleave", "llm chunk=64 + codec interleave"]
              + (["fused stream step bucket=32"] if fused else []))
    assert want == expect
    assert got == want
