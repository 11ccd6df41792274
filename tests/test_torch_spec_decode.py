"""The port's speculative decoding against the JAX package, on the fixture
shapes of tests/test_spec_decode.py: a tiny target (seed 5) and draft
(seed 9) of 64 speech codes, f32, prompt bucket 32, the port on the CPU.

Held: `spec_accept` gives JAX's (n_accept, next token) at temperature 0,
forced acceptance included; `llm_generate_chunk_spec` gives JAX's tokens,
count, fill and acceptance over the same rounds; the engine's greedy
speculative tokens equal JAX's plain and speculative tokens at k = 1, 3,
6.  Tolerances: tokens exact; the single-round marginal within 4 sigma of
the multinomial proportion (+ 1e-3) per token; a stream with a draft
within 1e-5 of the plain stream (the same codes, decoded on another path
of the same f32 codec)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGML_F32, GGUFReader, write_voice_embedding
from miotts_tpu.models import llm as jl
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu.runtime import engine as je
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.ops.qmat import QdotRoute
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import few_torch_threads  # noqa: F401

N_SPEECH = 64
KW = dict(max_tokens=40, llm_dtype="float32", prompt_bucket=32,
          code_bucket=16)
TEXT = "speculative parity check"
MARGINAL_DRAWS = 20000


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
    p = {k: str(d / f"{k}.gguf") for k in ("codec", "target", "draft",
                                            "voice")}
    ccfg = write_synthetic_codec(p["codec"], n_codes=N_SPEECH, seed=3)
    write_synthetic_llm(p["target"], seed=5, n_speech=N_SPEECH)
    write_synthetic_llm(p["draft"], seed=9, n_speech=N_SPEECH)
    write_voice_embedding(p["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return p


def _port(paths, draft=None, **kw):
    """The port's engine on the CPU; draft "other", "self" or None."""
    cfg = dict(KW, **kw)
    return te.TTSEngine(te.EngineConfig(
        device="cpu", model_path=paths["target"], codec_path=paths["codec"],
        draft_model_path={"other": paths["draft"], "self": paths["target"],
                          None: ""}[draft], **cfg))


def _jax(paths, draft=None, **kw):
    cfg = dict(KW, **kw)
    return je.TTSEngine(je.EngineConfig(
        model_path=paths["target"], codec_path=paths["codec"],
        draft_model_path={"other": paths["draft"], "self": paths["target"],
                          None: ""}[draft], **cfg))


def _greedy(n, seed=42):
    return (je.Options(max_tokens=n, temperature=0.0, seed=seed),
            te.Options(max_tokens=n, temperature=0.0, seed=seed))


@pytest.fixture(scope="module")
def jax_plain(paths):
    """JAX's plain greedy tokens of TEXT, 33 tokens."""
    return _jax(paths).generate_tokens(TEXT, _greedy(33)[0])


# ---------------------------------------------------------------------------
# The acceptance rule
# ---------------------------------------------------------------------------

def _accept_case(seed, k, V=12):
    """Target logits [k + 1, V], draft logits [k, V] and draft tokens: the
    draft's argmaxes, with some rows set to the target's argmax (so a
    prefix is accepted) and one a random token."""
    rng = np.random.default_rng(seed)
    t_log = (rng.standard_normal((k + 1, V)) * 2).astype(np.float32)
    d_log = (rng.standard_normal((k, V)) * 2).astype(np.float32)
    n_match = int(rng.integers(0, k + 1))
    d_log[:n_match] = t_log[:n_match]
    drafts = d_log.argmax(-1).astype(np.int32)
    if seed % 3 == 0:
        drafts[-1] = int(rng.integers(0, V))
    return t_log, d_log, drafts


@pytest.mark.parametrize("force_p", [None, 1.0, 0.0])
@pytest.mark.parametrize("seed", range(6))
def test_spec_accept_matches_jax_greedy(seed, force_p):
    """Temperature 0: the port's n_accept and next token are JAX's on the
    same logits and drafts, under forced acceptance (p 1 and 0) too."""
    k = 1 + seed % 5
    t_log, d_log, drafts = _accept_case(seed, k)
    ja, jn = jl.spec_accept(
        jax.random.PRNGKey(seed), jnp.asarray(drafts), jnp.asarray(t_log),
        jnp.asarray(d_log), jnp.float32(0.0),
        None if force_p is None else jnp.float32(force_p))
    gen = torch.Generator().manual_seed(seed)
    ta, tn = tl.spec_accept(torch.from_numpy(drafts).long(),
                            torch.from_numpy(t_log), torch.from_numpy(d_log),
                            0.0, gen, force_p)
    assert (int(ta), int(tn)) == (int(ja), int(jn))
    if force_p is not None:
        assert int(ta) == (k if force_p == 1.0 else 0)


def test_spec_accept_marginal_is_the_target_distribution():
    """One round at temperature 1 (k = 1): d ~ p_d, then accept or draw the
    residual; the emitted token is distributed as p_t.  Bound: 4 sigma of
    the multinomial proportion over MARGINAL_DRAWS draws, + 1e-3."""
    V = 6
    rng = np.random.default_rng(0)
    t_log = torch.from_numpy((rng.standard_normal((2, V)) * 1.5)
                             .astype(np.float32))
    d_log = torch.from_numpy((rng.standard_normal((1, V)) * 1.5)
                             .astype(np.float32))
    p_d = torch.softmax(d_log[0], -1)
    gen = torch.Generator().manual_seed(1)
    counts = np.zeros(V)
    for _ in range(MARGINAL_DRAWS):
        d = torch.multinomial(p_d, 1, generator=gen)
        a, nxt = tl.spec_accept(d, t_log, d_log, 1.0, gen)
        counts[int(d[0]) if int(a) >= 1 else int(nxt)] += 1
    p_emp = counts / MARGINAL_DRAWS
    p_t = torch.softmax(t_log[0], -1).numpy()
    tol = 4.0 * np.sqrt(p_t * (1 - p_t) / MARGINAL_DRAWS) + 1e-3
    assert np.all(np.abs(p_emp - p_t) < tol), (p_emp, p_t)


# ---------------------------------------------------------------------------
# The chunk: the port's rounds against JAX's device loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft,k,n_steps", [("other", 2, 5),
                                             ("self", 3, 10)])
def test_generate_chunk_spec_matches_jax(paths, draft, k, n_steps):
    """From the same prefills, the port's chunk of as many rounds as JAX's
    loop ran (limit n_steps tokens) gives JAX's tokens, count, fills,
    pending token, rounds and acceptance."""
    d_path = paths["draft" if draft == "other" else "target"]
    S, n = 128, 19
    ids = np.random.default_rng(4).integers(0, 256 + 3 + N_SPEECH, n)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :n] = ids
    out = {}
    with GGUFReader(paths["target"]) as r, GGUFReader(d_path) as rd:
        jcfg, jdcfg = jl.LLMConfig.from_gguf(r), jl.LLMConfig.from_gguf(rd)
        jp, _ = jl.load_llm_params(r, jcfg, dtype=jnp.float32)
        jdp, _ = jl.load_llm_params(rd, jdcfg, dtype=jnp.float32)
        tp, tcfg = tl.load_llm_params(r, dtype=torch.float32)
        tdp, tdcfg = tl.load_llm_params(rd, dtype=torch.float32)
    stop = [2, 3]
    # JAX
    c = jl.init_kv_cache(jcfg, 1, S, dtype=jnp.float32)
    dc = jl.init_kv_cache(jdcfg, 1, S, dtype=jnp.float32)
    last, c = jl.llm_prefill(jp, jnp.asarray(toks), jnp.asarray([n]), c, jcfg)
    _, dc = jl.llm_prefill(jdp, jnp.asarray(toks), jnp.asarray([n]), dc,
                           jdcfg)
    pending = jnp.argmax(last, -1).astype(jnp.int32)
    buf, cnt, done, pend, c, dc, _, rounds, acc = jl.llm_generate_chunk_spec(
        jp, jdp, pending, c, dc, jax.random.PRNGKey(0), jnp.float32(0.0),
        jnp.asarray(stop, jnp.int32), jcfg, jdcfg, n_steps, k)
    out["jax"] = (np.asarray(buf)[:int(cnt)].tolist(), int(cnt), bool(done),
                  int(pend[0]), int(c["fill"][0]), int(dc["fill"][0]),
                  int(rounds), int(acc))
    # the port
    c = tl.init_kv_cache(tcfg, 1, S, dtype=torch.float32)
    dc = tl.init_kv_cache(tdcfg, 1, S, dtype=torch.float32)
    last, c = tl.llm_prefill(tp, torch.from_numpy(toks).long(),
                             torch.tensor([n]), c, tcfg)
    _, dc = tl.llm_prefill(tdp, torch.from_numpy(toks).long(),
                           torch.tensor([n]), dc, tdcfg)
    pending = torch.argmax(last, -1)
    buf, cnt, done, pend, c, dc, rounds, acc = tl.llm_generate_chunk_spec(
        tp, tdp, pending, c, dc, 0.0, torch.tensor(stop), tcfg, tdcfg,
        out["jax"][6], k, limit=torch.tensor(n_steps))
    out["port"] = (buf[:int(cnt)].tolist(), int(cnt), bool(done),
                   int(pend[0]), int(c["fill"][0]), int(dc["fill"][0]),
                   int(rounds), int(acc))
    assert out["port"] == out["jax"]
    assert out["port"][1] >= n_steps
    if draft == "self":
        assert out["port"][7] == k * out["port"][6]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [1, 3, 6])
def test_spec_greedy_matches_jax(paths, jax_plain, spec_k):
    """Greedy speculative tokens of the port = JAX's plain greedy tokens =
    JAX's speculative tokens, at k = 1, 3, 6 (chunk boundaries included)."""
    jopt, topt = _greedy(33)
    jspec = _jax(paths, "other", spec_tokens=spec_k).generate_tokens(TEXT,
                                                                      jopt)
    eng = _port(paths, "other", spec_tokens=spec_k)
    got = eng.generate_tokens(TEXT, topt)
    assert got == jax_plain == jspec
    st = eng._spec_stats
    assert st["rounds"] > 0 and 0 <= st["accepted"] <= st["drafted"]
    assert st["drafted"] == spec_k * st["rounds"]


def test_spec_self_draft_accepts_everything(paths, jax_plain):
    eng = _port(paths, "self", spec_tokens=4)
    assert eng.generate_tokens(TEXT, _greedy(33)[1]) == jax_plain
    st = eng._spec_stats
    assert st["drafted"] > 0 and st["accepted"] == st["drafted"]


@pytest.mark.parametrize("draft", ["other", "self"])
def test_spec_respects_max_tokens(paths, jax_plain, draft):
    got = _port(paths, draft, spec_tokens=5).generate_tokens(
        TEXT, _greedy(7)[1])
    assert got == jax_plain[:7]


def test_spec_small_context(paths, monkeypatch):
    """n_ctx just above the prompt: the budget is clamped to n_ctx - n -
    (k + 1), the tokens are JAX's, and every verify of an active round
    writes k + 1 distinct positions below the last cache column (none
    clamps onto it)."""
    k, n_ctx = 3, 64
    jopt, topt = _greedy(40)
    want = _jax(paths, "other", spec_tokens=k, n_ctx=n_ctx).generate_tokens(
        TEXT, jopt)
    eng = _port(paths, "other", spec_tokens=k, n_ctx=n_ctx)
    seen = []
    forward = tl.llm_forward

    def spy(params, tokens, pos, cache, cfg, advance=None):
        if tokens.shape[1] == k + 1:
            seen.append((pos[0].tolist(), int(cache["fill"][0]),
                         cache["k"].shape[3]))
        return forward(params, tokens, pos, cache, cfg, advance)

    monkeypatch.setattr(tl, "llm_forward", spy)
    got = eng.generate_tokens(TEXT, topt)
    assert got == want and len(got) > 0
    n_prompt = seen[0][1]
    assert len(got) == n_ctx - n_prompt - (k + 1)
    assert eng._cache["k"].shape[3] == n_ctx
    assert eng._spec_stats["accepted"] == 0    # every round active
    for pos, fill, s_max in seen:
        assert pos == list(range(fill, fill + k + 1)) and pos[-1] < s_max - 1


def test_spec_sampled_in_vocab_and_reproducible(paths):
    opts = te.Options(max_tokens=30, temperature=1.0, seed=7)
    got = _port(paths, "other", spec_tokens=4).generate_tokens("sampled run",
                                                              opts)
    assert 0 < len(got) <= 30
    assert all(0 <= t < 256 + 3 + N_SPEECH for t in got)
    again = _port(paths, "other", spec_tokens=4).generate_tokens(
        "sampled run", opts)
    assert again == got


def test_spec_warmup_then_generates(paths):
    eng = _port(paths, "other", spec_tokens=3)
    eng.warmup(max_codes=16, prompt_len=16)
    jopt, topt = _greedy(12)
    want = _jax(paths).generate_tokens("post warmup", jopt)
    assert eng.generate_tokens("post warmup", topt) == want


@pytest.mark.parametrize("p,k", [("1.0", 2), ("0.0", 7)])
def test_spec_force_accept_harness(paths, monkeypatch, p, k):
    """MIOTTS_SPEC_FORCE_ACCEPT = p: p = 1 accepts every draft (though the
    draft's and target's argmaxes disagree), p = 0 none."""
    monkeypatch.setenv("MIOTTS_SPEC_FORCE_ACCEPT", p)
    eng = _port(paths, "other", spec_tokens=k)
    got = eng.generate_tokens("forced acceptance run",
                              te.Options(max_tokens=24, temperature=0.8,
                                         seed=3))
    st = eng._spec_stats
    assert st["drafted"] > 0 and 0 < len(got) <= 24
    assert st["accepted"] == (st["drafted"] if p == "1.0" else 0)


def test_spec_refuses_hybrid_and_other_vocab(paths, tmp_path):
    lfm2 = str(tmp_path / "lfm2.gguf")
    write_synthetic_llm(lfm2, quant_type=GGML_F32, seed=4, cfg=jl.LLMConfig(
        arch="lfm2", n_layers=4, dim=64, n_heads=4, n_kv_heads=2,
        head_dim=16, ff_dim=128, n_vocab=256 + 3 + N_SPEECH, n_ctx=512,
        qkv_bias=False, qk_norm=True, rope_style="neox",
        layer_types=("conv", "attn", "conv", "attn"), conv_l_cache=3))
    small = str(tmp_path / "small_vocab.gguf")
    write_synthetic_llm(small, seed=9, n_speech=32)
    for target, draft, match in ((lfm2, paths["target"], "dense"),
                                 (paths["target"], lfm2, "dense"),
                                 (paths["target"], small, "vocab")):
        with pytest.raises(ValueError, match=match):
            te.TTSEngine(te.EngineConfig(
                device="cpu", model_path=target, codec_path=paths["codec"],
                draft_model_path=draft, llm_dtype="float32"))


def _stream(eng, voice, text, opts):
    chunks = []
    ok = eng.synthesize_stream(
        voice, text, lambda s, sr, last:
        (chunks.append(s.copy()) or True) if s is not None else True,
        options=opts)
    assert ok
    return np.concatenate(chunks)


def test_spec_stream_matches_plain_stream(paths, monkeypatch):
    """synthesize_stream with a draft takes the unfused path (the fused
    step is never called) and gives the plain (fused) stream's PCM within
    1e-5."""
    voice = te.VoiceModel(paths["voice"])
    opts = te.Options(max_tokens=30, temperature=0.0,
                      apply_peak_normalization=False)
    want = _stream(_port(paths), voice, "stream parity", opts)
    eng = _port(paths, "other", spec_tokens=3)

    def no_fused(*a, **kw):
        raise AssertionError("a stream with a draft took the fused path")

    monkeypatch.setattr(eng, "_stream_fused", no_fused)
    got = _stream(eng, voice, "stream parity", opts)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert eng._spec_stats["rounds"] > 0


def test_spec_engine_reuse_and_route(paths, jax_plain):
    """A second call on the same engine (both caches reused, fill reset)
    gives the same tokens; so does an engine of another route over the
    same weights, whose draft takes that route and has a cache of its
    own."""
    eng = _port(paths, "other", spec_tokens=3)
    topt = _greedy(33)[1]
    first = eng.generate_tokens(TEXT, topt)
    eng.generate_tokens("another request in between", topt)
    assert eng.generate_tokens(TEXT, topt) == first == jax_plain
    other = eng.with_qdot_route(QdotRoute(split=True))
    assert other.draft_params is not eng.draft_params
    assert other._dcache is None and eng._dcache is not None
    assert other.generate_tokens(TEXT, topt) == first
    assert other._spec_stats == eng._spec_stats


def test_with_draft_shares_the_weights(paths, jax_plain):
    """with_draft: a plain engine gains a draft (speculative tokens = JAX's
    plain greedy tokens), a speculative engine drops it ("" decodes plain,
    no spec stats) or changes k sharing its loaded draft; the target's
    weights are shared every time."""
    topt = _greedy(33)[1]
    plain = _port(paths)
    spec = plain.with_draft(paths["draft"], 3)
    assert spec.llm_params is plain.llm_params and plain.draft_params is None
    assert spec.generate_tokens(TEXT, topt) == jax_plain
    assert spec._spec_stats["rounds"] > 0
    again = spec.with_draft(paths["draft"], 6)
    assert again.draft_params is spec.draft_params
    assert again.config.spec_tokens == 6 and again._dcache is None
    assert again.generate_tokens(TEXT, topt) == jax_plain
    back = spec.with_draft("")
    assert back.draft_params is None
    assert back.generate_tokens(TEXT, topt) == jax_plain
    assert back._spec_stats is None
