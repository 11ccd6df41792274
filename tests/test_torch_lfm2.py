"""The port's LFM2 hybrid (gated short-conv + attention layers) against the
JAX package on the tiny config of tests/test_lfm2.py, with GGUFs written by
the JAX package's writer: config and cache shapes, prefill and stepwise
decode logits with the conv state (f32 within 1e-4, bf16 within 2e-2 of the
logit scale), padded prefill, Q8_0, the single-stream and batched chunk
loops, slot prefill, parameter conversion, the batcher, the engine and the
CLI, and the engine's conv-state reset between requests.

f32 tolerance 1e-4: the hybrid decode's attention (K5's plain version in
the port, JAX's XLA `_attend` on the CPU) is the same f32 softmax in
another summation order, compounded over the layers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGML_F32, GGML_Q8_0, GGUFReader, write_voice_embedding
from miotts_tpu.models import llm as jl
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu.runtime import batching as jb
from miotts_tpu.runtime import engine as je
from miotts_tpu_torch import cli as tcli
from miotts_tpu_torch.convert import kv_cache_from_numpy, llm_params_from_numpy
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.models import synthetic as tsyn
from miotts_tpu_torch.runtime import batching as tb
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import few_torch_threads, jax_tree_to_numpy, rel_err  # noqa: F401

LAYER_TYPES = ("conv", "attn", "conv", "attn")
N_SPEECH = 64
N_VOCAB = 256 + 3 + N_SPEECH
S_CACHE = 32
SEED = 9                # the seed of tests/test_lfm2.py's engine tests
F32_TOL = 1e-4
BF16_TOL = 2e-2


def _cfg(**kw):
    """tests/test_lfm2.py's tiny LFM2 (the JAX package's LLMConfig)."""
    return jl.LLMConfig(arch="lfm2", n_layers=4, dim=64, n_heads=4,
                        n_kv_heads=2, head_dim=16, ff_dim=96, n_vocab=N_VOCAB,
                        n_ctx=128, rope_style="neox", qkv_bias=False,
                        qk_norm=True, layer_types=LAYER_TYPES, conv_l_cache=3,
                        **kw)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lfm2")
    paths = {k: str(d / f"{k}.gguf") for k in ("llm", "llm_q8", "codec",
                                                 "voice")}
    write_synthetic_llm(paths["llm"], cfg=_cfg(), quant_type=GGML_F32,
                        seed=SEED)
    write_synthetic_llm(paths["llm_q8"], cfg=_cfg(), quant_type=GGML_Q8_0,
                        seed=SEED)
    ccfg = write_synthetic_codec(paths["codec"], n_codes=N_SPEECH, seed=3)
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    paths["dir"] = d
    return paths


def _load(path, jdt, tdt):
    with GGUFReader(path) as r:
        jcfg = jl.LLMConfig.from_gguf(r)
        jp, _ = jl.load_llm_params(r, jcfg, dtype=jdt)
        tp, tcfg = tl.load_llm_params(r, dtype=tdt, device="cpu")
    return jp, jcfg, tp, tcfg


@pytest.fixture(scope="module")
def models(files):
    return {"f32": _load(files["llm"], jnp.float32, torch.float32),
            "bf16": _load(files["llm"], jnp.bfloat16, torch.bfloat16),
            "q8": _load(files["llm_q8"], jnp.float32, torch.float32)}


def _np(cache: dict) -> dict:
    return {k: np.asarray(v, np.float32) if k != "fill" else np.asarray(v)
            for k, v in cache.items()}


def _tnp(cache: dict) -> dict:
    return {k: v.float().numpy() if k != "fill" else v.numpy()
            for k, v in cache.items()}


def _prompts(lengths, bucket, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), bucket), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, N_VOCAB, n)
    return toks, np.asarray(lengths, np.int32)


def _check_cache(tc: dict, jc: dict, tol: float):
    """fill exact, conv state and every k / v position below fill within
    `tol` of the scale."""
    np.testing.assert_array_equal(tc["fill"], jc["fill"])
    assert rel_err(tc["conv"], jc["conv"]) < tol
    for key in ("k", "v"):
        for b, f in enumerate(jc["fill"]):
            if f:
                assert rel_err(tc[key][:, b, :, :f],
                               jc[key][:, b, :, :f]) < tol


# ---------------------------------------------------------------------------
# Config, writer, cache
# ---------------------------------------------------------------------------

def test_config_and_cache_shapes_match_jax(models):
    _, jcfg, _, tcfg = models["f32"]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.layer_types == LAYER_TYPES
    assert tcfg.attn_layer_idx == (1, 3) and tcfg.conv_layer_idx == (0, 2)
    for quantized in (False, True):
        jc = jl.init_kv_cache(jcfg, 2, S_CACHE, dtype=jnp.bfloat16,
                              quantized=quantized)
        tc = tl.init_kv_cache(tcfg, 2, S_CACHE, dtype=torch.bfloat16,
                              quantized=quantized)
        assert tc.keys() == jc.keys()
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape, k
            assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
    assert tuple(tc["conv"].shape) == (2, 2, 2, 64)     # [n_conv, B, L-1, dim]
    assert tuple(tc["k"].shape) == (2, 2, 2, S_CACHE, 16)   # attention only


def test_port_writer_matches_jax_writer(files, tmp_path):
    """The port's own synthetic writer gives the JAX writer's file, byte
    for byte, for the hybrid config and seed (f32 and Q8_0)."""
    tcfg = tl.LLMConfig(**dataclasses.asdict(_cfg()))
    for quant, name in ((GGML_F32, "llm"), (GGML_Q8_0, "llm_q8")):
        path = tmp_path / f"port_{name}.gguf"
        tsyn.write_synthetic_llm(str(path), cfg=tcfg, quant_type=quant,
                                 seed=SEED)
        assert path.read_bytes() == open(files[name], "rb").read()


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _prefill_both(model, toks, n_real, jdt, tdt):
    jp, jcfg, tp, tcfg = model
    jc = jl.init_kv_cache(jcfg, len(n_real), S_CACHE, dtype=jdt)
    jlast, jc = jl.llm_prefill(jp, jnp.asarray(toks), jnp.asarray(n_real),
                               jc, jcfg)
    tc = tl.init_kv_cache(tcfg, len(n_real), S_CACHE, dtype=tdt)
    tlast, tc = tl.llm_prefill(tp, torch.from_numpy(toks),
                               torch.from_numpy(n_real), tc, tcfg)
    return np.asarray(jlast, np.float32), jc, tlast.numpy(), tc


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_logits_match_jax(models, dtype):
    """Two right-padded prompts (5 and 9 real tokens in a 12 bucket): last
    logits, conv state and the written k / v."""
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, F32_TOL),
                     "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}[dtype]
    toks, n_real = _prompts([5, 9], 12)
    jlast, jc, tlast, tc = _prefill_both(models[dtype], toks, n_real, jdt, tdt)
    assert np.isfinite(tlast).all()
    assert rel_err(tlast, jlast) < tol
    _check_cache(_tnp(tc), _np(jc), tol)


@pytest.mark.parametrize("model", ["f32", "q8"])
def test_stepwise_decode_matches_jax(models, model):
    """Prefill, then 6 teacher-forced decode steps through the hybrid
    write-first path (the port's K5 route): logits at every step, then the
    conv state and the cache, within 1e-4 (f32 and Q8_0 weights)."""
    jp, jcfg, tp, tcfg = models[model]
    toks, n_real = _prompts([5, 8], 8, seed=1)
    jlast, jc, tlast, tc = _prefill_both(models[model], toks, n_real,
                                         jnp.float32, torch.float32)
    assert rel_err(tlast, jlast) < F32_TOL
    steps = np.random.default_rng(2).integers(0, N_VOCAB, (6, 2))
    for t in steps.astype(np.int32):
        jlast, jc = jl.llm_decode_step(jp, jnp.asarray(t), jc, jcfg)
        tlast, tc = tl.llm_decode_step(tp, torch.from_numpy(t), tc, tcfg)
        assert rel_err(tlast.numpy(), np.asarray(jlast)) < F32_TOL
    _check_cache(_tnp(tc), _np(jc), F32_TOL)


def test_hybrid_decode_routes_through_decode_attention(models, monkeypatch):
    """A hybrid decode step reads its cache through `decode_attention` (K5)
    once per attention layer; the prefill does not."""
    _, _, tp, tcfg = models["f32"]
    calls = []
    plain = tl.decode_attention

    def counting(*args):
        calls.append(args[1].shape)
        return plain(*args)
    monkeypatch.setattr(tl, "decode_attention", counting)
    toks, n_real = _prompts([6], 8)
    cache = tl.init_kv_cache(tcfg, 1, S_CACHE, dtype=torch.float32)
    _, cache = tl.llm_prefill(tp, torch.from_numpy(toks),
                              torch.from_numpy(n_real), cache, tcfg)
    assert calls == []
    tl.llm_decode_step(tp, torch.tensor([3]), cache, tcfg)
    assert len(calls) == len(tcfg.attn_layer_idx) == 2


def test_padded_prefill_equals_unpadded(models):
    """A prompt right-padded to the bucket leaves the conv state and the
    last logits of the unpadded prompt, and the same next step (1e-5)."""
    _, _, tp, tcfg = models["f32"]
    toks, n_real = _prompts([5, 5], 12, seed=3)
    outs = []
    for width in (5, 12):
        cache = tl.init_kv_cache(tcfg, 2, S_CACHE, dtype=torch.float32)
        last, cache = tl.llm_prefill(tp, torch.from_numpy(toks[:, :width]),
                                     torch.from_numpy(n_real), cache, tcfg)
        conv = cache["conv"].clone()
        step, _ = tl.llm_decode_step(tp, torch.tensor([7, 300]), cache, tcfg)
        outs.append((last.numpy(), conv.numpy(), step.numpy()))
    for got, want in zip(outs[1], outs[0]):
        assert rel_err(got, want) < 1e-5


# ---------------------------------------------------------------------------
# Generation loops
# ---------------------------------------------------------------------------

def _chunk_both(model, stop_ids, n_steps=16):
    jp, jcfg, tp, tcfg = model
    toks, n_real = _prompts([7], 8, seed=4)
    jlast, jc, tlast, tc = _prefill_both(model, toks, n_real, jnp.float32,
                                         torch.float32)
    jbuf, jn, jdone, jlast, jc, _ = jl.llm_generate_chunk(
        jp, jnp.asarray(jlast), jc, jax.random.PRNGKey(0), jnp.float32(0.0),
        jnp.asarray(stop_ids, jnp.int32), jcfg, n_steps)
    tbuf, tn, tdone, tlast, tc = tl.llm_generate_chunk(
        tp, torch.from_numpy(tlast), tc, 0.0, torch.tensor(stop_ids), tcfg,
        n_steps)
    return ((np.asarray(jbuf), int(jn), bool(jdone), np.asarray(jlast),
             _np(jc)),
            (tbuf.numpy(), int(tn), bool(tdone), tlast.numpy(), _tnp(tc)))


def test_generate_chunk_greedy_matches_jax(models):
    """16 greedy steps of the on-device chunk: identical tokens, count and
    cache (conv state included)."""
    (jbuf, jn, jdone, jlast, jc), (tbuf, tn, tdone, tlast, tc) = \
        _chunk_both(models["f32"], [-1, -1])
    assert tbuf.tolist() == jbuf.tolist() and tn == jn == 16
    assert not tdone and not jdone
    assert rel_err(tlast, jlast) < F32_TOL
    _check_cache(tc, jc, F32_TOL)


def test_generate_chunk_stop_freezes_conv_state(models):
    """A stop token mid-chunk: the port runs the remaining steps masked
    (JAX skips them) and leaves the tokens, the count, fill, the conv state
    and the written cache where JAX leaves them."""
    (jbuf, *_), _ = _chunk_both(models["f32"], [-1, -1])
    k = next(i for i in range(3, 16) if jbuf[i] not in jbuf[:i])
    (jbuf, jn, jdone, jlast, jc), (tbuf, tn, tdone, tlast, tc) = \
        _chunk_both(models["f32"], [int(jbuf[k]), -1])
    assert tn == jn == k and tdone and jdone
    assert tbuf.tolist() == jbuf.tolist()
    assert rel_err(tlast, jlast) < F32_TOL
    _check_cache(tc, jc, F32_TOL)


@pytest.mark.parametrize("attn_len", [0, 16])
def test_generate_chunk_batched_matches_jax(models, attn_len):
    """3 slots, slot 1 idle, 6 greedy steps (tests/test_lfm2.py's
    chunk-buffered protocol): identical tokens and fills, conv state (the
    idle slot's unchanged) and merged cache within 1e-4; attn_len 16 reads
    a strided 16-key view of the 32-position cache."""
    jp, jcfg, tp, tcfg = models["f32"]
    toks, n_real = _prompts([5, 8, 3], 8, seed=5)
    jlast, jc, tlast, tc = _prefill_both(models["f32"], toks, n_real,
                                         jnp.float32, torch.float32)
    conv0 = tc["conv"].clone()
    active = np.asarray([True, False, True])
    W = 6
    jbuf, jact, jl2, jc2, _ = jl.llm_generate_chunk_batched(
        jp, jnp.asarray(jlast), jc, jnp.asarray(active),
        jax.random.split(jax.random.PRNGKey(0), 3), jnp.zeros((3,), jnp.float32),
        jnp.asarray([-7], jnp.int32), jcfg, W, attn_len)
    tbuf, tact, tl2, tc2, _ = tl.llm_generate_chunk_batched(
        tp, torch.from_numpy(tlast), tc, torch.from_numpy(active),
        torch.arange(3, dtype=torch.int64), torch.zeros(3, dtype=torch.int64),
        torch.zeros(3), torch.tensor([-7]), tcfg, W, attn_len)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    assert (tbuf[1] == -1).all() and (tbuf[[0, 2]] >= 0).all()
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(tc2["fill"].numpy(), n_real + W * active)
    assert rel_err(tl2[[0, 2]].numpy(), np.asarray(jl2)[[0, 2]]) < F32_TOL
    assert torch.equal(tc2["conv"][:, 1], conv0[:, 1])
    _check_cache(_tnp(tc2), _np(jc2), F32_TOL)


def test_prefill_slots_writes_conv_state(models):
    """Two prompts into slots 2 and 0 of a 3-slot cache whose old k / v and
    conv state are random: logits, fills, every slot's conv state (slot 1
    untouched) and the written k / v as JAX."""
    jp, jcfg, tp, tcfg = models["f32"]
    c0 = _np(jl.init_kv_cache(jcfg, 3, S_CACHE, dtype=jnp.float32))
    rng = np.random.default_rng(6)
    for k in ("k", "v", "conv"):
        c0[k] = rng.standard_normal(c0[k].shape).astype(np.float32)
    toks, n_real = _prompts([6, 11], 16, seed=7)
    slots = np.asarray([2, 0], np.int32)
    jlast, jc = jl.llm_prefill_slots(
        jp, jnp.asarray(toks), jnp.asarray(n_real),
        {k: jnp.asarray(v) for k, v in c0.items()}, jnp.asarray(slots), jcfg)
    tlast, tc = tl.llm_prefill_slots(
        tp, torch.from_numpy(toks), torch.from_numpy(n_real),
        kv_cache_from_numpy(c0), torch.from_numpy(slots), tcfg)
    assert rel_err(tlast.numpy(), np.asarray(jlast)) < F32_TOL
    np.testing.assert_array_equal(tc["conv"][:, 1].numpy(), c0["conv"][:, 1])
    _check_cache(_tnp(tc), _np(jc), F32_TOL)


def test_llm_params_from_numpy_hybrid_tree(models, files):
    """A JAX "layers" tree (Q8_0) converts to the port's own GGUF load,
    tensor for tensor, and gives the same logits."""
    jp, _, tp, tcfg = models["q8"]
    conv = llm_params_from_numpy(jax_tree_to_numpy(jp))
    assert "layers" in conv and "blocks" not in conv
    for lc, lt in zip(conv["layers"], tp["layers"]):
        assert lc.keys() == lt.keys()
        for k in lc:
            if isinstance(lc[k], torch.Tensor):
                assert torch.equal(lc[k], lt[k]), k
            else:
                for f in ("values", "scales"):
                    assert torch.equal(getattr(lc[k], f), getattr(lt[k], f))
    toks, n_real = _prompts([9], 12, seed=8)
    outs = []
    for params in (conv, tp):
        cache = tl.init_kv_cache(tcfg, 1, S_CACHE, dtype=torch.float32)
        outs.append(tl.llm_prefill(params, torch.from_numpy(toks),
                                   torch.from_numpy(n_real), cache,
                                   tcfg)[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# Runtime: batcher, engine, CLI
# ---------------------------------------------------------------------------

KW = dict(max_tokens=30, llm_dtype="float32", prompt_bucket=32, code_bucket=16)


@pytest.fixture(scope="module")
def engines(files):
    kw = dict(model_path=files["llm"], codec_path=files["codec"], **KW)
    return (je.TTSEngine(je.EngineConfig(**kw)),
            te.TTSEngine(te.EngineConfig(device="cpu", **kw)),
            te.VoiceModel(files["voice"]))


def _serve(batcher, voice, texts, opts):
    codes = {}
    for i, text in enumerate(texts):
        batcher.submit(text, voice, lambda *a: True, opts,
                       on_finish=lambda r, i=i: codes.__setitem__(
                           i, list(r.codes)))
    batcher.run_until_done(max_iters=200)
    assert batcher.pending == 0
    return codes


def test_batcher_serves_lfm2_greedy_like_jax(engines, files):
    """ContinuousBatcher over the hybrid model (2 slots, 10-step chunks, 3
    requests, so a slot is reused): every request drains, and at
    temperature 0 each request's codes equal the JAX batcher's."""
    jeng, teng, tvoice = engines
    texts = [f"lfm2 request {i}" for i in range(3)]
    tbat = tb.ContinuousBatcher(teng, n_slots=2, chunk_steps=10)
    assert "conv" in tbat.cache
    got = _serve(tbat, tvoice, texts, te.Options(max_tokens=20,
                                                  temperature=0.0))
    jbat = jb.ContinuousBatcher(jeng, n_slots=2, chunk_steps=10)
    want = _serve(jbat, je.VoiceModel(files["voice"]), texts,
                  je.Options(max_tokens=20, temperature=0.0))
    assert got == want and len(got) == 3 and any(got.values())


def test_engine_greedy_ids_match_fresh_jax_engine(files, engines):
    """Temperature 0 in f32: a fresh port engine and a fresh JAX engine
    give the same token ids."""
    kw = dict(model_path=files["llm"], codec_path=files["codec"], **KW)
    opts = dict(temperature=0.0, max_tokens=30)
    jids = je.TTSEngine(je.EngineConfig(**kw)).generate_tokens(
        "hello world", je.Options(**opts))
    tids = te.TTSEngine(te.EngineConfig(device="cpu", **kw)).generate_tokens(
        "hello world", te.Options(**opts))
    assert tids == jids and len(tids) > 0


def test_engine_reuse_resets_conv_state(files):
    """One text on a fresh engine and again after another request: the
    same greedy ids, because generate_tokens clears the conv state the
    previous request left in the reused cache.  The JAX engine keeps that
    state: on this model its second "hello world" turns from
    [64, 43, 111, 107, 133, 45, ...] to [64, 43, 111, 107, 100, 143, ...]."""
    eng = te.TTSEngine(te.EngineConfig(device="cpu", model_path=files["llm"],
                                       codec_path=files["codec"], **KW))
    opts = te.Options(temperature=0.0, max_tokens=30)
    fresh = eng.generate_tokens("hello world", opts)
    eng.generate_tokens("hello lfm2", opts)
    assert float(eng._cache["conv"].abs().max()) > 0
    assert eng.generate_tokens("hello world", opts) == fresh and fresh


def test_cli_synth_lfm2_cpu_writes_wav(files, tmp_path):
    out = str(tmp_path / "lfm2.wav")
    rc = tcli.main(["synth", "-m", files["llm"], "-c", files["codec"], "-v",
                    files["voice"], "-p", "hi there", "--max-tokens", "24",
                    "-t", "0", "--device", "cpu", "-o", out])
    assert rc == 0
    from miotts_tpu_torch.audio.wav import wav_read
    audio, sr = wav_read(out)
    assert sr == 44100 and audio.size > 0 and np.isfinite(audio).all()
