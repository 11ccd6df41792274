"""The port's single-stream int8 KV cache (EngineConfig.quantized_kv) and
its filtered sampler (models/llm.sample_token_filtered) against the JAX
package, on tiny synthetic models on the CPU.

Tolerances: greedy tokens identical (f32 logits that agree to ~1e-6; an
int8 rounding tie could move one quantized step, but none falls on these
inputs); the fused and unfused streams within 1e-4 (the codec's f32 sums
in another bucket, as tests/test_torch_stream.py); the filters' argmax
cases exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGML_F32, write_voice_embedding
from miotts_tpu.models import llm as jl
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu.runtime import engine as je
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import few_torch_threads  # noqa: F401

N_SPEECH = 64
KW = dict(max_tokens=30, llm_dtype="float32", prompt_bucket=32,
          code_bucket=16, quantized_kv=True)
STREAM_TOL = 1e-4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tqkv")
    p = {k: str(d / f"{k}.gguf") for k in ("codec", "llm", "draft", "lfm2",
                                            "voice")}
    ccfg = write_synthetic_codec(p["codec"], n_codes=N_SPEECH, seed=3)
    write_synthetic_llm(p["llm"], seed=5, n_speech=N_SPEECH)
    write_synthetic_llm(p["draft"], seed=9, n_speech=N_SPEECH)
    # tests/test_lfm2.py's tiny LFM2
    lfm2 = jl.LLMConfig(arch="lfm2", n_layers=4, dim=64, n_heads=4,
                        n_kv_heads=2, head_dim=16, ff_dim=96,
                        n_vocab=256 + 3 + N_SPEECH, n_ctx=128,
                        rope_style="neox", qkv_bias=False, qk_norm=True,
                        layer_types=("conv", "attn", "conv", "attn"),
                        conv_l_cache=3)
    write_synthetic_llm(p["lfm2"], cfg=lfm2, quant_type=GGML_F32, seed=9)
    write_voice_embedding(p["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return p


def _port(files, model="llm", **kw):
    return te.TTSEngine(te.EngineConfig(
        device="cpu", model_path=files[model], codec_path=files["codec"],
        **dict(KW, **kw)))


def _jax(files, model="llm", **kw):
    return je.TTSEngine(je.EngineConfig(
        model_path=files[model], codec_path=files["codec"],
        **dict(KW, **kw)))


@pytest.mark.parametrize("model", ["llm", "lfm2"])
def test_int8_greedy_tokens_match_jax(files, model):
    """tests/test_engine.py:test_engine_quantized_kv on both packages, dense
    and LFM2 (whose hybrid decode reads the int8 cache through K5's plain
    version here): 25 greedy tokens equal to the JAX quantized_kv engine's,
    over an int8 cache."""
    teng = _port(files, model)
    opts = dict(max_tokens=25, temperature=0.0, seed=42)
    text = "a longer utterance for int8"
    got = teng.generate_tokens(text, te.Options(**opts))
    want = _jax(files, model).generate_tokens(text, je.Options(**opts))
    assert teng._cache["k"].dtype == torch.int8 and "k_scale" in teng._cache
    assert got == want and len(got) == 25


@pytest.mark.parametrize("model", ["llm", "lfm2"])
def test_int8_sampled_reproducible(files, model):
    """The JAX package's own check: at temperature > 0 the same seed gives
    the same tokens over an int8 cache, and a warmed engine (warmup builds
    an int8 cache too) the same again."""
    eng = _port(files, model)
    opts = te.Options(max_tokens=25, seed=42, temperature=0.8)
    a = eng.generate_tokens("int8 kv", opts)
    b = eng.generate_tokens("int8 kv", opts)
    eng.warmup(max_codes=16, prompt_len=16)
    assert eng._cache["k"].dtype == torch.int8
    c = eng.generate_tokens("int8 kv", opts)
    assert a == b == c and len(a) > 0


def _stream(eng, voice, **cfg):
    for k, v in cfg.items():
        setattr(eng.config, k, v)
    out = []
    ok = eng.synthesize_stream(
        voice, "an int8 stream",
        lambda s, sr, last: s is None or out.append(np.asarray(s).copy())
        or True, options=te.Options(temperature=0.0, max_tokens=40))
    assert ok
    return np.concatenate(out)


@pytest.mark.parametrize("model", ["llm", "lfm2"])
def test_int8_fused_and_unfused_streams_agree(files, model):
    """The fused stream (_fused_chunk over llm_generate_chunk) and the
    unfused stream over an int8 cache: the same PCM within 1e-4."""
    eng = _port(files, model, holdback_codes=6, min_commit_step_codes=4,
                first_commit_codes=2)
    voice = te.VoiceModel(files["voice"])
    fused = _stream(eng, voice, fused_streaming=True)
    plain = _stream(eng, voice, fused_streaming=False)
    assert fused.shape == plain.shape and fused.size
    assert float(np.abs(fused - plain).max()) < STREAM_TOL


@pytest.mark.parametrize("k", [1, 3])
def test_int8_spec_decoding_matches_plain(files, k):
    """A draft on int8 caches (target and draft both take quantized_kv):
    the verify writes k + 1 positions and rolls fill back over an int8
    cache, and the speculative tokens at f32, temperature 0 are plain
    int8 greedy decoding's."""
    plain = _port(files).generate_tokens(
        "speculative int8", te.Options(max_tokens=30, temperature=0.0))
    spec = _port(files, draft_model_path=files["draft"], spec_tokens=k)
    got = spec.generate_tokens("speculative int8",
                               te.Options(max_tokens=30, temperature=0.0))
    assert spec._dcache["k"].dtype == torch.int8
    assert spec._spec_stats["rounds"] > 0
    assert got == plain and len(got) == 30


def test_sample_token_filtered_argmax_cases_match_jax():
    """tests/test_llm.py:test_filtered_sampling on both samplers: top-k=1,
    a tiny top-p and min-p=1 all give the argmax (the JAX sampler's too),
    and top-k=50 at a high temperature stays inside the top 50."""
    rng = np.random.default_rng(42)
    logits = (rng.standard_normal((2, 100)) * 3).astype(np.float32)
    jlog, tlog = jnp.asarray(logits), torch.from_numpy(logits)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    argmax = np.argmax(logits, -1)
    for kw in (dict(top_k=1), dict(top_p=1e-6), dict(min_p=1.0)):
        jkw = {k: (v if k == "top_k" else jnp.float32(v))
               for k, v in kw.items()}
        want = np.asarray(jl.sample_token_filtered(jlog, jnp.float32(2.0),
                                                   key, **jkw))
        got = tl.sample_token_filtered(tlog, 2.0, gen, **kw).numpy()
        np.testing.assert_array_equal(want, argmax)
        np.testing.assert_array_equal(got, argmax)
    for trial in range(5):
        gen.manual_seed(trial)
        got = tl.sample_token_filtered(tlog, 5.0, gen, top_k=50).numpy()
        for b in range(2):
            assert got[b] in np.argsort(-logits[b])[:50]


def test_sample_token_filtered_per_row_and_greedy_rows():
    """Per-row temperature / top-p / min-p ([B] tensors): a row at
    temperature 0 is greedy whatever its filters; a row with top-p 1 and
    min-p 0 samples the whole distribution (torch.multinomial's draw from
    the generator, reproducible per seed)."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy((rng.standard_normal((3, 50)) * 2)
                              .astype(np.float32))
    temp = torch.tensor([0.0, 1.0, 1.0])
    top_p = torch.tensor([0.5, 1.0, 1e-6])
    min_p = torch.tensor([0.0, 0.0, 0.0])
    draws = [tl.sample_token_filtered(logits, temp,
                                      torch.Generator().manual_seed(7),
                                      top_p=top_p, min_p=min_p)
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0][0]) == int(logits[0].argmax())
    assert int(draws[0][2]) == int(logits[2].argmax())
    seen = {int(tl.sample_token_filtered(
        logits, temp, torch.Generator().manual_seed(s), top_p=top_p)[1])
        for s in range(40)}
    assert len(seen) > 3
