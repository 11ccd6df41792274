"""miotts_tpu_torch.models.llm against miotts_tpu.models.llm on tiny
synthetic Q8_0 models: prefill and decode logits, greedy tokens, bf16
agreement, and padded vs unpadded prefill."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGML_Q8_0, GGUFReader
from miotts_tpu.models import llm as jl
from miotts_tpu.models.synthetic import synthetic_llm_config, write_synthetic_llm
from miotts_tpu_torch.models import llm as tl
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

N_SPEECH = 64
PROMPT = 11
BUCKET = 16
S_CACHE = 64

VARIANTS = {
    "qwen2": dict(arch="qwen2"),           # neox RoPE, QKV bias
    "qwen3": dict(arch="qwen3"),           # neox RoPE, QK-norm
    "llama": dict(arch="llama"),           # norm (adjacent-pair) RoPE
    "qwen2_tied": dict(arch="qwen2", tie=True),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request, tmp_path_factory):
    v = VARIANTS[request.param]
    cfg = synthetic_llm_config(n_speech=N_SPEECH, arch=v["arch"])
    cfg = dataclasses.replace(cfg, rope_theta=1e6,
                              tie_embedding=v.get("tie", False))
    path = str(tmp_path_factory.mktemp("llm") / "llm.gguf")
    write_synthetic_llm(path, cfg=cfg, quant_type=GGML_Q8_0, seed=5)
    out = {}
    with GGUFReader(path) as r:
        for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                               ("bf16", jnp.bfloat16, torch.bfloat16)):
            jcfg = jl.LLMConfig.from_gguf(r)
            jp, _ = jl.load_llm_params(r, jcfg, dtype=jdt)
            tp, tcfg = tl.load_llm_params(r, dtype=tdt, device="cpu")
            out[name] = (jp, jcfg, tp, tcfg)
    return out


def _prompt(seed=0):
    ids = np.random.default_rng(seed).integers(0, 256 + 3 + N_SPEECH, PROMPT)
    toks = np.zeros((1, BUCKET), np.int32)
    toks[0, :PROMPT] = ids
    return toks


def _run_jax(jp, jcfg, toks, steps, dtype):
    cache = jl.init_kv_cache(jcfg, 1, S_CACHE, dtype=dtype)
    last, cache = jl.llm_prefill(jp, jnp.asarray(toks),
                                 jnp.asarray([PROMPT], jnp.int32), cache, jcfg)
    out = [np.asarray(last, np.float32)]
    for t in steps:
        last, cache = jl.llm_decode_step(jp, jnp.asarray([t], jnp.int32),
                                         cache, jcfg)
        out.append(np.asarray(last, np.float32))
    return out


def _run_torch(tp, tcfg, toks, steps, dtype):
    cache = tl.init_kv_cache(tcfg, 1, S_CACHE, dtype=dtype)
    last, cache = tl.llm_prefill(tp, torch.from_numpy(toks),
                                 torch.tensor([PROMPT]), cache, tcfg)
    out = [last.numpy()]
    for t in steps:
        last, cache = tl.llm_decode_step(tp, torch.tensor([t]), cache, tcfg)
        out.append(last.numpy())
    return out


def test_logits_match_jax_f32(models):
    """Prefill and 8 teacher-forced decode steps in f32: within 1e-5 of the
    logit scale (the same f32 math in another summation order)."""
    jp, jcfg, tp, tcfg = models["f32"]
    toks = _prompt()
    steps = list(np.random.default_rng(1).integers(0, tcfg.n_vocab, 8))
    want = _run_jax(jp, jcfg, toks, steps, jnp.float32)
    got = _run_torch(tp, tcfg, toks, steps, torch.float32)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, tcfg.n_vocab)
        assert rel_err(g, w) < 1e-5, (i, rel_err(g, w))


def test_greedy_tokens_match_jax_f32(models):
    """16 greedy steps through the on-device chunk loops: identical ids."""
    jp, jcfg, tp, tcfg = models["f32"]
    toks = _prompt(2)
    jc = jl.init_kv_cache(jcfg, 1, S_CACHE, dtype=jnp.float32)
    jlast, jc = jl.llm_prefill(jp, jnp.asarray(toks),
                               jnp.asarray([PROMPT], jnp.int32), jc, jcfg)
    jbuf, jn, _, _, _, _ = jl.llm_generate_chunk(
        jp, jlast, jc, jax.random.PRNGKey(0), jnp.float32(0.0),
        jnp.asarray([-1, -1], jnp.int32), jcfg, 16)
    tc = tl.init_kv_cache(tcfg, 1, S_CACHE, dtype=torch.float32)
    tlast, tc = tl.llm_prefill(tp, torch.from_numpy(toks),
                               torch.tensor([PROMPT]), tc, tcfg)
    tbuf, tn, tdone, _, tc = tl.llm_generate_chunk(
        tp, tlast, tc, 0.0, torch.tensor([-1, -1]), tcfg, 16)
    assert int(tn) == int(jn) == 16 and not bool(tdone)
    assert tbuf.tolist() == np.asarray(jbuf).tolist()
    assert int(tc["fill"][0]) == PROMPT + 16


def test_logits_match_jax_bf16(models):
    """bf16 activations and KV cache: within 2e-2 of the logit scale.  The
    port dequantizes in f32 (the TPU kernel's arithmetic) while JAX's CPU
    path dequantizes to bf16, and bf16 rounds (2^-8 relative) at every
    layer boundary in both; the gap is rounding noise, not a fault, and a
    near-tie argmax may flip."""
    jp, jcfg, tp, tcfg = models["bf16"]
    toks = _prompt(3)
    steps = list(np.random.default_rng(4).integers(0, tcfg.n_vocab, 4))
    want = _run_jax(jp, jcfg, toks, steps, jnp.bfloat16)
    got = _run_torch(tp, tcfg, toks, steps, torch.bfloat16)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g).all()
        assert rel_err(g, w) < 2e-2, (i, rel_err(g, w))


def test_padded_prefill_equals_unpadded(models):
    """A prompt right-padded to the bucket gives the same last logits and
    the same next decode step as the unpadded prompt (f32, 1e-5)."""
    _, _, tp, tcfg = models["f32"]
    toks = _prompt(5)
    outs = []
    for width in (PROMPT, BUCKET):
        cache = tl.init_kv_cache(tcfg, 1, S_CACHE, dtype=torch.float32)
        last, cache = tl.llm_prefill(tp, torch.from_numpy(toks[:, :width]),
                                     torch.tensor([PROMPT]), cache, tcfg)
        assert int(cache["fill"][0]) == PROMPT
        step, cache = tl.llm_decode_step(tp, torch.tensor([7]), cache, tcfg)
        outs.append((last.numpy(), step.numpy()))
    assert rel_err(outs[1][0], outs[0][0]) < 1e-5
    assert rel_err(outs[1][1], outs[0][1]) < 1e-5


def test_sampling_is_seeded(models):
    """Temperature > 0 draws from the torch generator: the same seed gives
    the same tokens (the JAX threefry stream is not reproducible here)."""
    _, _, tp, tcfg = models["f32"]
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, tcfg.n_vocab)).astype(np.float32))
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(11)
        draws.append([int(tl.sample_token(logits, 0.8, g)) for _ in range(8)])
    assert draws[0] == draws[1]
    assert int(tl.sample_token(logits, 0.0)) == int(logits.argmax())
