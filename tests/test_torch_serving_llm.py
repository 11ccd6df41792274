"""The port's batched-serving LLM functions against the JAX package on a
tiny synthetic Q8_0 model (f32): slot prefill into a shared cache, and the
chunk-buffered batched decode over a float or int8 cache."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGML_Q8_0, GGUFReader
from miotts_tpu.models import llm as jl
from miotts_tpu.models.synthetic import synthetic_llm_config, write_synthetic_llm
from miotts_tpu.ops import decode_attn as jda
from miotts_tpu_torch.convert import kv_cache_from_numpy
from miotts_tpu_torch.models import llm as tl
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

N_SPEECH = 64
N_SLOTS = 4
S_CACHE = 128
BUCKET = 16
STEPS = 10


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    cfg = synthetic_llm_config(n_speech=N_SPEECH)
    path = str(tmp_path_factory.mktemp("sllm") / "llm.gguf")
    write_synthetic_llm(path, cfg=cfg, quant_type=GGML_Q8_0, seed=5)
    with GGUFReader(path) as r:
        jcfg = jl.LLMConfig.from_gguf(r)
        jp, _ = jl.load_llm_params(r, jcfg, dtype=jnp.float32)
        tp, tcfg = tl.load_llm_params(r, dtype=torch.float32, device="cpu")
    return jp, jcfg, tp, tcfg


def _np_cache(cache: dict) -> dict:
    return {k: np.array(v) for k, v in cache.items()}


def _start_cache(jcfg, quantized: bool, seed: int = 0) -> dict:
    """A JAX cache with random old contents in every slot (prefill must
    overwrite or mask them), as numpy."""
    c = _np_cache(jl.init_kv_cache(jcfg, N_SLOTS, S_CACHE, dtype=jnp.float32,
                                   quantized=quantized))
    rng = np.random.default_rng(seed)
    for k in ("k", "v"):
        if quantized:
            c[k] = rng.integers(-127, 128, c[k].shape).astype(np.int8)
            c[k + "_scale"] = rng.uniform(0.001, 0.02, c[k + "_scale"].shape
                                          ).astype(np.float32)
        else:
            c[k] = rng.standard_normal(c[k].shape).astype(np.float32)
    return c


def _prompts(lengths, seed=1):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), BUCKET), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, 256 + 3 + N_SPEECH, n)
    return toks, np.asarray(lengths, np.int32)


def _prefill_both(model, quantized, slots, lengths):
    jp, jcfg, tp, tcfg = model
    c0 = _start_cache(jcfg, quantized)
    toks, n_real = _prompts(lengths)
    jlast, jcache = jl.llm_prefill_slots(
        jp, jnp.asarray(toks), jnp.asarray(n_real),
        {k: jnp.asarray(v) for k, v in c0.items()},
        jnp.asarray(slots, jnp.int32), jcfg)
    tlast, tcache = tl.llm_prefill_slots(
        tp, torch.from_numpy(toks), torch.from_numpy(n_real),
        kv_cache_from_numpy(c0), torch.tensor(slots), tcfg)
    return np.asarray(jlast), _np_cache(jcache), tlast.numpy(), tcache


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_slots_matches_jax(model, quantized):
    """Two prompts into slots 3 and 1 of a 4-slot cache: logits and every
    cache field equal to JAX (1e-5; int8 values exact up to a rounding
    flip), untouched slots unchanged."""
    jlast, jc, tlast, tc = _prefill_both(model, quantized, [3, 1], [11, 7])
    assert rel_err(tlast, jlast) < 1e-5
    np.testing.assert_array_equal(tc["fill"].numpy(), jc["fill"])
    for k in jc:
        if k == "fill":
            continue
        got = tc[k].float().numpy()
        if k in ("k", "v") and quantized:
            # one step of 127 may flip where x / scale lands on .5
            assert np.mean(got != jc[k]) < 1e-3
            assert np.abs(got - jc[k]).max() <= 1
        else:
            assert rel_err(got, jc[k]) < 1e-5, k


def _chunk_both(model, quantized, attn_len):
    """Prefill slots 0, 2, 3 with staggered prompts (slot 1 idle), then one
    greedy chunk of STEPS steps through both packages."""
    jp, jcfg, tp, tcfg = model
    slots, lengths = [0, 2, 3], [11, 5, 14]
    jlast, jc, tlast, tc = _prefill_both(model, quantized, slots, lengths)
    jl_all = np.zeros((N_SLOTS, jlast.shape[-1]), np.float32)
    jl_all[slots] = jlast
    active = np.zeros(N_SLOTS, bool)
    active[slots] = True
    stop = np.asarray([jcfg.n_vocab - 1, -1], np.int32)
    jbuf, jact, _, jc2, _ = jl.llm_generate_chunk_batched(
        jp, jnp.asarray(jl_all), {k: jnp.asarray(v) for k, v in jc.items()},
        jnp.asarray(active), jax.random.split(jax.random.PRNGKey(0), N_SLOTS),
        jnp.zeros((N_SLOTS,), jnp.float32), jnp.asarray(stop), jcfg, STEPS,
        attn_len)
    tl_all = torch.zeros((N_SLOTS, tlast.shape[-1]))
    tl_all[slots] = torch.from_numpy(tlast)
    tbuf, tact, _, tc2, drawn = tl.llm_generate_chunk_batched(
        tp, tl_all, tc, torch.from_numpy(active),
        torch.arange(N_SLOTS, dtype=torch.int64),
        torch.zeros(N_SLOTS, dtype=torch.int64), torch.zeros(N_SLOTS),
        torch.from_numpy(stop), tcfg, STEPS, attn_len)
    return (np.asarray(jbuf), np.asarray(jact), _np_cache(jc2),
            tbuf.numpy(), tact.numpy(), tc2, drawn.numpy())


def _check_cache_after_merge(jc, tc, quantized):
    np.testing.assert_array_equal(tc["fill"].numpy(), jc["fill"])
    for k in jc:
        if k == "fill":
            continue
        # the last position is the parking slot of inactive columns, written
        # by a scatter with duplicate indices (either package may keep any)
        got = tc[k].float().numpy()[:, :, :, :S_CACHE - 1]
        want = jc[k].astype(np.float32)[:, :, :, :S_CACHE - 1]
        if k in ("k", "v") and quantized:
            assert np.mean(got != want) < 1e-3
            assert np.abs(got - want).max() <= 1
        else:
            assert rel_err(got, want) < 1e-5, k


@pytest.mark.parametrize("attn_len", [0, 64])
def test_generate_chunk_batched_greedy_matches_jax(model, attn_len):
    """f32 cache, temperature 0, 3 of 4 slots active with staggered prompts:
    identical tokens and stop flags, and the merged cache and fills equal
    to JAX (1e-5).  attn_len=64 reads a strided 64-key view of the
    128-position cache."""
    jbuf, jact, jc, tbuf, tact, tc, drawn = _chunk_both(model, False,
                                                        attn_len)
    np.testing.assert_array_equal(tbuf, jbuf)
    assert (tbuf[[0, 2, 3]] >= 0).any() and (tbuf[1] == -1).all()
    np.testing.assert_array_equal(tact, jact)
    _check_cache_after_merge(jc, tc, False)
    # drawn advances once per step while active
    assert drawn[1] == 0 and drawn[0] == STEPS


def test_generate_chunk_batched_int8_matches_jax_k6_route(model,
                                                          monkeypatch):
    """int8 cache: the port (always through K6, here its plain version)
    against the JAX chunk with its K6 route forced in interpret mode (the
    JAX default int8 path has no probability quantization).  Greedy tokens
    identical, merged int8 cache and scales equal."""
    monkeypatch.setattr(jda, "decode_attention_batched_supported",
                        lambda batch, s_len: True)
    monkeypatch.setattr(jl, "_attend_bkernel",
                        functools.partial(jl._attend_bkernel, interpret=True))
    monkeypatch.setenv("MIOTTS_ATTN_BTILE", "4")
    jax.clear_caches()          # no executable traced without the patch
    try:
        jbuf, jact, jc, tbuf, tact, tc, _ = _chunk_both(model, True, 0)
    finally:
        jax.clear_caches()
    np.testing.assert_array_equal(tbuf, jbuf)
    np.testing.assert_array_equal(tact, jact)
    _check_cache_after_merge(jc, tc, True)


def test_slot_uniform_is_splitmix64():
    """The sampler's uniforms are the splitmix64 stream of the seed (a
    pure-Python uint64 reference), and depend only on (seed, draw)."""
    def ref(seed, i):
        m = (1 << 64) - 1
        z = (seed + (i + 1) * 0x9E3779B97F4A7C15) & m
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
        z ^= z >> 31
        return (z >> 11) / float(1 << 53)
    seeds = torch.tensor([0, 1, 42, 2 ** 40 + 7, 123456789], dtype=torch.int64)
    for i in (0, 1, 5, 1000):
        got = tl.slot_uniform(seeds, torch.full_like(seeds, i))
        want = [ref(int(s), i) for s in seeds]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_tokens_slots_greedy_and_seeded():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    logits[2] = logits[1]
    temp = torch.tensor([0.0, 1.0, 1.0, 1.0])
    seed = torch.tensor([9, 7, 7, 8])
    drawn = torch.tensor([0, 3, 3, 3])
    tok = tl.sample_tokens_slots(logits, temp, seed, drawn)
    assert int(tok[0]) == int(torch.argmax(logits[0]))
    assert int(tok[1]) == int(tok[2])           # same seed and draw count
    # the draw lands where the row's CDF crosses the uniform
    p = torch.softmax(logits[1].double(), -1)
    u = float(tl.slot_uniform(seed[1:2], drawn[1:2])[0])
    assert float(p[:int(tok[1])].sum()) <= u + 1e-6
    assert u <= float(p[:int(tok[1]) + 1].sum()) + 1e-6


def test_single_stream_decode_over_int8_cache_matches_jax(model):
    """llm_prefill + llm_decode_step over an int8 cache (the deferred-write
    decode quantizes this token's k / v for the post-loop write): logits
    within 1e-5 of JAX's at every step, the same int8 values and scales."""
    jp, jcfg, tp, tcfg = model
    toks, n_real = _prompts([9])
    jc = jl.init_kv_cache(jcfg, 1, 64, dtype=jnp.float32, quantized=True)
    tc = kv_cache_from_numpy(_np_cache(jc))
    jlast, jc = jl.llm_prefill(jp, jnp.asarray(toks), jnp.asarray(n_real),
                               jc, jcfg)
    tlast, tc = tl.llm_prefill(tp, torch.from_numpy(toks),
                               torch.from_numpy(n_real), tc, tcfg)
    assert rel_err(tlast.numpy(), np.asarray(jlast)) < 1e-5
    for tok in (5, 77, 300):
        jlast, jc = jl.llm_decode_step(jp, jnp.asarray([tok], jnp.int32), jc,
                                       jcfg)
        tlast, tc = tl.llm_decode_step(tp, torch.tensor([tok]), tc, tcfg)
        assert rel_err(tlast.numpy(), np.asarray(jlast)) < 1e-5
    jc = _np_cache(jc)
    np.testing.assert_array_equal(tc["fill"].numpy(), jc["fill"])
    for k in ("k", "v"):
        got = tc[k].numpy().astype(np.int32)
        assert np.abs(got - jc[k]).max() <= 1 and np.mean(got != jc[k]) < 1e-3
        assert rel_err(tc[k + "_scale"].numpy(), jc[k + "_scale"]) < 1e-5
