"""Sharded serving on the port, on the CPU (gloo ranks spawned per mesh,
tests/torch_parallel_workers.py): the serving chunk (llm_prefill_slots +
llm_generate_chunk_batched) token-exact against the JAX package's
single-device chunk, ContinuousBatcher(mesh=)'s audio against the
unsharded batcher's (1e-4; unfused and fused), on meshes (1, 2), (2, 1)
and (2, 2); and the multi-device dry run on 2 and 4 ranks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from miotts_tpu.gguf import GGUFReader, write_voice_embedding
from miotts_tpu.models.llm import (LLMConfig, init_kv_cache,
                                   llm_generate_chunk_batched,
                                   llm_prefill_slots, load_llm_params)
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu_torch.parallel.dryrun import dryrun_multichip
from miotts_tpu_torch.parallel.launch import launch
from torch_port_util import few_torch_threads  # noqa: F401

import torch_parallel_workers as W

MESHES = [(1, 2), (2, 1), (2, 2)]
CHUNK = dict(n_slots=4, ctx_len=64, chunk=8, slots=[0, 2],
             n_real=np.array([8, 5], np.int32))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tps")
    paths = {"codec": str(d / "codec.gguf"), "llm": str(d / "llm.gguf"),
             "voice": str(d / "voice.emb.gguf"), "tp": str(d / "tp.gguf")}
    ccfg = write_synthetic_codec(paths["codec"], n_codes=64, seed=3)
    write_synthetic_llm(paths["llm"], seed=5, n_speech=64)
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    # test_parallel.py's tp_model: 4 heads / 4 KV heads, f32
    write_synthetic_llm(paths["tp"], cfg=LLMConfig(
        arch="qwen2", n_layers=2, dim=64, n_heads=4, n_kv_heads=4,
        head_dim=16, ff_dim=128, n_vocab=256 + 3 + 64, n_ctx=256,
        rope_style="neox", qkv_bias=True, qk_norm=False), seed=1)
    return paths


@pytest.fixture(scope="module")
def chunk_in(files):
    with GGUFReader(files["tp"]) as r:
        cfg = LLMConfig.from_gguf(r)
    rng = np.random.default_rng(42)
    return dict(CHUNK, toks=rng.integers(0, cfg.n_vocab, (2, 8)),
                stop_ids=np.array([cfg.n_vocab - 1, cfg.n_vocab - 2]))


@pytest.fixture(scope="module")
def jax_chunk(files, chunk_in):
    """The JAX package's single-device serving chunk, greedy: two chunks
    (attention length 32, then the whole cache)."""
    with GGUFReader(files["tp"]) as r:
        cfg = LLMConfig.from_gguf(r)
        params, _ = load_llm_params(r, cfg, dtype=jnp.float32)
    n = chunk_in["n_slots"]
    cache = init_kv_cache(cfg, n, chunk_in["ctx_len"], dtype=jnp.float32)
    slots = jnp.asarray(chunk_in["slots"], jnp.int32)
    last, cache = llm_prefill_slots(
        params, jnp.asarray(chunk_in["toks"], jnp.int32),
        jnp.asarray(chunk_in["n_real"]), cache, slots, cfg)
    ll = jnp.zeros((n, cfg.n_vocab), jnp.float32).at[slots].set(last)
    active = jnp.zeros((n,), bool).at[slots].set(True)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    bufs = []
    for attn_len in (32, 0):
        buf, active, ll, cache, keys = llm_generate_chunk_batched(
            params, ll, cache, active, keys, jnp.zeros((n,), jnp.float32),
            jnp.asarray(chunk_in["stop_ids"], jnp.int32), cfg,
            chunk_in["chunk"], attn_len)
        bufs.append(np.asarray(buf))
    return dict(buf=np.stack(bufs), active=np.asarray(active),
                fill=np.asarray(cache["fill"]))


@pytest.fixture(scope="module")
def ranks(files, chunk_in):
    return {shape: launch(W.serving_rank, shape[0] * shape[1],
                          (shape[0], shape[1], files["tp"], chunk_in, files),
                          timeout=300)
            for shape in MESHES}


@pytest.fixture(scope="module")
def single_audio(files):
    return {fused: W.batcher_audio(files, None, fused)
            for fused in (False, True)}


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_serving_chunk_token_parity(ranks, jax_chunk, shape):
    """Every rank's gathered chunk buffers, active bits and fills equal the
    JAX package's single-device chunk (greedy), token for token."""
    for res in ranks[shape]:
        for key in ("buf", "active", "fill"):
            np.testing.assert_array_equal(res["chunk"][key], jax_chunk[key],
                                          err_msg=key)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_batcher_audio_parity(ranks, single_audio, shape, fused):
    """ContinuousBatcher(mesh=) on every rank: each request's audio equals
    the unsharded batcher's at 1e-4 (the JAX package's bound), chunk for
    chunk."""
    want = single_audio[fused]
    for res in ranks[shape]:
        for a, b in zip(res["audio"][fused], want):
            assert a.shape == b.shape and a.size > 0
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_cpu(n, capsys):
    res = dryrun_multichip(n, device="cpu", timeout=300)
    assert "dryrun_multichip OK" in capsys.readouterr().out
    assert res["served"] == 3 and res["samples"] > 0
