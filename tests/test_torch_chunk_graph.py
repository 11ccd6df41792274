"""The batcher's serving state and its CUDA graphs of the unfused chunk
(miotts_tpu_torch.runtime.batching), on the CPU: where the graphs engage
(nowhere here: the CPU, a mesh and the fused step run eagerly), the state
allocated once and reset in place, the attention lengths a capture covers,
and the in-place updates of the chunk, admission and finishing held
against the JAX package's functional chunk over several chunks of a tiny
LFM2 (greedy tokens identical, f32 logits and cache within 1e-4, as
tests/test_torch_lfm2.py).  The graphs themselves run on the card:
tests/test_torch_chunk_graph_cuda.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGML_F32, GGUFReader, write_voice_embedding
from miotts_tpu.models import llm as jl
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu_torch.runtime import batching as tb
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

N_SPEECH = 64
F32_TOL = 1e-4
KW = dict(max_tokens=60, llm_dtype="float32", prompt_bucket=32,
          code_bucket=16)


def _cfg():
    """tests/test_torch_lfm2.py's tiny LFM2 with room for the batcher's
    prompts (n_ctx 512)."""
    return jl.LLMConfig(arch="lfm2", n_layers=4, dim=64, n_heads=4,
                        n_kv_heads=2, head_dim=16, ff_dim=96,
                        n_vocab=256 + 3 + N_SPEECH, n_ctx=512,
                        rope_style="neox", qkv_bias=False, qk_norm=True,
                        layer_types=("conv", "attn", "conv", "attn"),
                        conv_l_cache=3)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("chunkgraph")
    paths = {k: str(d / f"{k}.gguf") for k in ("llm", "codec", "voice")}
    write_synthetic_llm(paths["llm"], cfg=_cfg(), quant_type=GGML_F32, seed=9)
    ccfg = write_synthetic_codec(paths["codec"], n_codes=N_SPEECH, seed=3)
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return paths


@pytest.fixture(scope="module")
def engine(files):
    eng = te.TTSEngine(te.EngineConfig(model_path=files["llm"],
                                       codec_path=files["codec"],
                                       device="cpu", **KW))
    return eng, te.VoiceModel(files["voice"])


def _submit(b, voice, specs):
    """One greedy request per (text, max_tokens); returns the finished
    requests, in finishing order."""
    done = []
    for text, max_tok in specs:
        b.submit(text, voice, lambda s, sr, last: True,
                 te.Options(max_tokens=max_tok, temperature=0.0, seed=1),
                 on_finish=done.append)
    return done


def _state(b) -> list:
    return [*b.cache.values(), b.last_logits, b._active_dev, b._slot_seed,
            b._slot_drawn, b._slot_temp]


@pytest.mark.parametrize("device,mesh,fused,engages", [
    ("cuda", None, False, True),
    ("cuda", "mesh", False, False),
    ("cuda", None, True, False),
    ("cpu", None, False, False),
    ("cpu", "mesh", True, False),
])
def test_graphs_engage_on_an_unsharded_unfused_cuda_batcher(device, mesh,
                                                            fused, engages):
    assert tb.chunk_graphs_engage(torch.device(device), mesh,
                                  fused) is engages


def _one_rank_mesh():
    """A (1, 1) ('data', 'model') mesh's stand-in: what the batcher reads
    of a DeviceMesh at one rank (no collective runs)."""
    return types.SimpleNamespace(shape=(1, 1),
                                 mesh_dim_names=("data", "model"),
                                 get_local_rank=lambda axis: 0)


@pytest.mark.parametrize("kind", ["unfused", "fused", "mesh"])
def test_cpu_batchers_run_eagerly(engine, kind):
    """On the CPU, fused or under a mesh, warmup() captures nothing and no
    step is a replay: graph_steps and graph_captures stay 0."""
    eng, voice = engine
    b = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=8,
                             fused=kind == "fused",
                             mesh=_one_rank_mesh() if kind == "mesh" else None)
    b.warmup(prompt_len=16)
    done = _submit(b, voice, [("eager text a", 20), ("eager text b", 12),
                              ("eager text c", 16)])
    b.run_until_done(max_iters=200)
    assert len(done) == 3 and b.pending == 0
    assert b._graphs is None and b.stage["device_steps"] > 0
    assert b.stage["graph_steps"] == b.stage["graph_captures"] == 0


@pytest.mark.parametrize("quantized_kv", [False, True], ids=["f32", "int8"])
def test_reset_keeps_every_state_tensor_and_clears_it(engine, quantized_kv):
    """_reset_device_state after serving: the same tensors (data_ptr),
    the cache and logits zero, temperature and seed the engine's, no draw
    made, the device's active bits the host's."""
    eng, voice = engine
    cfgE = eng.config
    b = tb.ContinuousBatcher(eng, n_slots=3, chunk_steps=8,
                             quantized_kv=quantized_kv)
    before = [t.data_ptr() for t in _state(b)]
    b.submit("state text a", voice, lambda s, sr, last: True,
             te.Options(max_tokens=40, temperature=0.7, seed=77))
    b.submit("state text b", voice, lambda s, sr, last: True,
             te.Options(max_tokens=40, temperature=0.0, seed=5))
    for _ in range(3):
        b.step()
    assert b.active.any() and int(b.cache["fill"].max()) > 0
    assert int(b._slot_drawn.max()) > 0
    assert all(bool(t.ne(0).any()) for t in (b.cache["k"], b.cache["conv"],
                                              b.last_logits))
    b._reset_device_state()
    assert [t.data_ptr() for t in _state(b)] == before
    assert all(not bool(t.ne(0).any()) for t in b.cache.values())
    assert not bool(b.last_logits.ne(0).any())
    assert bool((b._slot_temp == cfgE.temperature).all())
    assert bool((b._slot_seed == cfgE.seed).all())
    assert not bool(b._slot_drawn.ne(0).any())
    np.testing.assert_array_equal(b._active_dev.numpy(), b.active)


@pytest.mark.parametrize("ctx_len", [64, 128, 300, 512, 1024])
def test_captured_lengths_are_every_attention_length(engine, ctx_len):
    """The lengths a capture covers (_graph_lens) are exactly the values
    _attn_len can return over every fill a slot can reach, 0 (the whole
    cache) first, and warmup()'s own chunk takes one of them."""
    eng, _ = engine
    b = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=20, ctx_len=ctx_len)
    b.active[1] = True
    seen = set()
    for fill in range(ctx_len + 1):
        b._fill_ub[1] = fill
        seen.add(b._attn_len())
    lens = b._graph_lens()
    assert sorted(seen) == sorted(lens) and lens[0] == 0
    assert len(set(lens)) == len(lens)
    for bucket in range(32, ctx_len + 1, 32):
        n = min(te._bucket_len(bucket + 20, 128), ctx_len)
        assert (0 if n >= ctx_len else n) in lens


def test_replays_count_their_steps_and_linears(engine):
    """A batcher whose graphs are stand-ins (the CPU captures none: each
    "replay" runs its chunk eagerly into the graph's token buffer) serves
    what an eager one serves at pipeline depth 2, through the copies of
    the token buffer that _chunk returns; every device step is a replay,
    each adding its graph's quantized linears' FLOPs and bytes to the
    stage; once a state tensor is reallocated the next chunk raises and
    replays nothing."""
    eng, voice = engine
    kw = dict(n_slots=2, chunk_steps=8)
    g, e = tb.ContinuousBatcher(eng, **kw), tb.ContinuousBatcher(eng, **kw)
    replays = []

    def stand_in(n):
        tokens = torch.full((2, 8), -7, dtype=torch.int64)

        def replay():
            replays.append(n)
            tokens.copy_(g._run_chunk(n))
        return types.SimpleNamespace(replay=replay), tokens, (7, 11)
    g._graphs = {n: stand_in(n) for n in g._graph_lens()}
    g._graph_key = g._state_key()
    specs = [("replay text a", 20), ("replay text b", 12),
             ("replay text c", 16)]
    done = {}
    for tag, b in (("g", g), ("e", e)):
        done[tag] = _submit(b, voice, specs)
        b.run_until_done(max_iters=200)
        assert len(done[tag]) == 3 and b.pending == 0
    assert ([(r.codes, r.n_tokens) for r in done["g"]]
            == [(r.codes, r.n_tokens) for r in done["e"]])
    n = len(replays)
    assert g.stage["graph_steps"] == g.stage["device_steps"] == 8 * n > 0
    assert (g.stage["graph_qdot_flops"], g.stage["graph_qdot_bytes"]) \
        == (7 * n, 11 * n)
    assert e.stage["graph_steps"] == e.stage["graph_qdot_flops"] == 0
    g.last_logits = g.last_logits.clone()
    with pytest.raises(RuntimeError, match="reallocated"):
        g._chunk(0)
    assert len(replays) == n


def test_recording_counts_each_quantized_product():
    """qmat.recording: one (2 M K N, weight as held + x + y bytes) a
    quantized product, nothing for a dense weight or outside the block;
    an inner block keeps its own list."""
    from miotts_tpu_torch.ops import qmat
    K, N, g = 64, 48, 32
    qt = qmat.QTensor(values=torch.ones((K, N), dtype=torch.int8),
                      scales=torch.full((K // g, N), 0.5), mins=None,
                      group=g)
    x = torch.randn(3, 5, K)
    want = (2 * 15 * K * N, K * N + 4 * (K // g) * N + 4 * 15 * (K + N))
    qmat.qdot(x, qt)
    with qmat.recording() as outer:
        y = qmat.qdot(x, qt)
        qmat.qdot(x, torch.randn(N, K))
        with qmat.recording() as inner:
            qmat.qdot(x[0], qt)
        qmat.qdot(x.bfloat16(), qt)
    assert y.shape == (3, 5, N)
    assert outer == [want, (2 * 15 * K * N,
                            K * N + 4 * (K // g) * N + 2 * 15 * (K + N))]
    assert inner == [(2 * 5 * K * N, K * N + 4 * (K // g) * N
                      + 4 * 5 * (K + N))]
    assert qmat._RECORDED is None


def test_in_place_state_follows_the_jax_chunk(files, engine):
    """Five greedy requests on three slots, chunks of 6 at both attention
    lengths of the 256-position cache: before each chunk
    the serving state is copied; the JAX package's functional chunk from
    that copy gives the same tokens, active bits and fill, and the logits
    of the rows still active, k / v below fill and conv state the
    batcher's tensors hold after it (1e-4), over chunks with admissions and
    finishes between them, every state tensor the one allocated at the
    start."""
    eng, voice = engine
    with GGUFReader(files["llm"]) as r:
        jcfg = jl.LLMConfig.from_gguf(r)
        jp, _ = jl.load_llm_params(r, jcfg, dtype=jnp.float32)
    b = tb.ContinuousBatcher(eng, n_slots=3, chunk_steps=6)
    ptrs = [t.data_ptr() for t in _state(b)]
    run, chunks = b._run_chunk, []

    def spied(attn_len):
        before = ({k: v.clone() for k, v in b.cache.items()},
                  b.last_logits.clone(), b._active_dev.clone())
        buf = run(attn_len)
        chunks.append((attn_len, before, buf.clone(),
                       {k: v.clone() for k, v in b.cache.items()},
                       b.last_logits.clone(), b._active_dev.clone()))
        return buf
    b._run_chunk = spied
    done = _submit(b, voice, [(f"in place text {i} " * 5, 16 + 16 * i)
                              for i in range(5)])
    b.run_until_done(max_iters=300)
    assert len(done) == 5 and b.pending == 0
    assert {c[0] for c in chunks} == set(b._graph_lens()) == {128, 0}
    assert [t.data_ptr() for t in _state(b)] == ptrs
    # between chunks a slot ends (its active bit drops) and a slot is
    # prefilled again (its fill falls back to a prompt's length)
    pairs = list(zip(chunks, chunks[1:]))
    assert any(bool(c[1][2][s]) and not bool(n[1][2][s])
               for c, n in pairs for s in range(3))
    assert any(int(n[1][0]["fill"][s]) < int(c[3]["fill"][s])
               for c, n in pairs for s in range(3))
    stop_ids = jnp.asarray(eng._stop_ids.numpy(), jnp.int32)
    for attn_len, (cache, last, active), buf, c_after, l_after, a_after \
            in chunks:
        jc = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
        jbuf, jact, jlast, jc2, _ = jl.llm_generate_chunk_batched(
            jp, jnp.asarray(last.numpy()), jc, jnp.asarray(active.numpy()),
            jax.random.split(jax.random.PRNGKey(0), 3),
            jnp.zeros((3,), jnp.float32), stop_ids, jcfg, 6, attn_len)
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
        np.testing.assert_array_equal(a_after.numpy(), np.asarray(jact))
        jc2 = {k: np.asarray(v) for k, v in jc2.items()}
        np.testing.assert_array_equal(c_after["fill"].numpy(), jc2["fill"])
        rows = a_after.numpy()      # a stopped row's logits are not kept
        if rows.any():
            assert rel_err(l_after.numpy()[rows],
                           np.asarray(jlast)[rows]) < F32_TOL
        assert rel_err(c_after["conv"].numpy(), jc2["conv"]) < F32_TOL
        for key in ("k", "v"):
            for s, f in enumerate(jc2["fill"]):
                if f:
                    assert rel_err(c_after[key].numpy()[:, s, :, :f],
                                   jc2[key][:, s, :, :f]) < F32_TOL
