"""The port's continuous batcher (miotts_tpu_torch.runtime.batching) on tiny
synthetic models, on the CPU: the JAX package's batching tests on the
port, and one greedy run against the JAX batcher (codes identical, PCM
within 1e-4)."""

import numpy as np
import pytest

from miotts_tpu.gguf import write_voice_embedding
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu.runtime import batching as jb
from miotts_tpu.runtime import engine as je
from miotts_tpu_torch.runtime import batching as tb
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import few_torch_threads  # noqa: F401

KW = dict(max_tokens=60, llm_dtype="float32", prompt_bucket=32,
          code_bucket=16)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tbmodels")
    paths = {"codec": str(d / "codec.gguf"), "llm": str(d / "llm.gguf"),
             "voice": str(d / "voice.emb.gguf")}
    ccfg = write_synthetic_codec(paths["codec"], n_codes=64, seed=3)
    write_synthetic_llm(paths["llm"], seed=5, n_speech=64)
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return paths


@pytest.fixture(scope="module")
def engine(files):
    eng = te.TTSEngine(te.EngineConfig(model_path=files["llm"],
                                       codec_path=files["codec"],
                                       device="cpu", **KW))
    return eng, te.VoiceModel(files["voice"])


def _run(batcher, voice, specs, texts=None):
    """Submit one request per spec (max_tokens, temperature, seed) and run
    to completion.  Returns ({i: codes}, {i: concatenated PCM},
    {i: chunk count}, {i: request})."""
    codes, pcm, n_chunks, reqs = {}, {}, {}, {}

    def make_cb(i):
        pcm[i] = []

        def cb(samples, sr, is_last):
            if samples is not None:
                pcm[i].append(np.asarray(samples).copy())
            return True
        return cb

    def make_fin(i):
        def fin(r):
            codes[i] = list(r.codes)
            reqs[i] = r
        return fin

    for i, (max_tok, temp, seed) in enumerate(specs):
        text = texts[i] if texts else f"batched text {i}"
        batcher.submit(text, voice, make_cb(i),
                       te.Options(max_tokens=max_tok, temperature=temp,
                                  seed=seed), on_finish=make_fin(i))
    batcher.run_until_done(max_iters=400)
    assert batcher.pending == 0
    for i in pcm:
        n_chunks[i] = len(pcm[i])
        pcm[i] = (np.concatenate(pcm[i]) if pcm[i]
                  else np.zeros(0, np.float32))
    return codes, pcm, n_chunks, reqs


def test_concurrent_requests_complete(engine):
    eng, voice = engine
    batcher = tb.ContinuousBatcher(eng, n_slots=3, chunk_steps=10)
    codes, pcm, _, reqs = _run(batcher, voice, [(40, 1.0, -1)] * 5)
    assert len(reqs) == 5
    spt = eng.codec_cfg.samples_per_token
    for i, r in reqs.items():
        assert r.done and r.n_tokens <= 40
        # every committed code is emitted once: len(codes) * spt samples
        if not r.failed:
            assert pcm[i].size == len(codes[i]) * spt
            assert np.isfinite(pcm[i]).all() and np.abs(pcm[i]).max() <= 1.0


def test_more_requests_than_slots(engine):
    eng, voice = engine
    batcher = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=10)
    _, _, _, reqs = _run(batcher, voice, [(25, 1.0, -1)] * 4)
    assert sorted(reqs) == [0, 1, 2, 3]
    assert batcher.stage["prefills"] >= 2      # slots were reused


def test_per_request_seed_and_temperature(engine):
    """A request's samples are a function of its own seed (reproducible
    across runs and batch compositions, independent of neighbours), and
    temperature-0 slots decode greedily."""
    eng, voice = engine

    def run(specs):
        batcher = tb.ContinuousBatcher(eng, n_slots=4, chunk_steps=10)
        codes, *_ = _run(batcher, voice, [(30, t, s) for s, t in specs],
                         texts=["the same text"] * len(specs))
        return codes

    a = run([(7, 1.0), (7, 1.0), (9, 1.0), (7, 0.0)])
    assert a[0] == a[1]            # same seed + text, concurrent slots
    assert a[0] != a[2]            # different seed
    b = run([(7, 1.0)])            # different batch composition
    assert b[0] == a[0]
    g = run([(1, 0.0), (2, 0.0)])  # greedy ignores the seed
    assert g[0] == g[1] == a[3]


@pytest.mark.parametrize("depth", [2, 3])
def test_pipeline_depth_parity(engine, depth):
    """Chunk dispatch pipelining is invisible when slots are not reused:
    the same audio and emission schedule as the unpipelined loop."""
    eng, voice = engine
    specs = [(35, 1.0, 20 + i) for i in range(3)]
    base = _run(tb.ContinuousBatcher(eng, n_slots=3, chunk_steps=10,
                                     pipeline_depth=1), voice, specs)
    got = _run(tb.ContinuousBatcher(eng, n_slots=3, chunk_steps=10,
                                    pipeline_depth=depth), voice, specs)
    assert got[0] == base[0]
    for i in base[1]:
        assert got[2][i] == base[2][i]
        np.testing.assert_allclose(got[1][i], base[1][i], atol=1e-5)


def _with_config(eng, **kw):
    saved = {k: getattr(eng.config, k) for k in kw}
    for k, v in kw.items():
        setattr(eng.config, k, v)
    return saved


def test_pipelined_batcher_matches_sync(engine):
    """pipeline_codec: identical emitted audio per stream as the
    synchronous path (same decodes and commits, deferred read-back)."""
    eng, voice = engine
    specs = [(120, 1.0, 40 + i) for i in range(2)]
    outs = {}
    for pipe in (False, True):
        saved = _with_config(eng, pipeline_codec=pipe, holdback_codes=6,
                             min_commit_step_codes=4)
        try:
            outs[pipe] = _run(tb.ContinuousBatcher(eng, n_slots=2,
                                                   chunk_steps=10),
                              voice, specs)
        finally:
            _with_config(eng, **saved)
    assert outs[True][0] == outs[False][0]
    for i in outs[False][1]:
        assert outs[True][1][i].shape == outs[False][1][i].shape
        np.testing.assert_allclose(outs[True][1][i], outs[False][1][i],
                                   atol=1e-6)


def test_windowed_batcher_matches_full(engine):
    """stream_window_codes: the same emitted sample totals as full-prefix
    re-decode at the same seeds, with bounded drift (window-local
    GroupNorm statistics only)."""
    eng, voice = engine
    specs = [(120, 1.0, 60 + i) for i in range(2)]
    outs = {}
    for window in (0, 8):
        saved = _with_config(eng, stream_window_codes=window,
                             holdback_codes=6, min_commit_step_codes=4)
        try:
            outs[window] = _run(tb.ContinuousBatcher(eng, n_slots=2,
                                                     chunk_steps=10),
                                voice, specs)
        finally:
            _with_config(eng, **saved)
    for i in outs[0][1]:
        a, b = outs[0][1][i], outs[8][1][i]
        assert a.shape == b.shape
        if a.size:
            rmse = float(np.sqrt(np.mean((a - b) ** 2)))
            assert rmse / (float(np.sqrt(np.mean(a ** 2))) + 1e-9) < 0.3


def test_max_tokens_budget_not_overshot(engine):
    eng, voice = engine
    batcher = tb.ContinuousBatcher(eng, n_slots=1, chunk_steps=10)
    _, _, _, reqs = _run(batcher, voice, [(13, 1.0, 3)])
    assert reqs[0].n_tokens <= 13 and len(reqs[0].codes) <= 13


def test_overlong_prompt_rejected_not_fatal(engine):
    """A prompt that cannot fit ctx_len fails only that request (final
    callback + on_finish with failed=True); the other one completes."""
    eng, voice = engine
    batcher = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=10)
    assert batcher.ctx_len <= 512
    long_text = " ".join(f"w{i}" for i in range(2 * batcher.ctx_len))
    finished, finals = {}, []

    def cb_long(samples, sr, is_last):
        if is_last:
            finals.append(samples)
        return True

    batcher.submit(long_text, voice, cb_long,
                   te.Options(max_tokens=40, temperature=1.0),
                   on_finish=lambda r: finished.setdefault("long", r))
    batcher.submit("short one", voice, lambda s, sr, last: True,
                   te.Options(max_tokens=30, temperature=1.0),
                   on_finish=lambda r: finished.setdefault("short", r))
    batcher.run_until_done(max_iters=200)
    assert batcher.pending == 0
    assert finished["long"].failed and finished["long"].done
    assert finals == [None]
    assert not finished["short"].failed


def test_admit_wave_staggers_and_preserves_output(engine):
    """admit_wave caps admissions per step; per-request sampling state
    makes the codes and audio independent of the admission schedule."""
    eng, voice = engine
    specs = [(25, 1.0, 100 + i) for i in range(5)]
    c0, s0, _, _ = _run(tb.ContinuousBatcher(eng, n_slots=4, chunk_steps=10),
                        voice, specs)
    b2 = tb.ContinuousBatcher(eng, n_slots=4, chunk_steps=10, admit_wave=2)
    c2, s2, _, _ = _run(b2, voice, specs)
    assert c2 == c0
    for i in s0:
        np.testing.assert_array_equal(s2[i], s0[i])
    assert b2.stage["prefills"] >= 3


def test_unported_modes_raise(engine):
    """Sharded serving is ported (tests/test_torch_parallel_serving.py) and
    refuses an engine whose weights are not sharded over the mesh's
    'model' axis (a stand-in for a (1, 2) DeviceMesh: the check reads its
    shape before any collective); the fused batch step is ported
    (tests/test_torch_fused_batching.py)."""
    import types
    eng, _ = engine
    mesh = types.SimpleNamespace(shape=(1, 2), mesh_dim_names=("data", "model"))
    with pytest.raises(ValueError, match="shard_llm_params"):
        tb.ContinuousBatcher(eng, n_slots=2, mesh=mesh)
    assert tb.ContinuousBatcher(eng, n_slots=2, fused=True).use_fused


def test_warmup_then_serves_like_fresh(engine):
    eng, voice = engine
    specs = [(30, 0.0, 3)] * 2
    cold = _run(tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=10), voice,
                specs)
    b = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=10)
    b.warmup(prompt_len=16)
    assert b.pending == 0 and not b.active.any()
    warm = _run(b, voice, specs)
    assert warm[0] == cold[0]
    for i in cold[1]:
        np.testing.assert_allclose(warm[1][i], cold[1][i], atol=1e-6)


def test_greedy_batcher_matches_jax(files):
    """3 slots, 5 requests, temperature 0, f32, float emission slices:
    per request the same codes as the JAX batcher and PCM within 1e-4."""
    kw = dict(model_path=files["llm"], codec_path=files["codec"],
              i16_transfer=False, **KW)
    jeng = je.TTSEngine(je.EngineConfig(**kw))
    teng = te.TTSEngine(te.EngineConfig(device="cpu", **kw))
    texts = [f"greedy parity utterance {i}" for i in range(5)]
    specs = [(30 + 5 * i, 0.0, i) for i in range(5)]
    got = _run(tb.ContinuousBatcher(teng, n_slots=3, chunk_steps=10),
               te.VoiceModel(files["voice"]), specs, texts)

    jbatch = jb.ContinuousBatcher(jeng, n_slots=3, chunk_steps=10)
    jvoice = je.VoiceModel(files["voice"])
    jcodes, jpcm = {}, {}

    def keep(i, s):
        if s is not None:
            jpcm[i].append(np.asarray(s).copy())
        return True

    for i, (max_tok, temp, seed) in enumerate(specs):
        jpcm[i] = []
        jbatch.submit(texts[i], jvoice,
                      lambda s, sr, last, i=i: keep(i, s),
                      je.Options(max_tokens=max_tok, temperature=temp,
                                 seed=seed),
                      on_finish=lambda r, i=i: jcodes.__setitem__(
                          i, list(r.codes)))
    jbatch.run_until_done(max_iters=400)
    assert jbatch.pending == 0
    assert got[0] == jcodes and any(jcodes.values())
    for i in range(5):
        want = (np.concatenate(jpcm[i]) if jpcm[i]
                else np.zeros(0, np.float32))
        assert got[1][i].shape == want.shape
        if want.size:
            assert float(np.abs(got[1][i] - want).max()) < 1e-4
