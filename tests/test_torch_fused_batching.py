"""The port's fused batch step (miotts_tpu_torch.runtime.engine.
_fused_batch_step and ContinuousBatcher(fused=True)) against the JAX
package's on tiny synthetic models, on the CPU, and against the port's
own unfused batcher.

The commit policy is shortened (6 codes held back, commits of 4, a first
commit of 2) so that the synthetic model's few codes per request still
commit mid-stream.  Tolerances: tokens, code buffers, counts and policy
outputs are integers and must be identical at temperature 0 (greedy over
f32 logits that agree to ~1e-6); audio within 1e-4, the codec's f32 sums
in another order and batch shape (the emitting rows only, the finals
batched) against the JAX package's all-row and per-request decodes, the
bound the port's other codec parity tests use."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import write_voice_embedding
from miotts_tpu.models import llm as jl
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu.runtime import batching as jb
from miotts_tpu.runtime import engine as je
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.runtime import batching as tb
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import few_torch_threads  # noqa: F401

KW = dict(max_tokens=60, llm_dtype="float32", prompt_bucket=32,
          code_bucket=16, i16_transfer=False, holdback_codes=6,
          min_commit_step_codes=4, first_commit_codes=2)
AUDIO_TOL = 1e-4
CHUNK = 10


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tfbmodels")
    paths = {"codec": str(d / "codec.gguf"), "llm": str(d / "llm.gguf"),
             "voice": str(d / "voice.emb.gguf")}
    ccfg = write_synthetic_codec(paths["codec"], n_codes=64, seed=3)
    write_synthetic_llm(paths["llm"], seed=5, n_speech=64)
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return paths


@pytest.fixture(scope="module")
def engines(files):
    kw = dict(model_path=files["llm"], codec_path=files["codec"], **KW)
    return (te.TTSEngine(te.EngineConfig(device="cpu", **kw)),
            je.TTSEngine(je.EngineConfig(**kw)),
            te.VoiceModel(files["voice"]), je.VoiceModel(files["voice"]))


def _run(batcher, voice, specs, options, abort=()):
    """Submit one request per spec (text, max_tokens, temperature, seed)
    and run to completion.  A request in `abort` returns False from its
    first callback with samples.  Returns {i: dict(codes, n_tokens, failed,
    pcm, sizes)} with `sizes` the callbacks' (n_samples, is_last)."""
    out = {i: {"pcm": [], "sizes": []} for i in range(len(specs))}

    def make_cb(i):
        def cb(samples, sr, is_last):
            n = None if samples is None else int(np.asarray(samples).size)
            out[i]["sizes"].append((n, bool(is_last)))
            if samples is not None:
                out[i]["pcm"].append(np.asarray(samples, np.float32).copy())
                if i in abort:
                    return False
            return True
        return cb

    def make_fin(i):
        def fin(r):
            out[i].update(codes=list(r.codes), n_tokens=r.n_tokens,
                          failed=r.failed)
        return fin

    for i, (text, max_tok, temp, seed) in enumerate(specs):
        batcher.submit(text, voice, make_cb(i),
                       options(max_tokens=max_tok, temperature=temp,
                               seed=seed), on_finish=make_fin(i))
    batcher.run_until_done(max_iters=400)
    assert batcher.pending == 0
    for o in out.values():
        o["pcm"] = (np.concatenate(o["pcm"]) if o["pcm"]
                    else np.zeros(0, np.float32))
    return out


def _same_requests(got, want, tol=AUDIO_TOL):
    assert got.keys() == want.keys()
    for i in want:
        g, w = got[i], want[i]
        assert g["codes"] == w["codes"], i
        assert g["n_tokens"] == w["n_tokens"], i
        assert g["failed"] == w["failed"], i
        assert g["sizes"] == w["sizes"], i
        assert g["pcm"].shape == w["pcm"].shape, i
        if w["pcm"].size:
            assert float(np.abs(g["pcm"] - w["pcm"]).max()) < tol, i


# budgets that end mid-chunk: a budget that ends with a chunk ends a fused
# request one chunk later (its budget is tested when it next draws), so
# that its last commit and its final flush come apart where the unfused
# path flushes once, as in the JAX package
SPECS = [(f"fused batch {i}", mt, 0.0, i)
         for i, mt in enumerate((25, 57, 44, 37))]


class _Buckets(tb.ContinuousBatcher):
    """Records the code-buffer bucket of every fused step."""

    def _step_fused(self):
        super()._step_fused()
        self.seen = getattr(self, "seen", []) + [self._codes_bucket]


def test_fused_batcher_matches_jax(engines):
    """4 requests on 2 slots (admission churn rebuilds the code buffer), a
    budget that ends mid-chunk (25 tokens, chunks of 10), buffers grown
    past code_bucket: per request the JAX fused batcher's codes, token
    counts, callbacks and PCM."""
    teng, jeng, tvoice, jvoice = engines
    tbatch = _Buckets(teng, n_slots=2, chunk_steps=CHUNK, fused=True)
    got = _run(tbatch, tvoice, SPECS, te.Options)
    want = _run(jb.ContinuousBatcher(jeng, n_slots=2, chunk_steps=CHUNK,
                                     fused=True), jvoice, SPECS, je.Options)
    _same_requests(got, want)
    assert got[0]["n_tokens"] == 25 and got[1]["n_tokens"] == 57
    assert max(tbatch.seen) > KW["code_bucket"]
    # the first commit used the first-commit threshold: an emission of
    # fewer than min_commit_step_codes codes before any other
    spt = teng.samples_per_token
    firsts = [o["sizes"][0][0] for o in got.values() if o["sizes"]]
    assert any(n < KW["min_commit_step_codes"] * spt for n in firsts)
    assert all(o["sizes"][-1][1] for o in got.values())


def test_fused_batcher_stop_and_abort_match_jax(engines):
    """Greedy requests with a callback returning False on request 1's
    first audio: per request the JAX fused batcher's outcome, the aborted
    request failed after one callback.  Then sampled requests, one of
    which stops mid-chunk on a stop token: the unfused batcher's."""
    teng, jeng, tvoice, jvoice = engines
    specs = [(f"abort case {i}", 60, 0.0, i) for i in range(3)]
    got = _run(tb.ContinuousBatcher(teng, n_slots=2, chunk_steps=CHUNK,
                                    fused=True), tvoice, specs, te.Options,
               abort={1})
    want = _run(jb.ContinuousBatcher(jeng, n_slots=2, chunk_steps=CHUNK,
                                     fused=True), jvoice, specs, je.Options,
                abort={1})
    _same_requests(got, want)
    assert got[1]["failed"] and len(got[1]["sizes"]) == 1
    # a stop mid-chunk: the port's own sampled run (the JAX package's
    # threefry draws cannot be reproduced) ends a request before its
    # budget, and the fused batcher keeps the unfused batcher's tokens
    sampled = [(f"stop case {i}", 57, 0.8, 3 + i) for i in range(4)]
    fused = _run(tb.ContinuousBatcher(teng, n_slots=2, chunk_steps=CHUNK,
                                      fused=True), tvoice, sampled,
                 te.Options)
    plain = _run(tb.ContinuousBatcher(teng, n_slots=2, chunk_steps=CHUNK),
                 tvoice, sampled, te.Options)
    _same_requests(fused, plain)
    assert any(o["n_tokens"] < 57 and o["n_tokens"] % CHUNK
               for o in fused.values())


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_fused_matches_unfused(engines, temp):
    """The port's fused and unfused batchers at the same seeds: the same
    tokens per request, the same callbacks and PCM within 1e-4 (float
    slices on both; the unfused path decodes at the codes' own bucket, the
    fused one at its buffer's)."""
    teng, _, tvoice, _ = engines
    specs = [(t, mt, temp, s) for t, mt, _, s in SPECS]
    fused = _run(tb.ContinuousBatcher(teng, n_slots=2, chunk_steps=CHUNK,
                                      fused=True), tvoice, specs, te.Options)
    for depth in (1, 2):
        plain = _run(tb.ContinuousBatcher(teng, n_slots=2, chunk_steps=CHUNK,
                                          pipeline_depth=depth),
                     tvoice, specs, te.Options)
        _same_requests(fused, plain)


def _step_inputs(teng, B=3):
    """Prompts prefilled into slots 0-2 of a fresh f32 cache in both
    packages, and a code state: slot 0 with 5 codes committed to 0 and 3
    tokens of a 25-token budget; slot 1 with none and inactive; slot 2 with
    9 codes, 2 committed, 20 tokens of 24 (the budget ends mid-chunk)."""
    rng = np.random.default_rng(4)
    toks = np.zeros((B, 32), np.int32)
    n_real = np.array([9, 14, 11], np.int32)
    for i, n in enumerate(n_real):
        toks[i, :n] = rng.integers(0, 256, n)
    bucket = 32
    codes = np.zeros((B, bucket), np.int32)
    n_codes = np.array([5, 0, 9], np.int32)
    for i, n in enumerate(n_codes):
        codes[i, :n] = rng.integers(0, 64, n)
    state = dict(toks=toks, n_real=n_real, codes=codes, n_codes=n_codes,
                 committed=np.array([0, 0, 2], np.int32),
                 n_tokens=np.array([3, 0, 20], np.int32),
                 max_toks=np.array([25, 25, 24], np.int32),
                 active=np.array([True, False, True]),
                 embs=rng.standard_normal((B, teng.codec_cfg.adaln_dim))
                 .astype(np.float32) * 0.3)
    return state


def _port_step(teng, st, stop_ids):
    cfg = teng.llm_cfg
    B = len(st["n_real"])
    cache = tl.init_kv_cache(cfg, B, 128, dtype=torch.float32)
    last, cache = tl.llm_prefill_slots(
        teng.llm_params, torch.from_numpy(st["toks"]).long(),
        torch.from_numpy(st["n_real"]), cache, torch.arange(B), cfg)
    c = teng.config
    i32 = lambda k: torch.from_numpy(st[k].copy())  # noqa: E731
    out = te._fused_batch_step(
        teng.llm_params, last, cache, torch.from_numpy(st["active"]),
        torch.zeros(B, dtype=torch.int64), torch.zeros(B, dtype=torch.int64),
        torch.zeros(B), torch.tensor(stop_ids), teng._code_table_dev,
        i32("codes"), i32("n_codes"), i32("committed"), i32("n_tokens"),
        i32("max_toks"), cfg, CHUNK, c.holdback_codes,
        c.min_commit_step_codes, teng._first_commit)
    buf, active, _, _, _, codes_buf, n_codes, n_tokens, emit, target = out
    return dict(buf=buf.numpy(), active=active.numpy(),
                codes=codes_buf.numpy(), n_codes=n_codes.numpy(),
                n_tokens=n_tokens.numpy(), emit=emit.numpy(),
                target=target.numpy(), codes_dev=codes_buf)


def _jax_step(jeng, st, stop_ids):
    cfg = jeng.llm_cfg
    B = len(st["n_real"])
    cache = jl.init_kv_cache(cfg, B, 128, dtype=jnp.float32)
    last, cache = jl.llm_prefill_slots(
        jeng.llm_params, jnp.asarray(st["toks"]), jnp.asarray(st["n_real"]),
        cache, jnp.arange(B, dtype=jnp.int32), cfg)
    c = jeng.config
    out = je._fused_batch_step(
        jeng.llm_params, jeng.codec_params, last, cache,
        jnp.asarray(st["active"]), jax.random.split(jax.random.PRNGKey(0), B),
        jnp.zeros(B, jnp.float32), jnp.asarray(stop_ids, jnp.int32),
        jnp.asarray(jeng.code_table), jnp.asarray(st["codes"]),
        jnp.asarray(st["n_codes"]), jnp.asarray(st["committed"]),
        jnp.asarray(st["n_tokens"]), jnp.asarray(st["max_toks"]),
        jnp.asarray(st["embs"]), cfg, jeng.codec_cfg, CHUNK,
        st["codes"].shape[1], c.holdback_codes, c.min_commit_step_codes,
        jeng._first_commit)
    buf, active, _, _, _, codes_buf, n_codes, n_tokens, emit, target, audio = out
    return dict(buf=np.asarray(buf), active=np.asarray(active),
                codes=np.asarray(codes_buf), n_codes=np.asarray(n_codes),
                n_tokens=np.asarray(n_tokens), emit=np.asarray(emit),
                target=np.asarray(target), audio=np.asarray(audio))


@pytest.mark.parametrize("stop", [False, True])
def test_fused_batch_step_matches_jax(engines, stop):
    """One fused step on the same inputs in both packages, temperature 0:
    buf, active, codes_buf, n_codes, n_tokens, emit and target identical;
    the port's emitting rows decoded alone (decode_code_rows_sliced) within
    1e-4 of the same slices of the JAX package's all-row decode.  With
    `stop`, a token slot 0 draws mid-chunk is a stop token."""
    teng, jeng, _, _ = engines
    st = _step_inputs(teng)
    stop_ids = [-1, -1]
    if stop:
        first = _port_step(teng, st, stop_ids)["buf"][0]
        stop_ids = [int(first[4]), -1]
    got = _port_step(teng, st, stop_ids)
    want = _jax_step(jeng, st, stop_ids)
    for k in ("buf", "active", "codes", "n_codes", "n_tokens", "emit",
              "target"):
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype),
                                      err_msg=k)
    # slot 2's budget ends mid-chunk: 4 kept tokens, then inactive
    assert got["n_tokens"][2] == 24 and not got["active"][2]
    if stop:
        assert not got["active"][0] and (got["buf"][0] < 0).any()
    spt = teng.samples_per_token
    committed = st["committed"]
    rows = [int(r) for r in np.flatnonzero(got["emit"])]
    assert rows or stop
    if not rows:
        return
    segs = teng.decode_code_rows_sliced(
        got["codes_dev"], torch.from_numpy(st["embs"]), rows,
        [int(got["n_codes"][r]) for r in rows],
        [int(committed[r]) * spt for r in rows],
        [int(got["target"][r]) * spt for r in rows])
    for r, seg in zip(rows, segs):
        ref = want["audio"][r, committed[r] * spt:got["target"][r] * spt]
        assert seg.shape == ref.shape
        assert float(np.abs(seg - ref).max()) < AUDIO_TOL


def test_fused_batch_step_budget_draws_like_unfused(engines):
    """A slot already at its budget draws a token (its draw count advances
    as in the unfused chunk), goes inactive and keeps nothing; the chunk
    leaves an inactive slot's fill alone."""
    teng, _, _, _ = engines
    cfg = teng.llm_cfg
    B = 2
    cache = tl.init_kv_cache(cfg, B, 128, dtype=torch.float32)
    toks = torch.randint(0, 256, (B, 32), generator=torch.Generator()
                         .manual_seed(2))
    last, cache = tl.llm_prefill_slots(teng.llm_params, toks,
                                       torch.tensor([12, 12]), cache,
                                       torch.arange(B), cfg)
    fill0 = cache["fill"].clone()
    z = torch.zeros(B, dtype=torch.int32)
    out = te._fused_batch_step(
        teng.llm_params, last, cache, torch.tensor([True, True]),
        torch.tensor([7, 8]), torch.zeros(B, dtype=torch.int64),
        torch.full((B,), 0.8), torch.tensor([-1]), teng._code_table_dev,
        torch.zeros((B, 32), dtype=torch.int32), z, z,
        torch.tensor([5, 0], dtype=torch.int32),
        torch.tensor([5, 60], dtype=torch.int32), cfg, CHUNK, 6, 4, 2)
    buf, active, _, cache, drawn = out[:5]
    assert (buf[0] < 0).all() and not active[0]
    assert drawn.tolist() == [1, CHUNK]
    assert cache["fill"].tolist() == [int(fill0[0]), int(fill0[1]) + CHUNK]
    assert out[7].tolist() == [5, CHUNK]
