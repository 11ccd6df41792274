"""The port's streaming synthesis against the JAX package, on the tiny
synthetic models of tests/test_stream_policy.py (f32, prompt bucket 32,
code bucket 16, the port on the CPU).

Tolerances: PCM of the two packages within 1e-4 (their codecs are the same
f32 arithmetic in another order); within the port, the fused path equals
the unfused one exactly (the same decodes on the same padded codes), the
pipeline depths within 1e-5 (they run the same calls in another order on
the host), a skip-llm stream its own offline decode within 1e-6 (one emit,
nothing blended), stage sums within 1e-6 (relative)."""

import dataclasses

import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGML_F32, write_voice_embedding
from miotts_tpu.models import llm as jl
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu.runtime import engine as je
from miotts_tpu.runtime.profile import StreamProfile as JProfile
from miotts_tpu.text import format_speech_tokens
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.runtime import engine as te
from miotts_tpu_torch.runtime.profile import StreamProfile as TProfile
from torch_port_util import few_torch_threads  # noqa: F401

N_SPEECH = 64
KW = dict(llm_dtype="float32", prompt_bucket=32, code_bucket=16)
# policy constants small enough that a tiny model's short stream commits
# several times, grows its code buffer and slides its window (the JAX
# package's test_fused_windowed_streaming uses the same)
SMALL = dict(holdback_codes=8, min_commit_step_codes=6,
             stream_check_interval=10, first_commit_codes=4)
# the greedy tiny models keep ~1 code in 7 tokens: commit on a few codes
GREEDY = dict(holdback_codes=2, min_commit_step_codes=2,
              stream_check_interval=10, first_commit_codes=1)
PKG_TOL = 1e-4
DEPTH_TOL = 1e-5
OFFLINE_TOL = 1e-6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    paths = {k: str(d / f"{k}.gguf") for k in ("codec", "llm", "lfm2",
                                                 "voice")}
    ccfg = write_synthetic_codec(paths["codec"], n_codes=N_SPEECH, seed=3)
    write_synthetic_llm(paths["llm"], seed=5, n_speech=N_SPEECH)
    # tests/test_lfm2.py's tiny hybrid (2 short-conv + 2 attention layers)
    write_synthetic_llm(paths["lfm2"], quant_type=GGML_F32, seed=9, cfg=(
        jl.LLMConfig(arch="lfm2", n_layers=4, dim=64, n_heads=4,
                     n_kv_heads=2, head_dim=16, ff_dim=96,
                     n_vocab=256 + 3 + N_SPEECH, n_ctx=128,
                     rope_style="neox", qkv_bias=False, qk_norm=True,
                     layer_types=("conv", "attn", "conv", "attn"),
                     conv_l_cache=3)))
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return paths


def _engines(files, model="llm", **cfg):
    kw = dict(KW, model_path=files[model], codec_path=files["codec"], **cfg)
    return (je.TTSEngine(je.EngineConfig(**kw)), je.VoiceModel(files["voice"]),
            te.TTSEngine(te.EngineConfig(device="cpu", **kw)),
            te.VoiceModel(files["voice"]))


@pytest.fixture(scope="module")
def engines(files):
    return _engines(files)


@pytest.fixture(scope="module")
def small(files):
    """The port on the small policy constants (within-port tests)."""
    return (te.TTSEngine(te.EngineConfig(
        device="cpu", model_path=files["llm"], codec_path=files["codec"],
        **KW, **SMALL)), te.VoiceModel(files["voice"]))


def _run(eng, voice, text, options, **kw):
    """One stream: (PCM, [(n_samples, is_last)], profile, ok)."""
    chunks, events = [], []

    def cb(samples, sr, is_last):
        assert sr == eng.sample_rate
        events.append((0 if samples is None else len(samples), is_last))
        if samples is not None:
            chunks.append(samples.copy())
        return True

    profile = (TProfile if isinstance(eng, te.TTSEngine) else JProfile)()
    ok = eng.synthesize_stream(voice, text, cb, options=options,
                               profile=profile, **kw)
    pcm = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    return pcm, events, profile, ok


def _scripted(monkeypatch, eng, codes):
    """generate_tokens replaced by a feed of the speech tokens of `codes`
    (tests/test_stream_policy.py's `_scripted`), on the unfused path."""
    monkeypatch.setattr(eng.config, "fused_streaming", False)
    id_for_code = {int(c): i for i, c in enumerate(eng.code_table) if c >= 0}

    def fake_generate(text, options, on_token=None, profile=None):
        ids = []
        for n, c in enumerate(codes, start=1):
            ids.append(id_for_code[int(c)])
            if on_token is not None and not on_token(ids[-1], n):
                break
        return ids

    monkeypatch.setattr(eng, "generate_tokens", fake_generate)


# --- F3: the reference's StreamProfile through generate_tokens and
# decode_codes ------------------------------------------------------------

@pytest.mark.parametrize("stage", ["generate_tokens", "decode_codes"])
def test_stream_profile_fields_match_jax(engines, stage):
    """Both packages take a StreamProfile and fill the same counters, with
    times > 0: generate_tokens prefill_sec, llm_sec, llm_tokens;
    decode_codes codec_sec, istft_sec (timed apart), decode_calls,
    decoded_codes (12 codes), PCM within 1e-4."""
    jeng, jvoice, teng, tvoice = engines
    jp, tp = JProfile(), TProfile()
    if stage == "generate_tokens":
        opts = dict(temperature=0.0, max_tokens=30)
        jids = jeng.generate_tokens("profile me", je.Options(**opts),
                                    profile=jp)
        tids = teng.generate_tokens("profile me", te.Options(**opts),
                                    profile=tp)
        assert tids == jids and tp.token_ids == tids
        assert tp.llm_tokens == jp.llm_tokens == len(jids) > 0
        for p in (jp, tp):
            assert p.prefill_sec > 0 and p.llm_sec > 0
        assert tp.decode_steps == 30
    else:
        codes = np.random.default_rng(1).integers(0, N_SPEECH, 12)
        want = jeng.decode_codes(codes, jvoice, False, jp)
        got = teng.decode_codes(codes, tvoice, False, tp)
        assert float(np.max(np.abs(got - want))) < PKG_TOL
        for p in (jp, tp):
            assert (p.decode_calls, p.decoded_codes) == (1, 12)
            assert p.codec_sec > 0 and p.istft_sec > 0


def test_generate_token_text_matches_jax(engines):
    jeng, _, teng, _ = engines
    opts = dict(temperature=0.0, max_tokens=30)
    want = jeng.generate_token_text("token text", je.Options(**opts))
    assert teng.generate_token_text("token text", te.Options(**opts)) == want
    assert teng.generate_token_text("<|s_3|>", te.Options(skip_llm=True)) == \
        "<|s_3|>"


def test_decode_codes_async_matches_decode_codes(engines):
    _, _, teng, tvoice = engines
    codes = np.random.default_rng(2).integers(0, N_SPEECH, 20)
    audio, T = teng.decode_codes_async(codes, tvoice)
    assert isinstance(audio, torch.Tensor) and T == 20
    want = teng.decode_codes(codes, tvoice, apply_peak_normalization=False)
    np.testing.assert_array_equal(
        audio[:T * teng.samples_per_token].numpy(), want)


# --- the unfused path on scripted codes, both packages ----------------------

SCRIPTED = {
    # 121 codes: commits at 60 -> 28, 100 -> 68, 120 -> 88, then the flush
    "121": (121, {}),
    # 40 codes: target 8 = first_commit -> one early commit + the flush
    "40_first8": (40, {}),
    # the reference's uniform cadence: no commit before 56 codes
    "40_uniform": (40, {"uniform": True}),
    "121_window48": (121, {"stream_window_codes": 48}),
    "121_pipelined": (121, {"pipeline_codec": True}),
}


@pytest.mark.parametrize("case", list(SCRIPTED))
def test_scripted_stream_matches_jax(engines, monkeypatch, case):
    """The same codes fed through both packages' unfused synthesize_stream:
    the same (n_samples, is_last) events, decode_calls and decoded_codes,
    PCM within 1e-4."""
    jeng, jvoice, teng, tvoice = engines
    n, cfg = SCRIPTED[case]
    codes = np.random.default_rng(n).integers(0, N_SPEECH, n)
    runs = []
    for eng, voice, Opt in ((jeng, jvoice, je.Options),
                            (teng, tvoice, te.Options)):
        _scripted(monkeypatch, eng, codes)
        for k, v in cfg.items():
            if k == "uniform":
                monkeypatch.setattr(eng, "_first_commit",
                                    eng.config.min_commit_step_codes)
            else:
                monkeypatch.setattr(eng.config, k, v)
        runs.append(_run(eng, voice, "ignored", Opt(max_tokens=500)))
    (want, jev, jp, jok), (got, tev, tp, tok) = runs
    assert jok and tok
    assert tev == jev and tev[-1][1] is True
    assert (tp.decode_calls, tp.decoded_codes) == \
        (jp.decode_calls, jp.decoded_codes)
    assert got.shape == want.shape == (n * teng.samples_per_token,)
    assert float(np.max(np.abs(got - want))) < PKG_TOL
    if case == "40_first8":
        assert tp.decode_calls == 2
    if case == "40_uniform":
        assert tp.decode_calls == 1


def test_skip_llm_stream_matches_offline(engines):
    """One decode, one emit: the port's stream equals its own offline
    decode (no peak normalisation) within 1e-6 and the JAX package's within
    1e-4; the last callback carries samples and is_last."""
    jeng, jvoice, teng, tvoice = engines
    text = format_speech_tokens(np.random.default_rng(3).integers(
        0, N_SPEECH, 12))
    opts = dict(skip_llm=True, apply_peak_normalization=False)
    own = teng.synthesize(tvoice, text, te.Options(**opts))
    jax_off = jeng.synthesize(jvoice, text, je.Options(**opts))
    got, events, prof, ok = _run(teng, tvoice, text, te.Options(skip_llm=True),
                                 chunk_samples=4096)
    assert ok and events[-1][1] is True and events[-1][0] > 0
    assert got.shape == own.shape == jax_off.shape
    assert float(np.max(np.abs(got - own))) < OFFLINE_TOL
    assert float(np.max(np.abs(got - jax_off))) < PKG_TOL
    assert (prof.decode_calls, prof.decoded_codes) == (1, 12)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_skip_llm_empty_parse_gives_no_callback(engines, pkg):
    jeng, jvoice, teng, tvoice = engines
    eng, voice, Opt = ((jeng, jvoice, je.Options) if pkg == "jax"
                       else (teng, tvoice, te.Options))
    _, events, _, ok = _run(eng, voice, "no speech tokens here",
                            Opt(skip_llm=True))
    assert not ok and events == []


# --- temperature 0: the port's fused stream against the JAX package's -------

@pytest.mark.parametrize("model", ["llm", "lfm2"])
def test_greedy_fused_stream_matches_jax(files, model):
    """Fresh engines of both packages on a policy of few codes, temperature 0:
    the port's fused stream keeps the JAX package's greedy tokens, gives
    its fused stream's events and decode counts, PCM within 1e-4.  (A
    fresh JAX engine each: its LFM2 cache keeps the previous request's
    conv state.)"""
    opts = dict(temperature=0.0, max_tokens=70)
    text = "greedy streaming parity"
    jeng, jvoice, teng, tvoice = _engines(files, model, **GREEDY)
    want, jev, jp, jok = _run(jeng, jvoice, text, je.Options(**opts))
    got, tev, tp, tok = _run(teng, tvoice, text, te.Options(**opts))
    jids = _engines(files, model, **GREEDY)[0].generate_tokens(
        text, je.Options(**opts))
    assert jok and tok
    assert tp.token_ids == jids and len(jids) == tp.llm_tokens == jp.llm_tokens
    assert tev == jev and tp.decode_calls == jp.decode_calls >= 2
    assert tp.decoded_codes == jp.decoded_codes
    assert got.shape == want.shape and got.size > 0
    assert float(np.max(np.abs(got - want))) < PKG_TOL


# --- within the port, temperature 1.0 --------------------------------------

SAMPLED = te.Options(temperature=1.0, max_tokens=150, seed=7)


def _port_run(small, monkeypatch, text="pipeline parity", options=SAMPLED,
              **cfg):
    eng, voice = small
    for k, v in cfg.items():
        monkeypatch.setattr(eng.config, k, v)
    return _run(eng, voice, text, options)


def test_fused_equals_unfused(small, monkeypatch):
    """The same seed through both paths: the same generator draws in the
    same order, the same tokens, commits and decodes, identical PCM
    (through the code buffer's growths from 16 to 256 and decodes at two
    buckets)."""
    a, ea, pa, oka = _port_run(small, monkeypatch, fused_streaming=False)
    b, eb, pb, okb = _port_run(small, monkeypatch, fused_streaming=True)
    assert oka and okb and pa.token_ids == pb.token_ids
    assert eb == ea and pb.decode_calls == pa.decode_calls >= 3
    assert pb.decoded_codes == pa.decoded_codes
    assert len(set(pb.decode_bucket_codes)) >= 2
    np.testing.assert_array_equal(b, a)


def test_pipeline_depths_agree(small, monkeypatch):
    """Depth 1 (synchronous), 2 and 4: the same schedule and PCM within
    1e-5."""
    runs = [_port_run(small, monkeypatch, stream_pipeline_depth=d)
            for d in (1, 2, 4)]
    base = runs[0]
    for pcm, events, prof, ok in runs[1:]:
        assert ok and events == base[1]
        assert prof.decode_calls == base[2].decode_calls
        assert prof.emitted_samples == base[2].emitted_samples
        np.testing.assert_allclose(pcm, base[0], atol=DEPTH_TOL)


def test_window_mode_fused(small, monkeypatch):
    """Sliding-window fused streaming (one buffer of 64 codes the device
    slides; 400 tokens at seed 7 give 65 codes): the full path's commit schedule and
    sample count, less decode work, bounded drift (tests/test_stream_policy
    .py's bound)."""
    opts = te.Options(temperature=1.0, max_tokens=400, seed=7)
    full, ef, pf, _ = _port_run(small, monkeypatch, options=opts)
    win, ew, pw, ok = _port_run(small, monkeypatch, options=opts,
                                stream_window_codes=20)
    assert len(set(pw.decode_bucket_codes)) == 1
    assert ok and [e[0] for e in ew] == [e[0] for e in ef]
    assert pw.decode_calls == pf.decode_calls
    assert pw.decoded_codes < pf.decoded_codes
    assert win.shape == full.shape
    rmse = float(np.sqrt(np.mean((win - full) ** 2)))
    assert rmse / (float(np.sqrt(np.mean(full ** 2))) + 1e-9) < 0.3


def test_abort_with_steps_in_flight(small, monkeypatch):
    """A callback abort at depth 3: False, and exactly one callback; the
    outputs still in flight are dropped."""
    eng, voice = small
    monkeypatch.setattr(eng.config, "stream_pipeline_depth", 3)
    calls = []

    def cb(samples, sr, is_last):
        calls.append(0 if samples is None else len(samples))
        return False

    assert not eng.synthesize_stream(voice, "pipeline abort", cb,
                                     options=SAMPLED)
    assert len(calls) == 1 and calls[0] > 0


def test_pipelined_codec_matches_plain(small, monkeypatch):
    """pipeline_codec: the same decodes read back one check interval
    later, sample-exact against the unfused path."""
    a, ea, pa, _ = _port_run(small, monkeypatch, fused_streaming=False)
    b, eb, pb, ok = _port_run(small, monkeypatch, fused_streaming=False,
                              pipeline_codec=True)
    assert ok and eb == ea and pb.decode_calls == pa.decode_calls
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("fused", [True, False])
def test_budget_ends_at_n_ctx(files, fused):
    """n_ctx exactly the prompt plus the budget, so the cache is n_ctx
    long: every path stops at the budget (the fused path's chunks are cut
    to it too, depth 2), the same tokens as offline, and no step writes
    past the cache: its last column still holds the k / v of the last
    token (a clamped write past it would replace them), as a prefill of
    the whole sequence gives them."""
    kw = dict(KW, **SMALL, model_path=files["llm"], codec_path=files["codec"])
    probe = te.TTSEngine(te.EngineConfig(device="cpu", **kw))
    text, budget = "budget at the context end", 37
    n = probe._prefill(text, 1)[1]["fill"].item()
    eng = te.TTSEngine(te.EngineConfig(device="cpu", n_ctx=n + budget,
                                       fused_streaming=fused, **kw))
    voice = te.VoiceModel(files["voice"])
    opts = te.Options(temperature=0.0, max_tokens=500)
    offline = probe.generate_tokens(text, opts)[:budget]
    _, events, prof, ok = _run(eng, voice, text, opts)
    assert prof.token_ids == offline and prof.decode_steps == budget
    cache = eng._cache
    assert cache["k"].shape[3] == n + budget
    assert int(cache["fill"][0]) == n + budget
    ids = eng.tokenizer.encode(te.build_prompt(te.normalize_tts_text(text)),
                               add_special=True, parse_special=True)
    seq = torch.tensor([ids + offline], dtype=torch.int64)
    ref = tl.init_kv_cache(eng.llm_cfg, 1, n + budget, dtype=torch.float32)
    _, ref = tl.llm_prefill(eng.llm_params, seq, torch.tensor([n + budget]),
                            ref, eng.llm_cfg)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key][..., -1, :].numpy(),
                                   ref[key][..., -1, :].numpy(), atol=1e-4)


def test_attribute_stages_keeps_the_sum(small, monkeypatch):
    """attribute_stages moves a measured codec / iSTFT share out of a fused
    stream's llm_sec: the stage sum kept within 1e-6, both stages > 0, and
    a second call changes nothing."""
    eng, _ = small
    _, _, prof, ok = _port_run(small, monkeypatch)
    assert ok and prof.decode_bucket_codes and prof.codec_sec == 0
    before = prof.llm_sec + prof.codec_sec + prof.istft_sec
    assert eng.attribute_stages(prof, reps=2) is prof
    assert prof.stages_calibrated and prof.stages_trusted
    assert prof.codec_sec > 0 and prof.istft_sec > 0 and prof.llm_sec > 0
    after = prof.llm_sec + prof.codec_sec + prof.istft_sec
    assert after == pytest.approx(before, rel=1e-6)
    snapshot = dataclasses.asdict(prof)
    eng.attribute_stages(prof, reps=2)
    assert dataclasses.asdict(prof) == snapshot


def test_warmup_leaves_streams_unchanged(small, monkeypatch):
    """warmup (every code bucket to 64, both chunk sizes, the fused step
    at each bucket) and then the same stream: the same PCM."""
    eng, _ = small
    before = _port_run(small, monkeypatch)[0]
    eng.warmup(max_codes=64, prompt_len=8)
    np.testing.assert_array_equal(_port_run(small, monkeypatch)[0], before)


def test_codec_masks_bucket_padding(engines):
    """The fused path decodes a code buffer whose tail past n_real may hold
    stale codes: the codec gives the same audio at two bucket sizes with
    nonzero codes past n_real (within 1e-5 of the audio scale: f32 sums
    over another length)."""
    _, _, teng, tvoice = engines
    rng = np.random.default_rng(4)
    T, spt = 21, teng.samples_per_token
    emb = tvoice.device_embedding("cpu")
    outs = []
    for bucket in (32, 64):
        codes = torch.from_numpy(rng.integers(0, N_SPEECH, bucket))
        codes[:T] = torch.arange(T) * 3 % N_SPEECH
        outs.append(teng._codec_audio(codes, emb, T)[:T * spt].numpy())
    scale = float(np.max(np.abs(outs[0])))
    assert float(np.max(np.abs(outs[1] - outs[0]))) < 1e-5 * scale


def test_exact_f32_keeps_cudnn_deterministic():
    """Every codec / iSTFT call runs under exact_f32, which also keeps cuDNN
    to its deterministic algorithms (on the H100 its default transposed
    convolution gave decodes differing by ~6e-6 between calls, which broke
    depth 1 = depth 2 bit for bit), and restores the flag on exit."""
    from miotts_tpu_torch.models import codec as tc
    old = torch.backends.cudnn.deterministic
    with tc.exact_f32():
        assert torch.backends.cudnn.deterministic
    assert torch.backends.cudnn.deterministic == old
