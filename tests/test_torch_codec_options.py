"""The port's codec options against the JAX package's, on the CPU: fast
mode (CodecConfig.fast, EngineConfig.codec_fast, MIOTTS_CODEC_FAST) and the
codec's own device (EngineConfig.codec_device).

On the CPU TF32 does not exist, so fast mode computes the exact f32 math
(as the JAX package's fast mode does on its CPU backend): these tests hold
the plumbing, the flags and their restoration; the card's error bound is
measured by chip_smoke.py (phase 22 c) and tests/test_torch_codec_stream_
cuda.py.  Tolerances: fast against exact 1e-5 (the JAX package's own
bound, tests/test_codec.py); the port's decode against the JAX package's
1e-4 of the audio scale (the codec parity bound of
tests/test_torch_codec.py); codec_device runs sample-exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGUFReader, write_voice_embedding
from miotts_tpu.models import codec as jc
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu.runtime import engine as je
from miotts_tpu_torch.models import codec as tc
from miotts_tpu_torch.runtime import batching as tb
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

FAST_TOL = 1e-5
JAX_TOL = 1e-4
KW = dict(max_tokens=40, llm_dtype="float32", prompt_bucket=32,
          code_bucket=16)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tcomodels")
    paths = {"codec": str(d / "codec.gguf"), "llm": str(d / "llm.gguf"),
             "voice": str(d / "voice.emb.gguf")}
    ccfg = write_synthetic_codec(paths["codec"], n_codes=64, seed=3)
    write_synthetic_llm(paths["llm"], seed=5, n_speech=64)
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return paths


def _audio(eng, codes, emb):
    """Codec + iSTFT of `codes` through the engine's own decode path."""
    n = len(codes)
    return eng._codec_audio(torch.tensor(codes, dtype=torch.int32), emb,
                            n)[:n * eng.samples_per_token].numpy()


def test_fast_mode_matches_exact_and_jax(files):
    """CodecConfig.fast on the CPU: the exact decode's audio within 1e-5, an
    exact decode after the fast one bit for bit the first (the flags do
    not leak), and the JAX package's fast decode within 1e-4."""
    eng = te.TTSEngine(te.EngineConfig(codec_path=files["codec"],
                                       device="cpu"))
    fast = te.TTSEngine(te.EngineConfig(codec_path=files["codec"],
                                        device="cpu", codec_fast=True))
    assert fast.codec_cfg.fast and not eng.codec_cfg.fast
    codes = list(np.random.default_rng(5).integers(0, 64, 6))
    emb = torch.from_numpy(np.random.default_rng(6).standard_normal(
        eng.codec_cfg.adaln_dim).astype(np.float32))
    exact1 = _audio(eng, codes, emb)
    a_fast = _audio(fast, codes, emb)
    exact2 = _audio(eng, codes, emb)
    np.testing.assert_array_equal(exact1, exact2)
    np.testing.assert_allclose(a_fast, exact1, rtol=FAST_TOL, atol=FAST_TOL)

    with GGUFReader(files["codec"]) as r:
        jp, jcfg = jc.load_codec_params(r)
    jfast = np.asarray(jc.codec_decode_audio(
        jp, jnp.asarray(codes, jnp.int32), jnp.asarray(emb.numpy()),
        dataclasses.replace(jcfg, fast=True)))
    assert rel_err(a_fast, jfast[:a_fast.size]) < JAX_TOL


def test_fast_flags_set_inside_and_restored(files, monkeypatch):
    """The fast decode allows TF32 for cuBLAS and cuDNN after the prenet
    only (cfg.fast or MIOTTS_CODEC_FAST): the prenet's attention sees exact
    f32, the decoder's TF32; cuDNN stays deterministic, and every flag is
    restored after the decode."""
    with GGUFReader(files["codec"]) as r:
        params, cfg = tc.load_codec_params(r, device="cpu")
    seen = []
    attention = tc._local_attention

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.deterministic))
        return attention(*a, **k)

    monkeypatch.setattr(tc, "_local_attention", spy)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.backends.cudnn.deterministic)
    codes = torch.tensor([1, 5, 9, 13], dtype=torch.int32)
    emb = torch.zeros(cfg.adaln_dim)
    exact = [(False, False, True)] * (cfg.prenet_layers + cfg.decoder_layers)
    fast = ([(False, False, True)] * cfg.prenet_layers
            + [(True, True, True)] * cfg.decoder_layers)
    monkeypatch.delenv("MIOTTS_CODEC_FAST", raising=False)
    assert not tc.codec_fast(cfg)
    tc.codec_decode_spec(params, codes, emb, cfg)
    tc.codec_decode_spec(params, codes, emb, dataclasses.replace(cfg,
                                                                 fast=True))
    monkeypatch.setenv("MIOTTS_CODEC_FAST", "1")
    assert tc.codec_fast(cfg)
    tc.codec_decode_spec(params, codes, emb, cfg)
    assert seen == exact + fast + fast
    after = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    assert after == before


def test_env_codec_fast_decodes_like_exact(files, monkeypatch):
    """MIOTTS_CODEC_FAST=1 read at each decode, as the JAX package reads it
    at each trace: on the CPU the same audio as exact within 1e-5."""
    eng = te.TTSEngine(te.EngineConfig(codec_path=files["codec"],
                                       device="cpu"))
    voice = te.VoiceModel(files["voice"])
    codes = [3, 9, 27, 17, 40, 2, 8]
    want = eng.decode_codes(codes, voice, apply_peak_normalization=False)
    monkeypatch.setenv("MIOTTS_CODEC_FAST", "1")
    got = eng.decode_codes(codes, voice, apply_peak_normalization=False)
    np.testing.assert_allclose(got, want, rtol=FAST_TOL, atol=FAST_TOL)


def _serve(files, fused: bool, **cfg):
    """tests/test_batching.py's codec-device run on the port: 3 sampled
    requests on 2 slots of a batcher over an engine built with `cfg`."""
    eng = te.TTSEngine(te.EngineConfig(
        model_path=files["llm"], codec_path=files["codec"], device="cpu",
        **KW, **cfg))
    batcher = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=10,
                                   fused=fused)
    voice = te.VoiceModel(files["voice"])
    chunks = {i: [] for i in range(3)}

    def make_cb(i):
        def cb(samples, sr, is_last):
            if samples is not None:
                chunks[i].append(np.asarray(samples))
            return True
        return cb

    for i in range(3):
        batcher.submit(f"pipelined utterance {i}", voice, make_cb(i),
                       te.Options(max_tokens=30, temperature=1.0, seed=i))
    batcher.run_until_done(max_iters=300)
    assert batcher.pending == 0
    return eng, {i: (np.concatenate(c) if c else np.zeros(0, np.float32))
                 for i, c in chunks.items()}


@pytest.mark.parametrize("fused", [False, True])
def test_codec_device_sample_exact_in_batcher(files, fused):
    """tests/test_batching.py's codec-device check on the port, both batcher
    paths: codec_device accepted, the emitted audio sample-exact against
    the same-device batcher.  On the CPU the field changes nothing: the
    codec stays on the CPU and no stream is made."""
    _, base = _serve(files, fused)
    eng1, piped = _serve(files, fused, codec_device=1)
    assert eng1.config.codec_device == 1
    assert eng1.codec_device == torch.device("cpu")
    assert eng1._codec_stream is None
    assert any(a.size for a in base.values())
    for i in range(3):
        assert base[i].shape == piped[i].shape
        np.testing.assert_array_equal(base[i], piped[i])


def test_codec_options_in_jax_engine_config(files):
    """The port's EngineConfig carries the JAX package's codec fields with
    its defaults, and its engine applies codec_fast as the JAX engine
    does (CodecConfig.fast)."""
    for name in ("codec_fast", "codec_device", "quantized_kv"):
        assert (getattr(te.EngineConfig(), name)
                == getattr(je.EngineConfig(), name))
    kw = dict(codec_path=files["codec"], codec_fast=True)
    assert je.TTSEngine(je.EngineConfig(**kw)).codec_cfg.fast
    assert te.TTSEngine(te.EngineConfig(device="cpu", **kw)).codec_cfg.fast


def test_pipelined_stream_with_codec_device(files):
    """The unfused stream with the pipelined codec (the path codec_device
    serves in a single stream) reads its deferred decodes through
    codec_readback: the same PCM as without codec_device, and as the JAX
    package's same stream within 1e-4 at temperature 0."""
    def stream(cfg_cls, voice_cls, options, **cfg):
        kw = dict(model_path=files["llm"], codec_path=files["codec"],
                  pipeline_codec=True, holdback_codes=6,
                  min_commit_step_codes=4, first_commit_codes=2, **KW, **cfg)
        if cfg_cls is te.EngineConfig:
            eng = te.TTSEngine(cfg_cls(device="cpu", **kw))
        else:
            eng = je.TTSEngine(cfg_cls(**kw))
        out = []
        ok = eng.synthesize_stream(
            voice_cls(files["voice"]), "a pipelined stream",
            lambda s, sr, last: (s is None or out.append(
                np.asarray(s).copy()) or True),
            options=options(temperature=0.0, max_tokens=40))
        assert ok
        return np.concatenate(out)

    base = stream(te.EngineConfig, te.VoiceModel, te.Options)
    piped = stream(te.EngineConfig, te.VoiceModel, te.Options,
                   codec_device=0)
    want = stream(je.EngineConfig, je.VoiceModel, je.Options)
    np.testing.assert_array_equal(base, piped)
    assert base.shape == want.shape
    assert float(np.abs(base - want).max()) < JAX_TOL
