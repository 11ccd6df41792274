"""The port's batched codec + iSTFT: rows of a [B, T] decode equal the [T]
decodes of the same codes, the batched sliced decode matches the JAX
package's, and bucket padding rows never change real rows."""

import numpy as np
import pytest
import torch

from miotts_tpu.gguf import write_voice_embedding
from miotts_tpu.models.synthetic import write_synthetic_codec
from miotts_tpu.runtime import engine as je
from miotts_tpu_torch.models.codec import codec_decode_spec
from miotts_tpu_torch.ops.istft import spec_to_audio_bucketed
from miotts_tpu_torch.runtime import engine as te
from miotts_tpu_torch.runtime.profile import StreamProfile
from torch_port_util import few_torch_threads, rel_err  # noqa: F401


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    d = tmp_path_factory.mktemp("cbatch")
    codec = str(d / "codec.gguf")
    ccfg = write_synthetic_codec(codec, n_codes=64, seed=3)
    voices = []
    for i in range(3):
        p = str(d / f"v{i}.emb.gguf")
        write_voice_embedding(p, np.random.default_rng(20 + i)
                              .standard_normal(ccfg.adaln_dim) * 0.3)
        voices.append(p)
    kw = dict(codec_path=codec, code_bucket=16, i16_transfer=False)
    return (je.TTSEngine(je.EngineConfig(**kw)),
            te.TTSEngine(te.EngineConfig(device="cpu", **kw)), voices)


def test_batched_rows_equal_single_decodes(engines):
    """Three rows of different real lengths (and voices) in one [3, 32]
    bucket: each row's spectrogram and audio equal its own [T] decode."""
    _, teng, voices = engines
    p, cfg = teng.codec_params, teng.codec_cfg
    rng = np.random.default_rng(0)
    lens = [32, 19, 7]
    codes = torch.from_numpy(rng.integers(0, 64, (3, 32)).astype(np.int32))
    embs = torch.stack([te.VoiceModel(v).device_embedding("cpu")
                        for v in voices])
    n_real = torch.tensor(lens)
    lm, ph = codec_decode_spec(p, codes, embs, cfg, n_real=n_real)
    with torch.no_grad():
        audio = spec_to_audio_bucketed(lm, ph, p["istft_cos_basis"],
                                       p["istft_sin_basis"], p["istft_hann"],
                                       cfg.hop_length, cfg.total_upsample,
                                       n_real)
    spt = cfg.samples_per_token
    for i, n in enumerate(lens):
        lm1, ph1 = codec_decode_spec(p, codes[i], embs[i], cfg, n_real=n)
        frames = n * cfg.total_upsample
        assert rel_err(lm[i, :frames], lm1[:frames]) < 1e-5
        assert rel_err(ph[i, :frames], ph1[:frames]) < 1e-5
        a1 = spec_to_audio_bucketed(lm1, ph1, p["istft_cos_basis"],
                                    p["istft_sin_basis"], p["istft_hann"],
                                    cfg.hop_length, cfg.total_upsample, n)
        assert rel_err(audio[i, :n * spt], a1[:n * spt]) < 1e-5


def test_sliced_decode_matches_jax(engines):
    """decode_codes_batch_sliced (float slices) against the JAX package's
    on the same codes, voices and slices: 1e-4."""
    jeng, teng, voices = engines
    rng = np.random.default_rng(1)
    spt = teng.codec_cfg.samples_per_token
    codes = [list(rng.integers(0, 64, n)) for n in (12, 9, 14)]
    begins = [2 * spt, 0, 5 * spt]
    ends = [(len(c) - 1) * spt for c in codes]
    want = jeng.decode_codes_batch_sliced(
        codes, [je.VoiceModel(v) for v in voices], begins, ends)
    prof = StreamProfile()
    got = teng.decode_codes_batch_sliced(
        codes, [te.VoiceModel(v) for v in voices], begins, ends, profile=prof)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float(np.abs(g - np.asarray(w)).max()) < 1e-4
    assert prof.decode_calls == 1 and prof.decoded_codes == 35
    assert prof.codec_sec > 0
    prof.total_sec = 2.0
    m = prof.as_metrics(audio_sec=1.0)
    assert m["stream_bench.x_realtime"] == 0.5
    assert m["stream_bench.decode_calls"] == 1


@pytest.mark.parametrize("take", [3, 5])
def test_bucket_padding_rows_do_not_change_real_rows(engines, take):
    """B_real = 3 pads to a batch of 4, 5 to 8: every real row reproduces
    the same window of its own full decode."""
    _, teng, voices = engines
    voice = te.VoiceModel(voices[0])
    rng = np.random.default_rng(0)
    spt = teng.codec_cfg.samples_per_token
    codes = [list(rng.integers(0, 64, n)) for n in (9, 12, 7, 10, 11)][:take]
    begins = [2 * spt] * take
    ends = [(len(c) - 1) * spt for c in codes]
    segs = teng.decode_codes_batch_sliced(codes, [voice] * take, begins, ends)
    for c, b, e, seg in zip(codes, begins, ends, segs):
        full = teng.decode_codes(c, voice, apply_peak_normalization=False)
        assert seg.shape == (e - b,)
        np.testing.assert_allclose(seg, full[b:e], atol=1e-5)


def test_i16_transfer_within_one_lsb(engines):
    """The int16 wire format is the float slice scaled, clamped and
    truncated: within one 16-bit step of it, clipped at +-1."""
    _, teng, voices = engines
    voice = te.VoiceModel(voices[1])
    spt = teng.codec_cfg.samples_per_token
    codes = [list(range(3, 15)), list(range(20, 29))]
    ends = [len(c) * spt for c in codes]
    flt = teng.decode_codes_batch_sliced(codes, [voice] * 2, [0, 0], ends)
    teng.config.i16_transfer = True
    try:
        i16 = teng.decode_codes_batch_sliced(codes, [voice] * 2, [0, 0], ends)
    finally:
        teng.config.i16_transfer = False
    for a, b in zip(flt, i16):
        assert a.shape == b.shape
        assert np.abs(np.clip(a, -1, 1) - b).max() <= 1.01 / 32767.0
