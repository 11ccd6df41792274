"""miotts_tpu_torch codec + iSTFT against miotts_tpu on a tiny synthetic
MioCodec, exact f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.gguf import GGUFReader
from miotts_tpu.models import codec as jc
from miotts_tpu.models.synthetic import write_synthetic_codec
from miotts_tpu.ops import istft as ji
from miotts_tpu_torch.models import codec as tc
from miotts_tpu_torch.ops import istft as ti
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

N_CODES = 64


@pytest.fixture(scope="module")
def codec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("codec") / "codec.gguf")
    write_synthetic_codec(path, n_codes=N_CODES, seed=3)
    with GGUFReader(path) as r:
        jp, jcfg = jc.load_codec_params(r)
        tp, tcfg = tc.load_codec_params(r, device="cpu")
    emb = np.random.default_rng(11).standard_normal(jcfg.adaln_dim).astype(
        np.float32) * 0.3
    return jp, jcfg, tp, tcfg, emb


def _decode_both(codec, codes, n_real):
    jp, jcfg, tp, tcfg, emb = codec
    jlm, jph = jc.codec_decode_spec(jp, jnp.asarray(codes, jnp.int32),
                                    jnp.asarray(emb), jcfg,
                                    n_real=jnp.asarray(n_real, jnp.int32))
    tlm, tph = tc.codec_decode_spec(tp, torch.from_numpy(codes),
                                    torch.from_numpy(emb), tcfg,
                                    n_real=n_real)
    return (np.asarray(jlm), np.asarray(jph)), (tlm.numpy(), tph.numpy())


def test_config_matches(codec):
    _, jcfg, _, tcfg, _ = codec
    for f in ("n_fft", "hop_length", "samples_per_token", "prenet_dim",
              "decoder_dim", "up_factors", "up_kernels", "total_upsample"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f


@pytest.mark.parametrize("T,n_real", [(16, 16), (16, 11), (32, 5)])
def test_decode_spec_matches_jax(codec, T, n_real):
    """log_mag / phase within 1e-4 of their scale in exact f32 (both run
    full-f32 matmuls and convolutions; only summation order differs), over
    the real frames of a bucket with n_real <= T."""
    codes = np.random.default_rng(T + n_real).integers(
        0, N_CODES, T).astype(np.int32)
    (jlm, jph), (tlm, tph) = _decode_both(codec, codes, n_real)
    frames = n_real * codec[1].total_upsample
    assert tlm.shape == jlm.shape and tph.shape == jph.shape
    assert rel_err(tlm[:frames], jlm[:frames]) < 1e-4
    assert rel_err(tph[:frames], jph[:frames]) < 1e-4


def test_padded_decode_equals_unpadded(codec):
    """A decode padded to the next bucket equals the unpadded one on the
    real frames (f32, 1e-5 of scale)."""
    _, _, tp, tcfg, emb = codec
    codes = np.random.default_rng(5).integers(0, N_CODES, 11).astype(np.int32)
    padded = np.zeros(16, np.int32)
    padded[:11] = codes
    e = torch.from_numpy(emb)
    lm0, ph0 = tc.codec_decode_spec(tp, torch.from_numpy(codes), e, tcfg)
    lm1, ph1 = tc.codec_decode_spec(tp, torch.from_numpy(padded), e, tcfg,
                                    n_real=11)
    frames = lm0.shape[0]
    assert rel_err(lm1[:frames], lm0) < 1e-5
    assert rel_err(ph1[:frames], ph0) < 1e-5


def test_istft_matches_jax(codec):
    """iSTFT with and without a frame mask: within 1e-5 of the audio scale
    (one f32 basis matmul and an overlap-add)."""
    _, jcfg, _, tcfg, _ = codec
    rng = np.random.default_rng(7)
    S = 24
    re = rng.standard_normal((S, jcfg.n_freq)).astype(np.float32)
    im = rng.standard_normal((S, jcfg.n_freq)).astype(np.float32)
    mask = (np.arange(S) < 17).astype(np.float32)
    basis = ji.make_synthesis_basis(jcfg.n_fft)
    np.testing.assert_array_equal(basis[0],
                                  ti.make_synthesis_basis(tcfg.n_fft)[0])
    for m in (None, mask):
        want = np.asarray(ji.istft(*(jnp.asarray(a) for a in (re, im) + basis),
                                   jcfg.hop_length,
                                   None if m is None else jnp.asarray(m)))
        got = ti.istft(*(torch.from_numpy(a) for a in (re, im) + basis),
                       tcfg.hop_length,
                       None if m is None else torch.from_numpy(m)).numpy()
        assert got.shape == want.shape == (S * jcfg.hop_length,)
        assert rel_err(got, want) < 1e-5


def test_spec_to_audio_bucketed_matches_jax(codec):
    """Codec head -> audio on a bucket with 5 real codes of 8: within 1e-4
    of the audio scale over the real samples."""
    jp, jcfg, tp, tcfg, _ = codec
    rng = np.random.default_rng(8)
    S = 8 * jcfg.total_upsample
    lm = rng.standard_normal((S, jcfg.n_freq)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, (S, jcfg.n_freq)).astype(np.float32)
    want = np.asarray(ji.spec_to_audio_bucketed(
        jnp.asarray(lm), jnp.asarray(ph), jp["istft_cos_basis"],
        jp["istft_sin_basis"], jp["istft_hann"], jcfg.hop_length,
        jcfg.total_upsample, jnp.asarray(5, jnp.int32)))
    got = ti.spec_to_audio_bucketed(
        torch.from_numpy(lm), torch.from_numpy(ph), tp["istft_cos_basis"],
        tp["istft_sin_basis"], tp["istft_hann"], tcfg.hop_length,
        tcfg.total_upsample, 5).numpy()
    n = 5 * jcfg.samples_per_token
    assert rel_err(got[:n], want[:n]) < 1e-4


def test_exact_f32_restores_tf32_flags():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    with tc.exact_f32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == old
