"""The port's sequence-parallel codec (miotts_tpu_torch.models.codec_sp)
on gloo ranks on the CPU against the JAX package's codec_decode_audio_sp
on a mesh of the same shape, padded and unpadded, and against the
single-device decode."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from miotts_tpu.gguf import GGUFReader
from miotts_tpu.models.codec import codec_decode_audio, load_codec_params
from miotts_tpu.models.codec_sp import codec_decode_audio_sp
from miotts_tpu.models.synthetic import write_synthetic_codec
from miotts_tpu.parallel.mesh import make_mesh
from miotts_tpu_torch.gguf import GGUFReader as TReader
from miotts_tpu_torch.models import codec as tcodec
from miotts_tpu_torch.parallel.launch import launch
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

import torch_parallel_workers as W

T, REAL = 32, 27
# (world, mesh shape): 8 codes a rank at (1, 4), 16 at (2, 2) and (1, 2);
# the synthetic codec's window 9 needs a halo of 4
CASES = [(2, (1, 2)), (4, (2, 2)), (4, (1, 4))]


@pytest.fixture(scope="module")
def codec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tsp") / "codec.gguf")
    write_synthetic_codec(path, n_codes=64, seed=3)
    with GGUFReader(path) as r:
        params, cfg = load_codec_params(r)
    rng = np.random.default_rng(42)
    codes = rng.integers(0, 64, T)
    emb = (rng.standard_normal(cfg.adaln_dim) * 0.3).astype(np.float32)
    return path, params, cfg, codes, emb


@pytest.fixture(scope="module")
def ranks(codec):
    path, _, _, codes, emb = codec
    out = {}
    for world in (2, 4):
        cases = [(shape, codes, emb, n_real) for w, shape in CASES
                 if w == world for n_real in (None, REAL)]
        res = launch(W.codec_sp_rank, world, (path, cases), timeout=240)
        i = 0
        for w, shape in CASES:
            if w == world:
                out[shape] = [(r[0][i], r[0][i + 1], r[1]) for r in res]
                i += 2
    return out


def _jax_sp(codec, shape, n_real):
    _, params, cfg, codes, emb = codec
    mesh = make_mesh(data=shape[0], model=shape[1],
                     devices=jax.devices()[:shape[0] * shape[1]])
    nr = None if n_real is None else jnp.asarray(n_real, jnp.int32)
    return np.asarray(codec_decode_audio_sp(
        params, jnp.asarray(codes, jnp.int32), jnp.asarray(emb), cfg, mesh,
        n_real=nr))


@pytest.mark.parametrize("world,shape", CASES)
def test_sp_matches_jax_sp(codec, ranks, world, shape):
    """Every rank's whole audio against JAX's SP decode at JAX's 2e-4, and
    within 1e-4 of the audio's scale."""
    want = _jax_sp(codec, shape, None)
    for got, _, _ in ranks[shape]:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-4)
        assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("world,shape", CASES)
def test_sp_padding_mask_matches_jax(codec, ranks, world, shape):
    """n_real < T: the first n_real codes' samples against JAX's."""
    want = _jax_sp(codec, shape, REAL)
    n = REAL * codec[2].samples_per_token
    for _, got, _ in ranks[shape]:
        np.testing.assert_allclose(got[:n], want[:n], atol=2e-4)
        assert rel_err(got[:n], want[:n]) < 1e-4


@pytest.mark.parametrize("world,shape", CASES)
def test_sp_matches_single_device(codec, ranks, world, shape):
    """Against the port's own single-device decode (exact f32, only the
    order of sums differs): 1e-5 of the scale, and JAX's single-device
    decode at 2e-4."""
    path, params, cfg, codes, emb = codec
    with TReader(path) as r:
        tparams, tcfg = tcodec.load_codec_params(r)
    for n_real, idx in ((None, 0), (REAL, 1)):
        want = tcodec.codec_decode_audio(tparams, torch.from_numpy(codes),
                                         torch.from_numpy(emb), tcfg,
                                         n_real=n_real).numpy()
        jwant = np.asarray(codec_decode_audio(
            params, jnp.asarray(codes, jnp.int32), jnp.asarray(emb), cfg,
            n_real=None if n_real is None else jnp.asarray(n_real)))
        n = (n_real or T) * cfg.samples_per_token
        for res in ranks[shape]:
            got = res[idx][:n]
            assert rel_err(got, want[:n]) < 1e-5
            np.testing.assert_allclose(got, jwant[:n], atol=2e-4)


def test_sp_refuses_bad_lengths(ranks):
    """JAX's asserts: T divisible by the axis size, each chunk at least the
    attention halo."""
    for shape in ((1, 2), (1, 4)):
        for _, _, refused in ranks[shape]:
            assert refused == [True, True]
