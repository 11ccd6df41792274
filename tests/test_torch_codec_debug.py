"""The codec's debug surface in miotts_tpu_torch against miotts_tpu on a tiny
synthetic MioCodec, exact f32: `codec_decode_stages`,
`codec_decoder_layer_substeps`, `codec_decode_audio` and the CLI's
`synth --dump-tensors`."""

import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu import cli as jcli
from miotts_tpu.gguf import GGUFReader
from miotts_tpu.models import codec as jc
from miotts_tpu.models.synthetic import write_synthetic_codec
from miotts_tpu_torch import cli as tcli
from miotts_tpu_torch.models import codec as tc
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

N_CODES = 64
STAGES = ("token_embd", "prenet", "prenet_out", "upsample", "prior",
          "decoder", "final_adaln", "post", "upsampler_0", "upsampler_1",
          "upsampler_out", "log_mag", "phase")
# tests/test_codec.py's names, with layer_in and the FFN's shift / scale /
# gate (the JAX function's 32)
SUBSTEPS = ("layer_in", "silu_cond", "attn_cond_out", "attn_shift",
            "attn_scale", "attn_gate", "x_norm", "x_modulated", "q_proj",
            "k_proj", "v_proj", "q_rope", "k_rope", "attn_scores",
            "attn_probs", "attn_ctx", "attn_out", "gated_attn",
            "attn_residual", "ffn_cond_out", "ffn_shift", "ffn_scale",
            "ffn_gate", "h_norm", "h_modulated", "ffn_gate_proj",
            "ffn_up_proj", "ffn_silu_gate", "ffn_gated", "ffn_out",
            "gated_ffn", "layer_out")
# f32 on both sides (JAX at Precision.HIGHEST, the port with TF32 off):
# only the order of the sums differs
TOL = 1e-5


@pytest.fixture(scope="module")
def codec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("codec") / "codec.gguf")
    write_synthetic_codec(path, n_codes=N_CODES, seed=3)
    with GGUFReader(path) as r:
        jp, jcfg = jc.load_codec_params(r)
        tp, tcfg = tc.load_codec_params(r, device="cpu")
    emb = np.random.default_rng(11).standard_normal(jcfg.adaln_dim).astype(
        np.float32) * 0.3
    codes = np.random.default_rng(4).integers(0, N_CODES, 6).astype(np.int32)
    return dict(path=path, jp=jp, jcfg=jcfg, tp=tp, tcfg=tcfg, emb=emb,
                codes=codes)


def test_decode_stages_match_jax(codec):
    """The same stage names in the same order, each of JAX's shape (no
    batch axis) and within 1e-5 of its scale; the returned (log_mag,
    phase) are the last two stages and codec_decode_spec's output."""
    c = codec
    jst, (jlm, jph) = jc.codec_decode_stages(c["jp"], c["codes"], c["emb"],
                                             c["jcfg"])
    tst, (tlm, tph) = tc.codec_decode_stages(c["tp"], c["codes"], c["emb"],
                                             c["tcfg"])
    assert tuple(jst) == STAGES and tuple(tst) == STAGES
    for name in STAGES:
        assert tst[name].shape == jst[name].shape, name
        assert tst[name].dtype == np.float32, name
        assert rel_err(tst[name], jst[name]) < TOL, (
            name, rel_err(tst[name], jst[name]))
    np.testing.assert_array_equal(tlm.numpy(), tst["log_mag"])
    np.testing.assert_array_equal(tph.numpy(), tst["phase"])
    lm, ph = tc.codec_decode_spec(c["tp"], torch.from_numpy(c["codes"]),
                                  torch.from_numpy(c["emb"]), c["tcfg"])
    np.testing.assert_array_equal(lm.numpy(), tst["log_mag"])
    np.testing.assert_array_equal(ph.numpy(), tst["phase"])


def test_decode_without_tap_unchanged(codec):
    """The tap is the only addition to the forward: a decode without it
    gives codec_decode_stages' output bits."""
    c = codec
    codes = torch.from_numpy(c["codes"]).long()[None]
    emb = torch.from_numpy(c["emb"])[None]
    n = torch.tensor([codes.shape[1]])
    seen = []
    with torch.inference_mode(), tc.exact_f32():
        plain = tc._codec_forward(c["tp"], codes, emb, c["tcfg"], n)
        tapped = tc._codec_forward(c["tp"], codes, emb, c["tcfg"], n,
                                   lambda name, x: seen.append(name))
    assert tuple(seen) == STAGES
    for a, b in zip(plain, tapped):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layer", ["first", "last"])
def test_decoder_layer_substeps_match_jax(codec, layer):
    """At layer 0 and the last layer: JAX's 32 names in its order, each
    within 1e-5 of JAX's value, the expansion within 1e-5 of the
    production layer, layer_in at layer 0 = prior, layer_out at the last
    layer = decoder."""
    c = codec
    n_layers = len(c["tp"]["decoder_blocks"])
    li = 0 if layer == "first" else n_layers - 1
    jsub, jdiff = jc.codec_decoder_layer_substeps(
        c["jp"], c["codes"], c["emb"], c["jcfg"], li)
    tsub, tdiff = tc.codec_decoder_layer_substeps(
        c["tp"], c["codes"], c["emb"], c["tcfg"], li)
    assert tuple(jsub) == SUBSTEPS and tuple(tsub) == SUBSTEPS
    assert jdiff < TOL and tdiff < TOL, (jdiff, tdiff)
    for name in SUBSTEPS:
        assert tsub[name].shape == jsub[name].shape, name
        assert rel_err(tsub[name], jsub[name]) < TOL, (
            name, rel_err(tsub[name], jsub[name]))
    stages, _ = tc.codec_decode_stages(c["tp"], c["codes"], c["emb"],
                                       c["tcfg"])
    if li == 0:
        np.testing.assert_array_equal(tsub["layer_in"], stages["prior"])
    else:
        assert rel_err(tsub["layer_out"], stages["decoder"]) < TOL
    np.testing.assert_allclose(tsub["attn_probs"].sum(-1), 1.0, atol=1e-5)


def test_decoder_layer_substeps_out_of_range(codec):
    c = codec
    n_layers = len(c["tp"]["decoder_blocks"])
    for li in (n_layers, -1):
        with pytest.raises(ValueError):
            tc.codec_decoder_layer_substeps(c["tp"], c["codes"], c["emb"],
                                            c["tcfg"], li)


@pytest.mark.parametrize("T,n_real", [(6, None), (16, 11)])
def test_decode_audio_matches_jax(codec, T, n_real):
    """codes -> PCM in one call: unpadded, and padded to a bucket of 16 with
    JAX's n_real frame mask (the real samples compared), within 1e-4 of
    the audio's scale; padded equals the unpadded decode of the real codes
    on those samples."""
    c = codec
    codes = np.random.default_rng(T).integers(0, N_CODES, T).astype(np.int32)
    nr = None if n_real is None else jnp.asarray(n_real, jnp.int32)
    want = np.asarray(jc.codec_decode_audio(
        c["jp"], jnp.asarray(codes), jnp.asarray(c["emb"]), c["jcfg"], nr))
    got = tc.codec_decode_audio(c["tp"], torch.from_numpy(codes),
                                torch.from_numpy(c["emb"]), c["tcfg"],
                                n_real).numpy()
    assert got.shape == want.shape == (T * c["tcfg"].samples_per_token,)
    n = (T if n_real is None else n_real) * c["tcfg"].samples_per_token
    assert rel_err(got[:n], want[:n]) < 1e-4, rel_err(got[:n], want[:n])
    if n_real is not None:
        alone = tc.codec_decode_audio(
            c["tp"], torch.from_numpy(codes[:n_real]),
            torch.from_numpy(c["emb"]), c["tcfg"]).numpy()
        assert rel_err(got[:n], alone) < 1e-5


def test_decode_audio_batch_rows_match_single(codec):
    """A batch of two rows with their own n_real gives each row's
    single-row audio on its real samples."""
    c = codec
    spt = c["tcfg"].samples_per_token
    codes = np.random.default_rng(8).integers(0, N_CODES, (2, 16)).astype(
        np.int32)
    embs = np.stack([c["emb"], -c["emb"]])
    lens = [16, 9]
    got = tc.codec_decode_audio(c["tp"], torch.from_numpy(codes),
                                torch.from_numpy(embs), c["tcfg"],
                                torch.tensor(lens)).numpy()
    for i, n in enumerate(lens):
        one = tc.codec_decode_audio(c["tp"], torch.from_numpy(codes[i]),
                                    torch.from_numpy(embs[i]), c["tcfg"],
                                    n).numpy()
        assert rel_err(got[i, :n * spt], one[:n * spt]) < 1e-5


def _stdout_of(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_dump_tensors_matches_jax_cli(codec):
    """`synth --dump-tensors` prints the codec GGUF's tensors byte for byte
    as the JAX CLI does, with no --prompt, and exits 0."""
    argv = ["synth", "-c", codec["path"], "--dump-tensors"]
    jrc, jout = _stdout_of(jcli.main, argv)
    trc, tout = _stdout_of(tcli.main, argv)
    assert jrc == trc == 0
    assert tout == jout
    lines = tout.splitlines()
    with GGUFReader(codec["path"]) as r:
        n = len(r.tensors)
    assert lines[0] == f"Tensors in {codec['path']}: {n}"
    assert len(lines) == n + 1
