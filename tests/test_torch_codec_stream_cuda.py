"""The codec's own CUDA stream (EngineConfig.codec_device) and fast mode
(EngineConfig.codec_fast) on the card, on tiny synthetic models written by
the port's own writer.  Imports nothing of JAX, so it runs on a GPU machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_codec_stream_cuda.py

The `cuda`-marked tests skip without a GPU.  Tolerances: the codec stream
against the default stream sample-exact (the same kernels, cuDNN's
deterministic algorithms, on another stream); an exact decode after a fast
one bit for bit the first; fast against exact within 1e-2 relative RMS,
chip_smoke.py's bound (TF32's 10-bit mantissa inside the JAX package's
bf16-input fast mode)."""

import numpy as np
import pytest
import torch

from miotts_tpu_torch.gguf import GGML_Q8_0, write_voice_embedding
from miotts_tpu_torch.models.llm import LLMConfig
from miotts_tpu_torch.models.synthetic import (write_synthetic_codec,
                                               write_synthetic_llm)
from miotts_tpu_torch.runtime import batching as tb
from miotts_tpu_torch.runtime import engine as te

KW = dict(max_tokens=40, llm_dtype="float32", prompt_bucket=32,
          code_bucket=16, holdback_codes=6, min_commit_step_codes=4,
          first_commit_codes=2)
FAST_RMS_TOL = 1e-2


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("codecstream")
    paths = {"codec": str(d / "codec.gguf"), "llm": str(d / "llm.gguf"),
             "voice": str(d / "voice.emb.gguf")}
    ccfg = write_synthetic_codec(paths["codec"], n_codes=64, seed=3)
    # a small dense model with the kernels' head dim (64)
    cfg = LLMConfig(arch="qwen2", n_layers=2, dim=128, n_heads=2,
                    n_kv_heads=1, head_dim=64, ff_dim=256,
                    n_vocab=256 + 3 + 64, n_ctx=512, rope_theta=1e6,
                    rope_style="neox", qkv_bias=True, qk_norm=False)
    write_synthetic_llm(paths["llm"], cfg=cfg, quant_type=GGML_Q8_0, seed=5)
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return paths


def _engine(files, **kw):
    return te.TTSEngine(te.EngineConfig(
        model_path=files["llm"], codec_path=files["codec"], device="cuda",
        **dict(KW, **kw)))


def _serve(eng, voice, fused: bool):
    batcher = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=10,
                                   fused=fused)
    chunks = {i: [] for i in range(3)}
    for i in range(3):
        batcher.submit(f"codec stream utterance {i}", voice,
                       lambda s, sr, last, i=i: s is None
                       or chunks[i].append(np.asarray(s).copy()) or True,
                       te.Options(max_tokens=37, temperature=0.8, seed=i))
    batcher.run_until_done(max_iters=300)
    assert batcher.pending == 0
    return {i: np.concatenate(c) if c else np.zeros(0, np.float32)
            for i, c in chunks.items()}


@pytest.mark.cuda
def test_codec_stream_decodes_sample_exact(files):
    """Every decode entry point on the codec stream (codec_device=0) gives
    the default stream's bits: decode_codes, decode_codes_async read
    through codec_readback, the batched sliced decode (int16 and f32) and
    the fused step's row decode; so do both batcher paths."""
    _need_gpu()
    base, side = _engine(files), _engine(files, codec_device=0)
    assert base._codec_stream is None
    assert side._codec_stream is not None
    assert side._codec_stream != torch.cuda.current_stream()
    voice = te.VoiceModel(files["voice"])
    codes = [int(c) for c in np.random.default_rng(2).integers(0, 64, 21)]
    for eng in (base, side):
        eng.warmup(max_codes=32, prompt_len=16)
    outs = []
    for eng in (base, side):
        full = eng.decode_codes(codes, voice, apply_peak_normalization=False)
        audio, n = eng.decode_codes_async(codes, voice)
        asyn = eng.codec_readback(audio).get()[0][:n * eng.samples_per_token]
        spt = eng.samples_per_token
        sliced = [eng.decode_codes_batch_sliced(
            [codes, codes[:9]], [voice] * 2, [3 * spt, 0], [17 * spt, 9 * spt],
            i16=i16) for i16 in (True, False)]
        buf = torch.tensor([codes[:16], codes[5:21]], dtype=torch.int32,
                           device="cuda")
        embs = torch.from_numpy(np.stack([voice.embedding] * 2)).cuda()
        rows = eng.decode_code_rows_sliced(buf, embs, [1, 0], [16, 12],
                                           [2 * spt, 0], [10 * spt, 4 * spt])
        outs.append([full, asyn] + sliced[0] + sliced[1] + rows)
    for a, b in zip(*outs):
        assert a.shape == b.shape and a.size
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs[0][0], outs[0][1])
    for fused in (False, True):
        want, got = _serve(base, voice, fused), _serve(side, voice, fused)
        for i in want:
            assert want[i].shape == got[i].shape
            np.testing.assert_array_equal(want[i], got[i])


@pytest.mark.cuda
def test_exact_decode_after_fast_keeps_its_bits(files):
    """codec_fast allows TF32 only inside its own decodes: an exact decode
    after a fast one gives the first exact decode's bits, and the fast
    decode stays within 1e-2 relative RMS of the exact one."""
    _need_gpu()
    exact, fast = _engine(files), _engine(files, codec_fast=True)
    voice = te.VoiceModel(files["voice"])
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    codes = [int(c) for c in np.random.default_rng(3).integers(0, 64, 24)]
    a1 = exact.decode_codes(codes, voice, apply_peak_normalization=False)
    af = fast.decode_codes(codes, voice, apply_peak_normalization=False)
    a2 = exact.decode_codes(codes, voice, apply_peak_normalization=False)
    np.testing.assert_array_equal(a1, a2)
    rms = float(np.sqrt(np.mean((af.astype(np.float64) - a1) ** 2))
                / np.sqrt(np.mean(a1.astype(np.float64) ** 2)))
    assert rms < FAST_RMS_TOL, rms
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags
