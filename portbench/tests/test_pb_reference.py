"""The plain reference against the program (miotts_tpu_torch) on the CPU:
the seeded files load through the program's reader and loader, the
reference dequantizes the same bytes to the same values, and its LLM,
codec, sampler draw and emission replay agree with the program's at a
tiny size."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import codec as ref_codec
from portbench.reference import dequant, serving
from portbench.reference.llm import forward_logits

from .conftest import TINY_CODEC, TINY_DENSE, TINY_LFM2, TINY_Q4_K_M


@pytest.mark.parametrize("cfg", [TINY_DENSE, TINY_LFM2],
                         ids=["dense", "lfm2"])
def test_loader_reads_the_files_and_reference_dequantizes_alike(cfg):
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.gguf.quants import dequantize
    from miotts_tpu_torch.models.llm import LLMConfig, load_llm_params
    s = weights.shape_of(cfg)
    m = weights.make_llm(s, 2 ** 31 + 77, "cpu")
    with weights.memory_file(m, "llm") as path, GGUFReader(path) as r:
        c = LLMConfig.from_gguf(r)
        assert (c.n_layers, c.dim, c.n_heads, c.n_kv_heads, c.head_dim,
                c.ff_dim, c.n_vocab) == (s.n_layers, s.dim, s.n_heads,
                                         s.n_kv_heads, s.head_dim,
                                         s.sizes["ff"], s.n_vocab)
        assert c.tie_embedding == s.tie
        load_llm_params(r, c, dtype=torch.float32, device="cpu")
        formats = set()
        for name, t in m.tensors.items():
            n = int(np.prod(t.shape))
            theirs = dequantize(r.tensor_raw(name), r.tensors[name].ggml_type,
                                n)
            ours = dequant.dequantize(torch.from_numpy(t.payload), t.ggml_type,
                                      t.shape)
            assert np.array_equal(theirs.reshape(t.shape), ours.numpy()), name
            formats.add(t.ggml_type)
            if t.ggml_type:
                # the drawn blocks: a spread of about 1 / sqrt(K)
                sd = float(ours.std()) * np.sqrt(t.shape[1])
                assert 0.8 < sd < 1.25, (name, sd)
    assert formats == ({0, 12, 14} if cfg is TINY_DENSE else {0, 8})


@pytest.mark.parametrize("cfg", [TINY_DENSE, TINY_LFM2, TINY_Q4_K_M],
                         ids=["dense", "lfm2", "q4_k_m"])
def test_reference_llm_matches_the_program_in_f32(cfg):
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.llm import (LLMConfig, init_kv_cache,
                                             llm_forward, load_llm_params)
    s = weights.shape_of(cfg)
    m = weights.make_llm(s, 5, "cpu")
    with weights.memory_file(m, "llm") as path, GGUFReader(path) as r:
        c = LLMConfig.from_gguf(r)
        params, _ = load_llm_params(r, c, dtype=torch.float32, device="cpu")
    ids = serving.prompt_ids("こんにちは、世界です") + list(range(300, 340))
    n = len(ids)
    logits, _ = llm_forward(params, torch.tensor([ids]),
                            torch.arange(n)[None],
                            init_kv_cache(c, 1, 256, dtype=torch.float32), c,
                            advance=torch.tensor([n], dtype=torch.int32))
    ref = forward_logits(m.tensors, s, [ids, ids[:7]], "cpu")
    assert ref[0].shape == (n, s.n_vocab)
    assert float((logits[0] - ref[0]).abs().max()) < 1e-4
    assert torch.equal(ref[1], ref[0][:7]) or float(
        (ref[1] - ref[0][:7]).abs().max()) < 1e-5


def test_reference_codec_matches_the_program():
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.codec import (codec_decode_audio,
                                               load_codec_params)
    cfg = dict(weights.CODEC, **TINY_CODEC)
    m = weights.make_codec(cfg, 64, 9, "cpu")
    voice = weights.make_voice(cfg["adaln_dim"], 9, "cpu")
    with weights.memory_file(m, "codec") as path, GGUFReader(path) as r:
        params, ccfg = load_codec_params(r, device="cpu")
    codes = list(np.random.default_rng(0).integers(0, 64, 23))
    ours = ref_codec.Codec(m, cfg, "cpu").decode(codes, voice).numpy()
    theirs = codec_decode_audio(params, torch.tensor(codes),
                                torch.from_numpy(voice), ccfg).numpy()
    assert ours.shape == (23 * cfg["samples_per_token"],) == theirs.shape
    assert np.abs(ours).max() < 0.9
    assert np.abs(ours - theirs).max() < 1e-5 * max(1.0, np.abs(ours).max())


def test_draws_and_emission_replay_match_the_program():
    from miotts_tpu_torch.models.llm import slot_uniform
    from miotts_tpu_torch.runtime.engine import emit_chunks
    seeds = [0, 1, 2 ** 62 - 1, 1234567890123]
    for s in seeds:
        got = slot_uniform(torch.tensor([s] * 5),
                           torch.arange(5)).tolist()
        assert got == [serving.uniform(s, k) for k in range(5)]
    rng = np.random.default_rng(1)
    decodes = {n: (rng.standard_normal(n * 100) * 0.3).astype(np.float32)
               for n in (50, 80, 91)}
    commits = [(50, 0, 18), (80, 18, 48), (91, 48, 91)]
    ours = serving.replay(commits, decodes.__getitem__, 100)
    pieces, tail = [], np.zeros(0, np.float32)
    for n, b, e in commits:
        a = serving.to_int16(decodes[n][b * 100:e * 100])
        _, tail = emit_chunks(a, 0, a.size, False, tail, 4096, 44100,
                              lambda c, last: pieces.append(c) or True)
    assert np.array_equal(ours, np.concatenate(pieces))
    x = np.array([1.5, -1.5, 0.99999, -0.3, 3e-5], np.float32)
    q = torch.clamp(torch.from_numpy(x) * 32767.0, -32768, 32767).to(
        torch.int16).numpy().astype(np.float32) / 32767.0
    assert np.array_equal(serving.to_int16(x), q)
