"""The port's whole offline slice against the JAX package: skip-llm
replay, temperature-0 synthesis, the tokenizer without `regex`, parameter
conversion from JAX trees, the CLI, and the device contract."""

import dataclasses

import numpy as np
import pytest
import regex
import torch

from miotts_tpu.audio.wav import wav_read
from miotts_tpu.gguf import GGML_Q4_K, GGML_Q8_0, GGUFReader, write_voice_embedding
from miotts_tpu.models import codec as jc
from miotts_tpu.models import llm as jl
from miotts_tpu.models.synthetic import (synthetic_llm_config,
                                         write_synthetic_codec,
                                         write_synthetic_llm)
from miotts_tpu.runtime import engine as je
from miotts_tpu.text import format_speech_tokens
from miotts_tpu.text import tokenizer as jtok
from miotts_tpu_torch import cli as tcli
from miotts_tpu_torch.convert import codec_params_from_numpy, llm_params_from_numpy
from miotts_tpu_torch.models import codec as tc
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.runtime import engine as te
from miotts_tpu_torch.text import tokenizer as ttok
from torch_port_util import few_torch_threads, jax_tree_to_numpy  # noqa: F401

N_SPEECH = 64


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    paths = {k: str(d / f"{k}.gguf") for k in ("codec", "llm", "voice")}
    ccfg = write_synthetic_codec(paths["codec"], n_codes=N_SPEECH, seed=3)
    write_synthetic_llm(paths["llm"], quant_type=GGML_Q8_0, seed=5,
                        n_speech=N_SPEECH)
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    paths["dir"] = d
    return paths


@pytest.fixture(scope="module")
def engines(files):
    kw = dict(model_path=files["llm"], codec_path=files["codec"],
              max_tokens=40, llm_dtype="float32", prompt_bucket=32,
              code_bucket=16)
    jeng = je.TTSEngine(je.EngineConfig(**kw))
    teng = te.TTSEngine(te.EngineConfig(device="cpu", **kw))
    return (jeng, je.VoiceModel(files["voice"]), teng,
            te.VoiceModel(files["voice"]))


def test_skip_llm_replay_matches_jax(engines):
    """The same codes through both engines' codec + iSTFT + peak norm:
    identical length, peak 0.95, samples within 1e-4."""
    jeng, jvoice, teng, tvoice = engines
    text = format_speech_tokens(np.random.default_rng(0).integers(
        0, N_SPEECH, 21))
    want = jeng.synthesize(jvoice, text, je.Options(skip_llm=True))
    got = teng.synthesize(tvoice, text, te.Options(skip_llm=True))
    assert got.shape == want.shape == (21 * teng.samples_per_token,)
    assert abs(float(np.max(np.abs(got))) - 0.95) < 1e-6
    assert float(np.max(np.abs(got - want))) < 1e-4


def test_greedy_synthesis_matches_jax(engines):
    """Temperature 0 in f32: the same token ids and codes, audio within
    1e-4."""
    jeng, jvoice, teng, tvoice = engines
    opts = dict(temperature=0.0, max_tokens=40)
    jids = jeng.generate_tokens("hello world", je.Options(**opts))
    tids = teng.generate_tokens("hello world", te.Options(**opts))
    assert tids == jids and len(tids) > 0
    codes = teng.tokens_to_codes(tids)
    assert codes == jeng.tokens_to_codes(jids) and codes
    want = jeng.synthesize(jvoice, "hello world", je.Options(**opts))
    got = teng.synthesize(tvoice, "hello world", te.Options(**opts))
    assert got.shape == want.shape == (len(codes) * teng.samples_per_token,)
    assert float(np.max(np.abs(got - want))) < 1e-4


def test_sampled_generation_is_seeded(engines):
    _, _, teng, _ = engines
    runs = [teng.generate_tokens("seeded", te.Options(temperature=0.8,
                                                      max_tokens=20, seed=s))
            for s in (3, 3)]
    assert runs[0] == runs[1]


TEXTS = [
    "Hello, world! It's 2026: the 12:30 train costs $4.50 (about 5%).",
    "こんにちは、世界！今日は２０２６年です。ｶﾀｶﾅ　テスト…",
    "x² + y³ = z½, ①②③ Ⅻ 10⁴ ١٢٣ ๔๕ — done?!\n\n\tend  ",
    "MixedCASE can't won't I'LL 42abc abc42 ___ ...",
]


@pytest.mark.parametrize("pre", ["qwen2", "default", "llama3"])
def test_pretokenizer_matches_regex_package(pre):
    """The stdlib-`re` rebuild of \\p{L} / \\p{N} splits text exactly as the
    `regex` package does, including Unicode No / Nl digits (², ½, ①, Ⅻ)
    that `\\d` would miss."""
    pat = ttok._PRE_REGEX[pre]
    ref = regex.compile(pat)
    got = ttok._compile_pre(pat)
    extra = "".join(chr(c) for c in range(0x2070, 0x2190)) + \
        "".join(chr(c) for c in range(0xB2, 0xC0))
    for text in TEXTS + [extra]:
        assert ([m.group(0) for m in got.finditer(text)]
                == [m.group(0) for m in ref.finditer(text)])


def test_tokenizer_encode_matches_jax():
    """Byte-level BPE with merges over neighbouring characters (so a wrong
    pre-token split changes the ids) and the chat specials: the same ids as
    the JAX tokenizer on ASCII, Japanese and digit / symbol text."""
    b2u = jtok._byte_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    types = [jtok.TOKEN_TYPE_NORMAL] * 256
    for sp in ("<|im_start|>", "<|im_end|>"):
        tokens.append(sp)
        types.append(jtok.TOKEN_TYPE_CONTROL)
    merges = []
    for text in TEXTS:
        chars = "".join(b2u[b] for b in text.encode("utf-8"))
        for a, b in zip(chars, chars[1:]):
            if a + b not in tokens:
                merges.append(f"{a} {b}")
                tokens.append(a + b)
                types.append(jtok.TOKEN_TYPE_NORMAL)
    kw = dict(tokens=tokens, token_types=types, merges=merges, pre="qwen2")
    jt, tt = jtok.Tokenizer(**kw), ttok.Tokenizer(**kw)
    for text in TEXTS:
        prompt = f"<|im_start|>user\n{text}<|im_end|>\n"
        assert tt.encode(prompt) == jt.encode(prompt)
        assert tt.decode(tt.encode(prompt)) == prompt


def test_llm_params_from_numpy_match_gguf_load(files):
    """A JAX LLM tree (Q4_K packed + Q6_K fused mixed format, lane-padded)
    converts to tensors identical to the port's own GGUF load, and both
    give the same logits."""
    cfg = dataclasses.replace(synthetic_llm_config(n_speech=N_SPEECH),
                              dim=256, n_heads=4, n_kv_heads=2, head_dim=64,
                              ff_dim=256)
    path = str(files["dir"] / "llm_q4k.gguf")
    write_synthetic_llm(path, cfg=cfg, quant_type=GGML_Q4_K, seed=9,
                        mixed_k=True)
    with GGUFReader(path) as r:
        jp, _ = jl.load_llm_params(r, jl.LLMConfig.from_gguf(r),
                                   dtype=np.float32)
        tp, tcfg = tl.load_llm_params(r, dtype=torch.float32)
    conv = llm_params_from_numpy(jax_tree_to_numpy(jp))
    wqkv = conv["blocks"][0]["wqkv"]
    assert not wqkv.packed and wqkv.group == 16 and wqkv.mins is not None
    assert conv["blocks"][0]["w_gateup"].packed
    for blk_c, blk_t in zip(conv["blocks"], tp["blocks"]):
        assert blk_c.keys() == blk_t.keys()
        for k in blk_c:
            a, b = blk_c[k], blk_t[k]
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), k
            else:
                assert (a.mins is None) == (b.mins is None), k
                for f in ("values", "scales", "mins"):
                    if getattr(a, f) is not None:
                        assert torch.equal(getattr(a, f), getattr(b, f)), (k, f)
    toks = torch.arange(12)[None] % tcfg.n_vocab
    outs = []
    for params in (conv, tp):
        cache = tl.init_kv_cache(tcfg, 1, 32, dtype=torch.float32)
        outs.append(tl.llm_prefill(params, toks, torch.tensor([12]), cache,
                                   tcfg)[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_codec_params_from_numpy_match_gguf_load(files):
    with GGUFReader(files["codec"]) as r:
        jp, _ = jc.load_codec_params(r)
        tp, tcfg = tc.load_codec_params(r)
    conv = codec_params_from_numpy(jax_tree_to_numpy(jp))
    assert len(conv["decoder_blocks"]) == tcfg.decoder_layers
    codes = torch.from_numpy(np.random.default_rng(2).integers(
        0, N_SPEECH, 16).astype(np.int32))
    emb = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tcfg.adaln_dim).astype(np.float32))
    a = tc.codec_decode_spec(conv, codes, emb, tcfg, n_real=13)
    b = tc.codec_decode_spec(tp, codes, emb, tcfg, n_real=13)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cli_synth_cpu_writes_wav(files, tmp_path):
    out = str(tmp_path / "out.wav")
    rc = tcli.main(["synth", "-m", files["llm"], "-c", files["codec"], "-v",
                    files["voice"], "-p", "hi there", "--max-tokens", "24",
                    "-t", "0", "--device", "cpu", "-o", out])
    assert rc == 0
    audio, sr = wav_read(out)
    assert sr == 44100 and audio.size > 0 and np.isfinite(audio).all()
    assert audio.size % 1764 == 0


def test_cli_skip_llm_without_codes_fails(files, tmp_path, capsys):
    out = tmp_path / "none.wav"
    rc = tcli.main(["synth", "-c", files["codec"], "-v", files["voice"],
                    "-p", "no tokens", "--skip-llm", "--device", "cpu",
                    "-o", str(out)])
    assert rc == 1
    assert "no speech codes generated" in capsys.readouterr().err
    assert not out.exists()


def test_cuda_without_gpu_raises(files, monkeypatch, tmp_path, capsys):
    """Asking for the GPU with none present raises (engine) or exits 1
    (CLI); nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.TTSEngine(te.EngineConfig(codec_path=files["codec"]))
    out = tmp_path / "gpu.wav"
    rc = tcli.main(["synth", "-c", files["codec"], "-v", files["voice"],
                    "-p", "<|s_1|><|s_2|>", "--skip-llm", "-o", str(out)])
    assert rc == 1 and not out.exists()
    assert "CUDA is not available" in capsys.readouterr().err


def test_engine_defaults_to_cuda():
    assert te.EngineConfig().device == "cuda"
