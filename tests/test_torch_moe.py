"""The port's lfm2moe (ops/moe.py, models/llm.py) on the CPU against its plain
reference (miotts_tpu_torch/reference/lfm2_moe.py) on a tiny model (dim 64,
conv / attn / conv / conv, one leading dense layer, 8 experts of width 64,
2 a token, Q8_0): prefill logits, stepwise decode through the cache,
greedy tokens of the batched chunk; the routing's bias and ties; the
expert counters in the batcher's stage; the dense and lfm2 models' logits
as before, bit for bit; and the refusals of a tensor-parallel expert model
and of a Q4_K expert stack.

f32 tolerance 1e-5 of the logit scale: the port and the reference compute
the same f32 equations from the same dequantized weights; only the order
of the sums differs (the experts' f32 sums, the conv, attention over the
cache)."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from miotts_tpu_torch.gguf import (GGML_F32, GGML_Q4_K, GGML_Q8_0, GGUFReader,
                                   write_voice_embedding)
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.models.synthetic import (synthetic_lfm2moe_config,
                                               synthetic_llm_config,
                                               write_synthetic_codec,
                                               write_synthetic_llm)
from miotts_tpu_torch.ops import moe
from miotts_tpu_torch.reference import lfm2_moe as ref
from miotts_tpu_torch.runtime import batching as tb
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import few_torch_threads  # noqa: F401

N_SPEECH = 64
TOL = 1e-5
PROMPT = [256, 5, 6, 7, 300, 301, 302, 40, 41, 42, 43, 44]
# sha256 of the prefill and three greedy decode steps' logits of a tiny
# Q8_0 dense (qwen2) and LFM2 model, as the port gave them before it had
# expert layers
BEFORE = {
    ("qwen2", torch.float32):
        "d0a62892b568df6ac6477fbe43a83574f637ea78750cea43cee041e052bf0dc9",
    ("qwen2", torch.bfloat16):
        "3f38a643fbf71a65bf80b9fb91bfaf47c0c78506764b971b4eacdd2826558929",
    ("lfm2", torch.float32):
        "4bb2e59a2659c14acffafe1cbd187cd2a1e8e68ec4bd43c6051589f949570776",
    ("lfm2", torch.bfloat16):
        "e8ce6794a872f55526fc21506e4deb8974b8680c52b02ed088393f5f69e22c1b",
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    paths = {k: str(d / f"{k}.gguf") for k in ("llm", "codec", "voice")}
    write_synthetic_llm(paths["llm"], cfg=synthetic_lfm2moe_config(N_SPEECH),
                        quant_type=GGML_Q8_0, seed=3)
    ccfg = write_synthetic_codec(paths["codec"], n_codes=N_SPEECH, seed=3)
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return paths


@pytest.fixture(scope="module")
def model(files):
    with GGUFReader(files["llm"]) as r:
        cfg = tl.LLMConfig.from_gguf(r)
        params, _ = tl.load_llm_params(r, cfg, dtype=torch.float32)
    kv, tensors = ref.read_gguf(files["llm"])
    return params, cfg, ref.Model(kv, tensors)


def _close(got, want):
    assert (got - want).abs().max() <= TOL * want.abs().max()


def test_config_and_layers(model):
    params, cfg, _ = model
    assert (cfg.arch, cfg.n_experts, cfg.n_experts_used, cfg.expert_ff_dim,
            cfg.n_dense_layers) == ("lfm2moe", 8, 2, 64, 1)
    layers = params["layers"]
    assert "w_gateup" in layers[0] and "moe" not in layers[0]
    for blk in layers[1:]:
        m = blk["moe"]
        assert "w_gateup" not in blk and "w_down" not in blk
        assert m.gateup.shape == (8, 128, 64) and m.down.shape == (8, 64, 64)
        assert m.router.dtype == m.bias.dtype == torch.float32
        assert m.counters is layers[1]["moe"].counters


def test_stacks_hold_the_files_weights(files, model):
    """The repacked stacks dequantize to the GGUF's Q8_0 values."""
    params, _, r = model
    m = params["layers"][2]["moe"]
    gate, up = r.w("blk.2.ffn_gate_exps.weight"), r.w("blk.2.ffn_up_exps.weight")
    for e in range(8):
        assert torch.equal(m.gateup.dequant(e), torch.cat([gate[e], up[e]]))
        assert torch.equal(m.down.dequant(e),
                           r.w("blk.2.ffn_down_exps.weight")[e])


def test_prefill_logits_match_the_reference(model):
    params, cfg, r = model
    toks = torch.tensor([PROMPT])
    cache = tl.init_kv_cache(cfg, 1, 64, dtype=torch.float32)
    logits, _ = tl.llm_forward(params, toks, torch.arange(len(PROMPT))[None],
                               cache, cfg)
    _close(logits[0], ref.forward(r, [PROMPT])[0])


def test_stepwise_decode_matches_the_references_full_forward(model):
    params, cfg, r = model
    cache = tl.init_kv_cache(cfg, 1, 64, dtype=torch.float32)
    n = 5
    last, cache = tl.llm_prefill(params, torch.tensor([PROMPT[:n]]),
                                 torch.tensor([n]), cache, cfg)
    got = [last[0]]
    for tok in PROMPT[n:]:
        lg, cache = tl.llm_decode_step(params, torch.tensor([tok]), cache, cfg)
        got.append(lg[0])
    want = ref.forward(r, [PROMPT])[0][n - 1:]
    _close(torch.stack(got), want)


def test_batched_chunk_greedy_tokens_follow_the_reference(model):
    """Three slots of different prompts through llm_prefill_slots and two
    greedy chunks of llm_generate_chunk_batched: every token is the
    reference's argmax at its position (the full forward over prompt and
    tokens), and the chunk's last logits are the reference's."""
    params, cfg, r = model
    prompts = [PROMPT, PROMPT[:7], [256, 9, 300, 310, 320]]
    B, steps = len(prompts), 6
    cache = tl.init_kv_cache(cfg, B, 64, dtype=torch.float32)
    S = max(map(len, prompts))
    toks = torch.zeros((B, S), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    last, cache = tl.llm_prefill_slots(
        params, toks, torch.tensor([len(p) for p in prompts]), cache,
        torch.arange(B), cfg)
    active = torch.ones(B, dtype=torch.bool)
    seed = torch.zeros(B, dtype=torch.int64)
    drawn = torch.zeros(B, dtype=torch.int64)
    temp = torch.zeros(B)
    out = []
    for _ in range(2):
        buf, active, last, cache, drawn = tl.llm_generate_chunk_batched(
            params, last, cache, active, seed, drawn, temp,
            torch.tensor([-1]), cfg, steps)
        out.append(buf)
    gen = torch.cat(out, dim=1)
    assert (gen >= 0).all()
    seqs = [p + gen[i].tolist() for i, p in enumerate(prompts)]
    want = ref.forward(r, seqs)
    for i, p in enumerate(prompts):
        lg = want[i][len(p) - 1:-1]
        assert gen[i].tolist() == lg.argmax(-1).tolist()
        _close(last[i], want[i][-1])


def test_the_bias_only_selects():
    """Logits that put experts 0 and 1 first; a bias of +0.15 on expert 2
    moves it into the top 2 (in place of 1), and its weight is still its
    unbiased sigmoid over the chosen sigmoids' sum."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0]])
    bias = torch.tensor([0.0, 0.0, 0.15, 0.0])
    rt = moe.moe_route_plain(logits, torch.zeros(4), 2, 1.0, True)
    assert rt.ids.tolist() == [[0, 1]]
    rt = moe.moe_route_plain(logits, bias, 2, 1.0, True)
    assert rt.ids.tolist() == [[0, 2]]
    s = torch.sigmoid(logits[0, [0, 2]])
    assert torch.allclose(rt.wts[0], s / s.sum(), rtol=1e-6, atol=0)
    ids, w = ref.route(logits, bias, 2, 1.0, True)
    assert ids.tolist() == [[0, 2]] and torch.allclose(w, rt.wts)
    rt = moe.moe_route_plain(logits, bias, 2, 2.5, False)
    assert torch.allclose(rt.wts[0], 2.5 * s, rtol=1e-6, atol=0)


def test_ties_go_to_the_lowest_index_as_the_references():
    logits = torch.tensor([[0.5, 1.0, 1.0, 0.5, 1.0],
                           [0.0, 0.0, 0.0, 0.0, 0.0],
                           [3.0, 1.0, 1.0, 1.0, 3.0]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.5, 0.0])
    rt = moe.moe_route_plain(logits, bias, 3, 1.0, True)
    ids, w = ref.route(logits, bias, 3, 1.0, True)
    assert rt.ids.tolist() == ids.tolist() == [[3, 1, 2], [3, 0, 1],
                                               [3, 0, 4]]
    assert torch.allclose(rt.wts, w, rtol=1e-6, atol=0)
    # the routed order: each expert's pairs in pair order
    assert rt.offsets.tolist() == [0, 2, 4, 5, 8, 9]
    assert rt.order.tolist() == [4, 7, 1, 5, 2, 0, 3, 6, 8]


def test_counters_count_pairs_and_experts_read(model):
    params, cfg, _ = model
    counters = params["layers"][1]["moe"].counters
    counters.zero_()
    cache = tl.init_kv_cache(cfg, 1, 64, dtype=torch.float32)
    tl.llm_prefill(params, torch.tensor([PROMPT]), torch.tensor([12]), cache,
                   cfg)
    pairs, reads = counters.tolist()
    assert pairs == 12 * 2 * 3 and 3 * 2 <= reads <= 3 * 8


@pytest.fixture(scope="module")
def engine(files):
    eng = te.TTSEngine(te.EngineConfig(
        model_path=files["llm"], codec_path=files["codec"], device="cpu",
        max_tokens=40, llm_dtype="float32", prompt_bucket=32,
        code_bucket=16))
    return eng, te.VoiceModel(files["voice"])


def test_the_batcher_folds_the_counters_into_its_stage(engine):
    """Two requests on two slots: the stage's moe_pairs is every pair the
    expert layers computed since warmup() (prefill waves and chunks), read
    with the chunks' tokens."""
    eng, voice = engine
    b = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=4)
    b.warmup(32)
    counters = eng.llm_params["layers"][1]["moe"].counters
    base = counters.tolist()
    done = []
    for text in ("moe one", "moe two three"):
        b.submit(text, voice, lambda s, sr, last: True,
                 te.Options(max_tokens=12, temperature=0.0, seed=1),
                 on_finish=done.append)
    b.run_until_done()
    assert len(done) == 2
    pairs, reads = (n - m for n, m in zip(counters.tolist(), base))
    assert b.stage["moe_pairs"] == pairs > 0
    assert b.stage["moe_expert_reads"] == reads > 0
    assert pairs % (2 * 3) == 0


def test_a_model_without_experts_counts_none(tmp_path):
    path = str(tmp_path / "lfm2.gguf")
    cfg = dataclasses.replace(synthetic_llm_config(arch="lfm2"), n_layers=2,
                              layer_types=("conv", "attn"), n_ctx=512)
    write_synthetic_llm(path, cfg=cfg, quant_type=GGML_F32, seed=2)
    codec = str(tmp_path / "codec.gguf")
    write_synthetic_codec(codec, n_codes=N_SPEECH, seed=3)
    eng = te.TTSEngine(te.EngineConfig(
        model_path=path, codec_path=codec, device="cpu", max_tokens=8,
        llm_dtype="float32", prompt_bucket=32, code_bucket=16))
    b = tb.ContinuousBatcher(eng, n_slots=2, chunk_steps=4)
    b.submit("no experts", te.VoiceModel(embedding=np.zeros(
        eng.codec_cfg.adaln_dim, np.float32)), lambda s, sr, last: True,
        te.Options(max_tokens=6, temperature=0.0, seed=1))
    b.run_until_done()
    assert b.stage["moe_pairs"] == b.stage["moe_expert_reads"] == 0
    assert b.stage["device_steps"] > 0


@pytest.mark.parametrize("arch", ["qwen2", "lfm2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dense_and_lfm2_logits_are_unchanged(tmp_path, arch, dtype):
    cfg = synthetic_llm_config(arch=arch)
    if arch == "lfm2":
        cfg = dataclasses.replace(cfg, n_layers=4,
                                  layer_types=("conv", "attn", "conv", "attn"))
    path = str(tmp_path / "m.gguf")
    write_synthetic_llm(path, cfg=cfg, quant_type=GGML_Q8_0, seed=7)
    with GGUFReader(path) as r:
        c = tl.LLMConfig.from_gguf(r)
        params, _ = tl.load_llm_params(r, c, dtype=dtype)
    assert type(c) is tl.LLMConfig and c.moe_layer_idx == ()
    cache = tl.init_kv_cache(c, 1, 64, dtype=dtype)
    last, cache = tl.llm_prefill(params, torch.tensor([PROMPT]),
                                 torch.tensor([12]), cache, c)
    outs, tok = [last], torch.tensor([301])
    for _ in range(3):
        lg, cache = tl.llm_decode_step(params, tok, cache, c)
        outs.append(lg)
        tok = lg.argmax(-1)
    got = hashlib.sha256(b"".join(o.float().contiguous().numpy().tobytes()
                                  for o in outs)).hexdigest()
    assert got == BEFORE[(arch, dtype)]


def test_tensor_parallel_sharding_refuses_an_expert_model(model):
    from miotts_tpu_torch.parallel.sharding import shard_llm_params
    params, cfg, _ = model
    with pytest.raises(ValueError, match=r"tensor-parallel.*expert"):
        shard_llm_params(params, mesh=None, cfg=cfg)


def test_a_q4_k_expert_stack_is_refused_by_name(tmp_path):
    cfg = dataclasses.replace(synthetic_lfm2moe_config(N_SPEECH), dim=256,
                              head_dim=64, ff_dim=256, expert_ff_dim=256)
    path = str(tmp_path / "q4k.gguf")
    write_synthetic_llm(path, cfg=cfg, quant_type=GGML_Q4_K, seed=1)
    with GGUFReader(path) as r:
        with pytest.raises(ValueError, match=r"blk\.1\.ffn_gate_exps\.weight"
                                             r".*Q8_0 only, got Q4_K"):
            tl.load_llm_params(r, tl.LLMConfig.from_gguf(r))
