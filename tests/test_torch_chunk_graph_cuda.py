"""The batcher's CUDA graphs of the unfused chunk on the card
(miotts_tpu_torch.runtime.batching): a warmed-up batcher replays one graph
per attention length, and every step it serves is bit for bit the eager
chunk's.  Tiny LFM2 written by the port's own writer, with the kernels'
head dim (64), bf16 activations, Q8_0.  Imports nothing of JAX, so it runs
on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chunk_graph_cuda.py

The `cuda`-marked tests skip without a GPU."""

import numpy as np
import pytest
import torch

from miotts_tpu_torch.gguf import GGML_Q8_0, write_voice_embedding
from miotts_tpu_torch.models.llm import LLMConfig
from miotts_tpu_torch.models.synthetic import (write_synthetic_codec,
                                               write_synthetic_llm)
from miotts_tpu_torch.ops import qmat
from miotts_tpu_torch.ops.decode_attn import decode_attention_batched
from miotts_tpu_torch.ops.qmat import qdot
from miotts_tpu_torch.runtime import batching as tb
from miotts_tpu_torch.runtime import engine as te
from miotts_tpu_torch.runtime.profile import tracer

N_SPEECH = 64
CTX = 512                  # attention lengths 128, 256 and 0 (all 512)
KW = dict(max_tokens=200, llm_dtype="bfloat16", prompt_bucket=32,
          code_bucket=16, holdback_codes=6, min_commit_step_codes=4,
          first_commit_codes=2)
# (text, max_tokens, temperature, seed): four slots, the first request
# ends after a chunk and the fifth takes its slot; prompts of 40-90
# tokens grow past 128 positions, so the chunks take two lengths or more
REQUESTS = [("graph a", 10, 0.8, 1), ("graph b " * 6, 140, 0.0, 2),
            ("graph c " * 3, 90, 0.8, 3), ("graph d " * 9, 120, 0.8, 4),
            ("graph e " * 4, 60, 0.0, 5)]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("chunkgraphcuda")
    paths = {k: str(d / f"{k}.gguf") for k in ("llm", "codec", "voice")}
    ccfg = write_synthetic_codec(paths["codec"], n_codes=N_SPEECH, seed=3)
    cfg = LLMConfig(arch="lfm2", n_layers=4, dim=256, n_heads=4,
                    n_kv_heads=2, head_dim=64, ff_dim=512,
                    n_vocab=256 + 3 + N_SPEECH, n_ctx=1024, rope_style="neox",
                    qkv_bias=False, qk_norm=True,
                    layer_types=("conv", "attn", "conv", "attn"),
                    conv_l_cache=3)
    write_synthetic_llm(paths["llm"], cfg=cfg, quant_type=GGML_Q8_0, seed=5)
    write_voice_embedding(paths["voice"], np.random.default_rng(11)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return paths


@pytest.fixture(scope="module")
def engine(files):
    _need_gpu()
    eng = te.TTSEngine(te.EngineConfig(
        model_path=files["llm"], codec_path=files["codec"], device="cuda",
        **KW))
    return eng, te.VoiceModel(files["voice"])


def _state(b) -> list:
    return [*b.cache.values(), b.last_logits, b._active_dev, b._slot_seed,
            b._slot_drawn, b._slot_temp]


def _submit(b, voice, done):
    for text, max_tok, temp, seed in REQUESTS:
        b.submit(text, voice, lambda s, sr, last: True,
                 te.Options(max_tokens=max_tok, temperature=temp, seed=seed),
                 on_finish=done.append)


def _record_work(b, work):
    """Record the quantized linears' (FLOPs, bytes) of each eager chunk."""
    chunk = b._chunk

    def recorded(attn_len):
        with qmat.recording() as w:
            buf = chunk(attn_len)
        work.extend(w)
        return buf
    b._chunk = recorded


def _keep_tokens(b, held):
    """Record each chunk's attention length and returned tokens, with a
    copy of their values when returned."""
    chunk = b._chunk

    def kept(attn_len):
        buf = chunk(attn_len)
        held.append((attn_len, buf, buf.clone()))
        return buf
    b._chunk = kept


@pytest.mark.cuda
@pytest.mark.parametrize("quantized_kv", [False, True], ids=["bf16", "int8"])
def test_replay_is_the_eager_chunk_bit_for_bit(engine, quantized_kv):
    """A warmed-up batcher (graphs) and a cold one (eager) serve the same
    five requests step by step at pipeline depth 2: after every scheduler
    step the tokens, last_logits, draws, active bits and the whole cache
    (conv state included) are equal bit for bit, through admissions,
    finishes and two attention lengths or more; every step is a replay
    and nothing is captured after warmup(); the launch counters count
    the eager launches alone, so they differ by the replayed steps' K6 and
    K1; the replays' linears are the eager chunks' (FLOPs and bytes); and
    no replay changes tokens an earlier chunk returned."""
    eng, voice = engine
    kw = dict(n_slots=4, chunk_steps=10, quantized_kv=quantized_kv,
              ctx_len=CTX)
    g = tb.ContinuousBatcher(eng, **kw)
    g.warmup(prompt_len=16)
    assert sorted(g._graphs) == [0, 128, 256]
    assert g.stage["graph_captures"] == 3
    e = tb.ContinuousBatcher(eng, **kw)
    assert e._graphs is None
    held = {"g": [], "e": []}
    work = []
    _record_work(e, work)
    _keep_tokens(g, held["g"])
    _keep_tokens(e, held["e"])
    done = {"g": [], "e": []}
    _submit(g, voice, done["g"])
    _submit(e, voice, done["e"])
    launches = {"g": [0, 0], "e": [0, 0]}
    for _ in range(400):
        if not (g.pending or e.pending):
            break
        for tag, b in (("g", g), ("e", e)):
            k6, k1 = decode_attention_batched.kernel_launches, \
                qdot.kernel_launches
            b.step()
            launches[tag][0] += decode_attention_batched.kernel_launches - k6
            launches[tag][1] += qdot.kernel_launches - k1
        torch.cuda.synchronize()
        for a, b in zip(_state(g), _state(e)):
            assert torch.equal(a, b)
        assert len(held["g"]) == len(held["e"])
        if held["g"]:
            assert held["g"][-1][0] == held["e"][-1][0]
            assert torch.equal(held["g"][-1][1], held["e"][-1][1])
    assert g.pending == e.pending == 0 and len(done["g"]) == 5
    assert ([(r.req_id, r.codes, r.n_tokens) for r in done["g"]]
            == [(r.req_id, r.codes, r.n_tokens) for r in done["e"]])
    assert len({n for n, _, _ in held["g"]}) >= 2
    assert g.stage["graph_steps"] == g.stage["device_steps"] > 0
    assert g.stage["graph_captures"] == 3
    assert e.stage["graph_steps"] == e.stage["graph_captures"] == 0
    steps = g.stage["device_steps"]
    assert launches["g"][0] == 0
    assert launches["e"][0] == 2 * steps
    assert launches["e"][1] - launches["g"][1] == \
        (4 * eng.llm_cfg.n_layers + 1) * steps
    assert (g.stage["graph_qdot_flops"], g.stage["graph_qdot_bytes"]) == (
        sum(f for f, _ in work), sum(b for _, b in work))
    assert e.stage["graph_qdot_flops"] == e.stage["graph_qdot_bytes"] == 0
    assert g.stage["graph_qdot_flops"] > 0
    for _, buf, copy in held["g"]:
        assert torch.equal(buf, copy)


@pytest.mark.cuda
def test_a_reallocated_state_is_refused(engine):
    """Reallocating a state tensor after warmup() makes the next chunk
    raise before any replay, in place of a capture inside serving."""
    eng, voice = engine
    g = tb.ContinuousBatcher(eng, n_slots=4, chunk_steps=10, ctx_len=CTX)
    g.warmup(prompt_len=16)
    g.last_logits = g.last_logits.clone()
    _submit(g, voice, [])
    with pytest.raises(RuntimeError, match="reallocated"):
        g.step()
    assert g.stage["graph_steps"] == 0 and g.stage["graph_captures"] == 3


@pytest.mark.cuda
def test_the_profiler_sees_every_replayed_kernel(engine):
    """Under torch.profiler a scheduler step that replays a chunk shows
    one graph launch on the host and, on the device, every kernel the
    replay ran: K6 (`decode_attn_kernel`) twice a step, and the quantized
    linears' kernels 4 a layer plus the head a step and a prefill wave,
    of which K1's counter sees the prefills' alone."""
    from torch.profiler import ProfilerActivity, profile
    eng, voice = engine
    g = tb.ContinuousBatcher(eng, n_slots=4, chunk_steps=10, ctx_len=CTX)
    g.warmup(prompt_len=16)
    _submit(g, voice, [])
    g.step()
    torch.cuda.synchronize()
    steps0, k1 = g.stage["graph_steps"], qdot.kernel_launches
    waves0 = g.stage["prefills"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g.step()
        torch.cuda.synchronize()
    tracer.follow_profiler()         # stops the tracer the step started
    steps = g.stage["graph_steps"] - steps0
    waves = g.stage["prefills"] - waves0
    per_step = 4 * eng.llm_cfg.n_layers + 1
    counts = {}
    for e in prof.key_averages():
        counts[e.key] = counts.get(e.key, 0) + e.count
    hit = lambda s: sum(n for k, n in counts.items() if s in k)
    assert steps == 10
    assert hit("cudaGraphLaunch") == 1
    assert hit("decode_attn_kernel") == 2 * steps
    assert hit("qdot") == per_step * (steps + waves)
    assert qdot.kernel_launches - k1 == per_step * waves
