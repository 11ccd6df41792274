"""archs/lfm2_moe.py (LFM2-8B-A1B): the seeded file's expert tensors (3-D
Q8_0 stacks, an f32 router and bias) and KVs, as the program reads them;
the active parameters counted by hand; the weight-byte map on the loaded
blocks; the benchmark's reference logits against the port's plain
reference (miotts_tpu_torch/reference/lfm2_moe.py) on the same file; and
a tiny cell of it run through the harness on the CPU, files alone."""

import json
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench import gguf_writer as gw
from portbench import harness, weights
from portbench.reference.llm import forward_logits

from .conftest import TINY_LFM2, tiny_cell, write_cell

ROOT = Path(__file__).resolve().parents[2]
REAL = json.loads((ROOT / "portbench" / "configs" /
                   "lfm2-8b-a1b-q8_0.json").read_text())
# a tiny lfm2_moe: conv / attn / conv / conv, one dense layer, then 8
# experts of width 64, 2 a token
TINY_MOE = dict(
    TINY_LFM2, name="tiny-moe", model_type="lfm2_moe", num_hidden_layers=4,
    layer_types=["conv", "full_attention", "conv", "conv"],
    intermediate_size=96, moe_intermediate_size=64, num_dense_layers=1,
    num_experts=8, num_experts_per_tok=2, norm_topk_prob=True,
    routed_scaling_factor=1.0, use_expert_bias=True, expert_bias_sigma=0.05,
    expert_down_scale=1.0)
SEED = 2 ** 31 + 91
TOKENS = list(range(250, 262)) + list(range(300, 340))


def _specs(s) -> dict:
    return {n: (sh, t) for n, sh, t, _, _ in weights.llm_specs(s)}


def test_expert_tensors_are_3d_q8_0_stacks_with_an_f32_router_and_bias():
    s = weights.shape_of(REAL)
    specs = _specs(s)
    q8, f32 = gw.GGML_Q8_0, gw.GGML_F32
    for i in range(24):
        p = f"blk.{i}."
        if i < 2:
            assert specs[p + "ffn_gate.weight"] == ((7168, 2048), q8)
            assert p + "ffn_gate_inp.weight" not in specs
            continue
        assert p + "ffn_gate.weight" not in specs
        assert specs[p + "ffn_gate_inp.weight"] == ((32, 2048), f32)
        assert specs[p + "exp_probs_b.bias"] == ((32,), f32)
        assert specs[p + "ffn_gate_exps.weight"] == ((32, 1792, 2048), q8)
        assert specs[p + "ffn_up_exps.weight"] == ((32, 1792, 2048), q8)
        assert specs[p + "ffn_down_exps.weight"] == ((32, 2048, 1792), q8)
    assert specs["token_embd.weight"] == ((13059, 2048), q8)
    assert "output.weight" not in specs
    m = weights.make_llm(weights.shape_of(TINY_MOE), SEED, "cpu")
    bias = torch.cat([torch.from_numpy(
        m.tensors[f"blk.{i}.exp_probs_b.bias"].payload.view("float32").copy())
        for i in (1, 2, 3)])
    assert 0.03 < float(bias.std()) < 0.08


def test_kvs_are_read_back_by_the_program():
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.llm import LLMConfig
    s = weights.shape_of(REAL)
    kv = dict(weights.llm_kv(s))
    a = "lfm2moe."
    assert kv["general.architecture"] == "lfm2moe"
    assert (kv[a + "expert_count"], kv[a + "expert_used_count"],
            kv[a + "expert_feed_forward_length"],
            kv[a + "leading_dense_block_count"],
            kv[a + "expert_gating_func"], kv[a + "expert_weights_norm"],
            kv[a + "expert_weights_scale"],
            kv[a + "feed_forward_length"]) == (32, 4, 1792, 2, 2, True,
                                               1.0, 7168)
    assert kv[a + "attention.head_count"] == [
        32 if t == "full_attention" else 0 for t in REAL["layer_types"]]
    m = weights.make_llm(weights.shape_of(TINY_MOE), 3, "cpu")
    with weights.memory_file(m, "llm") as path, GGUFReader(path) as r:
        cfg = LLMConfig.from_gguf(r)
    assert (cfg.arch, cfg.n_experts, cfg.n_experts_used, cfg.expert_ff_dim,
            cfg.n_dense_layers, cfg.expert_norm, cfg.expert_scale,
            cfg.ff_dim) == ("lfm2moe", 8, 2, 64, 1, True, 1.0, 96)
    assert cfg.layer_types == ("conv", "attn", "conv", "conv")
    assert cfg.moe_layer_idx == (1, 2, 3)


def test_matmul_params_by_hand():
    """Attention 6 x (2048 x 3072 + 2048 x 2048), conv 18 x 4 x 2048^2,
    dense 2 x 3 x 2048 x 7168, expert layers 22 x (4 experts x 3 x 2048 x
    1792 + the router 32 x 2048), head 13059 x 2048."""
    s = weights.shape_of(REAL)
    want = (6 * (2048 * 3072 + 2048 * 2048) + 18 * 4 * 2048 ** 2
            + 2 * 3 * 2048 * 7168 + 22 * (4 * 3 * 2048 * 1792 + 32 * 2048)
            + 13059 * 2048)
    assert want == 1450055680
    assert s.impl.matmul_params(s) == want
    assert s.impl.extra_token_flops(s) == 2 * 3 * 2048 * 18


def test_weight_parts_map_the_loaded_linears():
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.llm import LLMConfig, load_llm_params
    s = weights.shape_of(TINY_MOE)
    m = weights.make_llm(s, 3, "cpu")
    with weights.memory_file(m, "llm") as path, GGUFReader(path) as r:
        params, _ = load_llm_params(r, LLMConfig.from_gguf(r),
                                    dtype=torch.float32, device="cpu")
    blocks = params["layers"]
    keys = {id(v): f"{i}.{k}" for i, blk in enumerate(blocks)
            for k, v in blk.items()}
    got = harness.Observer._weight_bytes(SimpleNamespace(llm_params=params),
                                         m, s)
    assert {keys[k]: v for k, v in got.items()} == {
        "0.in_proj": 13056, "0.out_proj": 4352, "0.w_gateup": 13056,
        "0.w_down": 6528, "1.wqkv": 8704, "1.wo": 4352,
        "2.in_proj": 13056, "2.out_proj": 4352, "3.in_proj": 13056,
        "3.out_proj": 4352}
    assert all("moe" in blocks[i] for i in (1, 2, 3))


def test_reference_logits_equal_the_ports_plain_reference():
    """The same seeded file through both references: f32 throughout, the
    same equations in another order of operations (1e-5 of the logit
    scale)."""
    from miotts_tpu_torch.reference import lfm2_moe as port_ref
    s = weights.shape_of(TINY_MOE)
    m = weights.make_llm(s, SEED, "cpu")
    seqs = [TOKENS, TOKENS[:9]]
    got = forward_logits(m.tensors, s, seqs, "cpu")
    with weights.memory_file(m, "llm") as path:
        kv, tensors = port_ref.read_gguf(path)
    want = port_ref.forward(port_ref.Model(kv, tensors), seqs)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_a_tiny_cell_runs_through_the_harness_as_files(tmp_path):
    write_cell(tmp_path, "tiny-moe.closed", TINY_MOE, tiny_cell(TINY_MOE))
    r = harness.run("tiny-moe.closed", SEED, 1.5, False, device="cpu",
                    root=tmp_path)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
