"""Architectures as files of archs/: the seeded files, the reference's
logits, the FLOP counts and the weight-byte maps of the two existing
architectures hold the values that the code before the split gave (its
hashes and counts are written here); llama.cpp's per-layer Q4_K_M mix
picks its layers; a new architecture runs through the harness as a file
alone; a model_type with no file is refused by name."""

import hashlib
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import flops, harness, weights
from portbench.reference.llm import forward_logits

from .conftest import TINY_DENSE, TINY_LFM2, tiny_cell, write_cell

ROOT = Path(__file__).resolve().parents[2]
REAL = json.loads((ROOT / "portbench" / "configs" /
                   "lfm2-1.2b-q8_0.json").read_text())
SEED = 2 ** 31 + 77
TOKENS = list(range(250, 262)) + list(range(300, 340))

# sha256 of the seeded file at SEED, of the resolved tensor list and KVs,
# and of the reference's logits over TOKENS and TOKENS[:9]
GOLDEN = {
    "dense": dict(
        file=("46e07fd7e6e54529b6d79a77a861d8e2"
              "04827bf71be7a0713f8b5a692bbb5804"),
        specs=("90f3c6acbce205ef75ed09ffe47f816c"
               "7ea4a4fadd2eea4feea8d7add06de4b4"),
        logits=("b5c43fc3ba2f536d110d23034651bf35"
                "d29ed8dd0d652124aa740e7b4d2dc718"),
        matmul_params=1770240, span_flops=18112000, token_flops0=3542528),
    "lfm2": dict(
        file=("a2b711afc6ae74ebf31b3f56f79a9cca"
              "720b94ee872c441ebbbe5e1b0a2306b6"),
        specs=("b3c6599959a9eae1954d429dd6b7e5b4"
               "4afaad0ebb936219045427f0f86481ca"),
        logits=("72dd35859bed365facaa85bf0d4aef12"
                "a8a2806d67b15c9e1e7110504c1d6d83"),
        matmul_params=266432, span_flops=2719360, token_flops0=533888),
    "real": dict(
        specs=("859f93d4c5ccc109cbfbe9454e2d9bb4"
               "f523200cde6ff49566627db53c867ada"),
        matmul_params=1062737920, span_flops=10637824000),
}
CONFIGS = {"dense": TINY_DENSE, "lfm2": TINY_LFM2, "real": REAL}

# Observer._weight_bytes on the program's loaded blocks: "<layer>.<key>"
WEIGHT_BYTES = {
    "dense": {"0.w_down": 107520, "0.w_gateup": 147456, "0.wo": 36864,
              "0.wqkv": 82176, "1.w_down": 107520, "1.w_gateup": 147456,
              "1.wo": 36864, "1.wqkv": 82176, "output": 332208},
    "lfm2": {"0.in_proj": 13056, "0.out_proj": 4352, "0.w_down": 8704,
             "0.w_gateup": 17408, "1.w_down": 8704, "1.w_gateup": 17408,
             "1.wo": 4352, "1.wqkv": 8704, "2.in_proj": 13056,
             "2.out_proj": 4352, "2.w_down": 8704, "2.w_gateup": 17408},
}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _spec_hash(s) -> str:
    doc = [[[n, list(sh), t, float(sig), float(off)]
            for n, sh, t, sig, off in weights.llm_specs(s)],
           [[k, v] for k, v in weights.llm_kv(s)]]
    return _sha(json.dumps(doc).encode())


@pytest.mark.parametrize("name", ["dense", "lfm2", "real"])
def test_files_tensor_lists_and_flops_are_the_parents(name):
    s = weights.shape_of(CONFIGS[name])
    want = GOLDEN[name]
    assert _spec_hash(s) == want["specs"]
    assert flops.matmul_params(s) == want["matmul_params"]
    assert flops.span_flops(s, 37, 5) == want["span_flops"]
    if name == "real":
        return
    assert flops.token_flops(s, 0) == want["token_flops0"]
    m = weights.make_llm(s, SEED, "cpu")
    buf = io.BytesIO()
    m.write(buf)
    assert _sha(buf.getvalue()) == want["file"]
    logits = forward_logits(m.tensors, s, [TOKENS, TOKENS[:9]], "cpu")
    assert _sha(b"".join(t.contiguous().numpy().tobytes()
                         for t in logits)) == want["logits"]


@pytest.mark.parametrize("name", ["dense", "lfm2"])
def test_weight_bytes_of_the_loaded_blocks_are_the_parents(name):
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.llm import LLMConfig, load_llm_params
    s = weights.shape_of(CONFIGS[name])
    m = weights.make_llm(s, 3, "cpu")
    with weights.memory_file(m, "llm") as path, GGUFReader(path) as r:
        params, _ = load_llm_params(r, LLMConfig.from_gguf(r),
                                    dtype=torch.float32, device="cpu")
    blocks = params.get("blocks") or params["layers"]
    keys = {id(v): f"{i}.{k}" for i, blk in enumerate(blocks)
            for k, v in blk.items()}
    if "output" in params:
        keys[id(params["output"])] = "output"
    got = harness.Observer._weight_bytes(SimpleNamespace(llm_params=params),
                                         m, s)
    assert {keys[k]: v for k, v in got.items()} == WEIGHT_BYTES[name]


def _formats(s, role: str) -> list:
    return [t for n, _, t, _, _ in weights.llm_specs(s)
            if n.endswith(f".{role}.weight") or n == f"{role}.weight"]


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_q4_k_m_mix_gives_q6_k_where_use_more_bits(tie):
    """16 layers: attn_v and ffn_down in Q6_K on 0, 1, 4, 7, 10, 13, 14,
    15 (i < 2, i >= 14, (i - 2) % 3 == 2), Q4_K elsewhere; the head in
    Q6_K (token_embd where it is tied), every other matrix Q4_K."""
    cfg = dict(TINY_DENSE, num_hidden_layers=16, tie_word_embeddings=tie,
               quant={"default": "Q4_K", "mix": "Q4_K_M"})
    s = weights.shape_of(cfg)
    more = {0, 1, 4, 7, 10, 13, 14, 15}
    want = [14 if i in more else 12 for i in range(16)]
    assert _formats(s, "attn_v") == want == _formats(s, "ffn_down")
    for role in ("attn_q", "attn_k", "attn_output", "ffn_gate", "ffn_up"):
        assert _formats(s, role) == [12] * 16
    assert _formats(s, "token_embd") == [14 if tie else 12]
    assert _formats(s, "output") == ([] if tie else [14])
    assert weights.use_more_bits(2, 16) is False


def test_a_mix_counts_attn_v_over_the_attention_layers_alone():
    """The hybrid's attn_v: i of the 3 attention layers (use_more_bits(i,
    3): layer 2 of 3 only), ffn_down over all 6 layers."""
    cfg = dict(TINY_LFM2, hidden_size=256, num_hidden_layers=6,
               layer_types=["conv", "full_attention"] * 3,
               quant={"default": "Q4_K", "mix": "Q4_K_M"})
    s = weights.shape_of(cfg)
    assert _formats(s, "attn_v") == [12, 12, 14]
    assert _formats(s, "ffn_down") == [14 if weights.use_more_bits(i, 6)
                                       else 12 for i in range(6)]
    assert _formats(s, "token_embd") == [14]


def test_a_format_and_a_mix_for_one_role_are_refused():
    cfg = dict(TINY_DENSE, quant={"default": "Q4_K", "mix": "Q4_K_M",
                                  "attn_v": "Q8_0"})
    with pytest.raises(ValueError, match="attn_v"):
        weights.llm_specs(weights.shape_of(cfg))


def test_a_model_type_without_a_file_names_the_file(tmp_path):
    cfg = dict(TINY_DENSE, model_type="no_such_arch")
    with pytest.raises(FileNotFoundError, match=r"archs/no_such_arch\.py"):
        weights.shape_of(cfg, tmp_path)
    write_cell(tmp_path, "tiny-none.closed", dict(cfg, name="tiny-none"),
               tiny_cell(dict(cfg, name="tiny-none")))
    with pytest.raises(FileNotFoundError, match=r"no_such_arch\.py"):
        harness.run("tiny-none.closed", 1, 1.0, False, device="cpu",
                    root=tmp_path)


def test_a_new_architecture_is_a_file_alone(tmp_path):
    """archs/lfm2_copy.py (LFM2's file under another model_type, llama.cpp's
    `lfm2` in the file) and a config naming it: listed, and a CPU run of
    its cell is correct; no file of the benchmark changed."""
    copy = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", copy,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tmp_path / "miotts_tpu_torch").symlink_to(ROOT / "miotts_tpu_torch")
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    source = (copy / "archs" / "lfm2.py").read_text()
    assert 'GGUF_ARCH = "lfm2"' in source
    (copy / "archs" / "lfm2_copy.py").write_text(source)
    cfg = dict(TINY_LFM2, name="tiny-copy", model_type="lfm2_copy")
    write_cell(copy, "tiny-copy.closed", cfg, tiny_cell(cfg))
    assert all(p.read_bytes() == b for p, b in before.items())

    listed = subprocess.run(
        [sys.executable, str(copy / "run.py"), "--list"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300, check=True)
    found = json.loads(listed.stdout.strip().splitlines()[-1])
    assert {"lfm2", "lfm2_copy", "qwen2"} <= set(found["archs"])
    assert "tiny-copy.closed" in found["workloads"]

    code = ("import json, sys; sys.path.insert(0, '.');"
            "from portbench import harness, weights;"
            "s = weights.shape_of(harness.config('tiny-copy'));"
            "assert s.impl.__name__ == 'portbench.archs.lfm2_copy';"
            "r = harness.run('tiny-copy.closed', 11, 1.5, False,"
            " device='cpu');"
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
