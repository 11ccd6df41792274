"""The benchmark's own tests (CPU; the ones marked `cuda` skip without a
card).  Run from the repository root:

    python -m pytest portbench/tests -q
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_DENSE = {
    "name": "tiny-dense", "source": "a test size", "model_type": "qwen2",
    "hidden_size": 256, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 64, "intermediate_size": 512,
    "vocab_size": 259 + 2048, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
    "max_position_embeddings": 2048, "tie_word_embeddings": False,
    "quant": {"default": "Q4_K", "attn_v": "Q6_K", "ffn_down": "Q6_K"},
    "n_speech_codes": 2048, "reduced": []}
TINY_LFM2 = {
    "name": "tiny-lfm2", "source": "a test size", "model_type": "lfm2",
    "hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
    "num_key_value_heads": 2, "intermediate_size": 192,
    "block_auto_adjust_ff_dim": True, "block_ffn_dim_multiplier": 1.0,
    "block_multiple_of": 32, "conv_L_cache": 3,
    "layer_types": ["conv", "full_attention", "conv"], "norm_eps": 1e-5,
    "rope_theta": 1e6, "max_position_embeddings": 2048,
    "tie_embedding": True, "vocab_size": 259 + 2048,
    "quant": {"default": "Q8_0"}, "n_speech_codes": 2048, "reduced": []}
# llama.cpp's per-layer Q4_K_M mix: attn_v and ffn_down in Q6_K on layers 2
# and 3 of 4 (use_more_bits), Q4_K on 0 and 1; the untied head in Q6_K
TINY_Q4_K_M = dict(TINY_DENSE, name="tiny-q4km", num_hidden_layers=4,
                   quant={"default": "Q4_K", "mix": "Q4_K_M"})
TINY_CODEC = {"prenet_layers": 1, "prenet_dim": 64, "prenet_heads": 4,
              "prenet_ff": 96, "prenet_window": 9, "decoder_layers": 1,
              "decoder_dim": 32, "decoder_heads": 2, "decoder_ff": 48,
              "decoder_window": 9, "adaln_dim": 16, "resnet_groups": 4,
              "up_channels": [16, 8]}


# logit_gap 0.1: sound CPU runs of both tiny cells read at most 0.0725 and
# their control at least 0.117 (ten seeds each from 2**31 + 1)
def tiny_cell(config: dict, **over) -> dict:
    cell = {"config": config["name"], "traffic": "closed", "chips": 1,
            "why": "a test size", "n_slots": 4, "chunk_steps": 4,
            "mix": {"chars_median": 6, "chars_sigma": 0.5, "chars_min": 3,
                    "chars_max": 10, "codes_per_char": 3.1,
                    "temperature": 0.8, "greedy_share": 0.3},
            "traffic_params": {"clients": 4, "lead_in_max_tokens": 8},
            "codec": TINY_CODEC, "trace_seconds": 1.0, "check_requests": 6,
            "limits": {"logit_gap": 0.1, "cdf_miss": 0.05,
                       "audio_err": 1e-4, "code_errors": 0}}
    cell.update(over)
    return cell


def write_cell(root: Path, name: str, config: dict, cell: dict) -> None:
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "workloads").mkdir(parents=True, exist_ok=True)
    (root / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))


@pytest.fixture
def tiny_root(tmp_path):
    """A folder holding the tiny dense and LFM2 cells, closed loop, and
    the dense one under Poisson arrivals."""
    write_cell(tmp_path, "tiny-dense.closed", TINY_DENSE,
               tiny_cell(TINY_DENSE))
    write_cell(tmp_path, "tiny-lfm2.closed", TINY_LFM2, tiny_cell(TINY_LFM2))
    write_cell(tmp_path, "tiny-dense.poisson", TINY_DENSE, tiny_cell(
        TINY_DENSE, traffic="poisson",
        traffic_params={"rate_per_s": 4.0, "lead_in_s": 0.5}))
    return tmp_path
