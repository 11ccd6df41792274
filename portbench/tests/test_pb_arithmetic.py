"""The yardstick's arithmetic against hand-worked numbers: percentiles
with failed and censored requests, spreads, FLOPs and bytes, and the
per-layer readers on made-up traces."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import flops, stats, weights
from portbench.harness import Chunk, LayerContext
from portbench.metrics import (attn_roofline, device_idle_share,
                               host_launches_per_step, llm_step_mfu,
                               qdot_all_roofline, slot_occupancy)
from portbench.trace import TraceView

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
H100 = flops.peak("NVIDIA H100 80GB HBM3")


# a qwen2 stack worked by hand below: hidden 2560, 32 layers, 32/8 heads
# of 80, ff 8192, an untied head over 13059 tokens
QWEN2 = weights.shape_of({
    "model_type": "qwen2", "hidden_size": 2560, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 80,
    "intermediate_size": 8192, "vocab_size": 13059, "rms_norm_eps": 1e-6,
    "rope_theta": 1e6, "max_position_embeddings": 2048,
    "tie_word_embeddings": False, "quant": {"default": "Q4_K"},
    "n_speech_codes": 12800})


def shape(name):
    return weights.shape_of(json.loads((CONFIGS / f"{name}.json").read_text()))


def test_percentile_counts_failed_and_censored_requests():
    assert stats.percentile([4, 1, 3, 2, math.inf], 50) == 3
    assert stats.percentile([4, 1, 3, 2, math.inf], 95) == math.inf
    assert stats.percentile(list(range(1, 201)), 95) == 190
    R = SimpleNamespace
    recs = [R(due=9.0, failed=False, first_audio=9.5),      # before
            R(due=10.0, failed=False, first_audio=12.0),    # 2.0
            R(due=11.0, failed=True, first_audio=None),     # inf
            R(due=12.0, failed=False, first_audio=None),    # 20 - 12
            R(due=15.0, failed=False, first_audio=21.0),    # 20 - 15
            R(due=20.0, failed=False, first_audio=20.5)]    # after
    assert stats.ttfa_values(recs, 10.0, 20.0) == [2.0, math.inf, 8.0, 5.0]


def test_matmul_parameters_of_both_configurations():
    # qwen2: 32 x (2560 x (2560 + 2 x 640) + 2560 x 2560 + 3 x 2560 x 8192)
    # + 13059 x 2560
    assert flops.matmul_params(QWEN2) == 2570984960
    # LFM2: 6 x 10485760 (attention) + 10 x 16777216 (conv) + 16 x 50331648
    # (ffn 8192) + 13059 x 2048
    s = shape("lfm2-1.2b-q8_0")
    assert s.sizes["ff"] == 8192 and s.attn_layers == [2, 5, 8, 10, 12, 14]
    assert flops.matmul_params(s) == 1062737920


def test_linear_and_attention_counts():
    assert flops.linear(64, 2560, 3840, 1000) == (1258291200,
                                                  1000 + 819200)
    assert flops.attention_step([100, 200], 32, 8, 80) == (3072000, 799232)
    t = flops.least_time(1258291200, 819200 + 3686400, H100)
    assert t == pytest.approx((819200 + 3686400) / 3.35e12)


def test_span_flops_sums_token_flops():
    s = shape("lfm2-1.2b-q8_0")
    assert flops.span_flops(s, 37, 5) == sum(
        flops.token_flops(s, p) for p in range(37, 42))
    assert flops.span_flops(s, 3, 0) == 0
    assert flops.token_flops(s, 0) == (2 * 1062737920
                                       + 4 * 32 * 64 * 1 * 6
                                       + 2 * 3 * 2048 * 10)


def _view(device, launches=()):
    v = TraceView(window_s=1.0)
    v.device = device
    v.launches = list(launches)
    v.runtime = list(launches)
    return v


def _ctx(**k):
    base = dict(shape=QWEN2, n_slots=4, chunk_steps=2,
                peak=H100, trace=None, stage={}, chunks=[], prefills=[],
                qdot_calls=[], audio_s=0.0)
    base.update(k)
    return LayerContext(**base)


def test_readers_on_a_made_up_trace():
    wb = 3686400
    least = flops.least_time(*flops.linear(64, 2560, 2560, wb), H100)
    kern = [("void qdot_tile_kernel<64>", 0, 2000, 1),
            ("void decode_attn_kernel<bf16>", 3000, 4000, 2),
            ("Memcpy HtoD", 500_000_000, 500_001_000, 3)]
    view = _view(kern, [(0, 1), (1, 2)])
    ctx = _ctx(trace=view, qdot_calls=[(64, 2560, 2560, wb)],
               stage={"device_steps": 2, "graph_qdot_flops": 0,
                      "graph_qdot_bytes": 0},
               chunks=[Chunk(fill0=[10, 30], active_steps=[2, 1],
                             kept_codes=3, spans=[(10, 2), (30, 1)])])
    assert qdot_all_roofline.read(ctx) == pytest.approx(100 * least / 2e-6)
    a = sum(flops.least_time(*flops.attention_step(k, 32, 8, 80), H100)
            for k in ([10, 30], [10])) * 32
    assert attn_roofline.read(ctx) == pytest.approx(100 * a / 1e-6)
    assert slot_occupancy.read(ctx) == pytest.approx(100 * 3 / 8)
    assert host_launches_per_step.read(ctx) == 1.0
    assert device_idle_share.read(ctx) == pytest.approx(
        100 * (1 - 4000e-9))
    f = (flops.span_flops(ctx.shape, 10, 2) + flops.span_flops(ctx.shape, 30, 1))
    assert llm_step_mfu.read(ctx) == pytest.approx(100 * f / 989e12)


def test_readers_find_nothing_and_say_so():
    ctx = _ctx(trace=_view([]))
    for mod in (qdot_all_roofline, attn_roofline, slot_occupancy,
                host_launches_per_step, device_idle_share, llm_step_mfu):
        assert mod.read(ctx) is None
    bad = _ctx(trace=_view([("void qdot_tile_kernel", 0, 10, 1)]),
               stage={"graph_qdot_flops": 0, "graph_qdot_bytes": 0},
               qdot_calls=[(1, 2560, 2560, None)])
    assert qdot_all_roofline.read(bad) is None


def test_trace_attributes_launches_to_ranges():
    v = _view([("k1", 100, 200, 7), ("k2", 900, 1000, 8)],
              [(50, 7), (800, 8)])
    v.ranges = [(0, 60, "portbench.codec"), (700, 850, "portbench.chunk")]
    assert v.device_ns_in("portbench.codec") == (100, 1)
    assert v.busy_ns() == 200
    assert v.idle_gaps() == [["portbench.chunk", pytest.approx(700e-9)]]
    assert v.top_ops(1) == [["k1", pytest.approx(100e-9)]]
