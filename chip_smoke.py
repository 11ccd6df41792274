"""Chip smoke test of the PyTorch/CUDA port (miotts_tpu_torch) on one GPU.

    python3 chip_smoke.py                  # every phase, the summary lines
    python3 chip_smoke.py --phases 2,17    # some phases (dev runs), no summary

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. device: the card's name and power limit (nvidia-smi), kernel build;
  2. kernel vs plain: the `qdot` CUDA kernel against `qdot_plain` on the
     card at the main path's shapes (0.1B-Q8_0 at M = 1 and 64), at the
     2.6B-Q4_K_M formats (fused Q4_K + Q6_K, packed Q4_K wo / gate-up /
     output, Q6_K, packed Q4_0 at M = 1, 7, 16 and 64) and at the LFM2
     shapes (M = 1, 16), with kernel / eager / plain / library times and
     the plan's splits (M = 1: the split-K GEMV's cluster; M > 1: the
     tile's); a second call must give the same bits (both split K
     deterministically);
  3. main path: synthetic full-width 0.1B-Q8_0 LLM + full-size MioCodec
     written with the port's own writer, then
     TTSEngine.synthesize_to_file on the card at temperature 0, 128 tokens;
     checks the WAV and that every quantized linear went through the kernel
     (49 launches per decode step and 49 for the prefill), and holds the
     GPU's prefill logits and codec output against the CPU reference path;
  4. --skip-llm: a fixed `<|s_N|>` string through the same engine;
  5. profile: torch.profiler over a prefill + one 64-step decode chunk
     (device time by kernel, device-busy share, launches per step);
     phase 7 profiles a 64-request serving run the same way;
  6. attention kernel vs plain: the batched decode-attention CUDA kernel
     (`decode_attention_batched`) against its plain version at the serving
     shapes (0.1B: B=64, H=12/4, D=64, S=128/256/512; 2.6B: B=64, H=32/8,
     D=80, S=256/512/1024, and B=128, S=256; LFM2: B=16, H=32/8, D=64,
     S=128/256 and the long rows 1024/2048), bf16 and int8 caches with
     staggered fills and idle rows, with kernel / eager / plain / bound
     times, the plan's cluster split (ranks) and the time on one rank
     beside it, and, for bf16, the library time of
     scaled_dot_product_attention (timed only; the port never calls it); a
     second call must give the same bits, and one rank must agree with the
     plan's split (1e-5; int8's accumulator bit for bit);
  7. batched serving at full width: ContinuousBatcher(64 slots, 20-step
     chunks, serving defaults) over the phase-3 0.1B-Q8_0 files serves 80
     requests on a bf16 cache, then 16 on an int8 cache; checks every
     request's audio and that every batched step went through both
     kernels (12 attention and 49 qdot launches per step, 49 qdot per
     prefill); prints aggregate x_realtime, time to first audio and the
     scheduler's stage split;
  8. GPU vs CPU: one greedy 20-step batched chunk of the f32 model on
     4 slots, on the card and on the CPU plain path (tokens identical,
     logits within 1e-4 of their scale);
  9. HTTP: the port's server on 127.0.0.1 (8 slots) answers /health and
     four concurrent /synthesize requests (2 wav, 2 pcm), then drains;
 10. (a) K5 vs plain: the single-query decode-attention CUDA kernel
     (`decode_attention`) against its plain version at the LFM2-1.2B
     decode shapes (B=1, H=32/8, D=64, S=256/512/1024/2048; B=4 with
     staggered fills and an idle row), the 0.1B heads (12/4) and D=80,
     bf16 / f32 / int8 caches, within 1e-5, with kernel / eager / plain /
     bound times, the plan's cluster split (ranks) and the time on one rank
     beside it, and the library time of scaled_dot_product_attention (timed
     only); a second call must give the same bits, and one rank must agree
     with the plan's split within 1e-5;
 11. (b) LFM2-1.2B-Q8_0 offline: the synthetic full-width hybrid model
     (written by the port's writer, timed) + the phase-3 codec through
     TTSEngine.synthesize_to_file at temperature 0, 128 tokens; checks the
     WAV, K5 = 6 launches per decode step and none in the prefill, qdot =
     65 per decode step and per prefill, one text giving the same tokens
     before and after another request (the conv-state reset), and profiles
     a prefill + 64 steps;
 12. (d) LFM2 serving: ContinuousBatcher(16 slots, 20-step chunks) on the
     same engine serves 24 requests of 96 tokens (bf16 cache): K6 = 6 x
     device steps, qdot = 65 x (device steps + prefill waves), K5 none;
     then profiles 16 requests x 40 tokens; then the same engine's weights
     under MIOTTS_QDOT_BF16=after serve 16 requests of 96 tokens (K1v = 65
     x (device steps + prefill waves), K6 = 6 x device steps, K1 and K5
     none) and are profiled the same way;
 13. (c) LFM2 GPU vs CPU: layers 0-5 (two attention layers) of the same
     file at full width, f32, a prefill + 20 greedy steps on the card (K1,
     K5) and on the CPU plain path: identical tokens, logits within 1e-4.
 14. the single-stream routes vs plain: K2 (`qdot_split`, packed shapes at
     M = 1, 7, 64; bit for bit equal to K1, whose GEMV (M = 1) and tile
     (M > 1) it runs), K3 (`qdot_group`, bf16; bit for bit equal to K1,
     whose GEMV it runs at bf16 x) and K4a / K4b (`qdot_w8a8`, f32 and
     bf16; the same split-K GEMV in its integer-partial form) at M = 1 on
     the 2.6B-Q4_K_M linears (fused QKV, wo, gate/up, w_down, output) and,
     for K3 / K4a, the 0.1B and LFM2 Q8_0 shapes; every x has an all-zero
     quant group; f32 within 1e-5, bf16 1e-2; K2, K3 and K4 give the same
     bits on a second call; kernel / eager / plain / library / bound times
     and each row's plan splits;
 15. 2.6B-Q4_K_M offline at full width and depth (written by the port's
     writer, timed): one engine per route (default K1, w8a8, groupdot,
     split, bf16dot, bf16after; the routes share the loaded weights) runs
     synthesize_to_file at temperature 0, bf16 (the default route 128
     tokens, the others 32: the harness's time limit); checks each
     WAV and the launches (w8a8: K4a 64 and K4b 65 per decode step, K1 129
     per prefill; groupdot: K3 129 per step, K1 129 per prefill; split: K2
     65 and K1 64 per step and per prefill; bf16dot / bf16after: K1v 129
     per step and per prefill; default: K1 129); prints the rates, a
     profile of the default and bf16after routes and each route's token
     agreement with the default route;
 16. 2.6B-Q4_K_M GPU vs CPU: layers 0-1, a prefill + 8 greedy steps per
     route on the card, then on the CPU plain path fed the card's tokens:
     split and w8a8 (f32) greedy tokens identical, split's logits within
     1e-4 at every step, w8a8's within 5e-2 RMS (the int8 quantization's
     rounding ties part the two); groupdot and bf16after (bf16) prefill and
     first step within 2e-2;
 17. K1v vs plain: the bf16-dot variants (`qdot_bf16`, MIOTTS_QDOT_BF16=1
     and after) against `qdot_bf16_plain` at phase 2's shapes (0.1B-Q8_0 at
     M = 1, 64; the 2.6B-Q4_K_M formats at M = 1, 7, 16, 64; LFM2 at M =
     1, 16), f32 x within 1e-5 and bf16 x within 1e-2, two calls bit for
     bit equal, with kernel / eager / plain / library / bound times and the
     plan's splits beside K1's;
 18. the probes: K8 (`qdot_dma_floor`, K1's blocks) at bench_qmat.py's
     2.6B shapes (its own int8 g32 tensor, K1 timed on the same copies) and
     at the 0.1B / LFM2 Q8_0 shapes, and K7 (`dma_floor`, K5's blocks) at
     phase 10's and phase 6's shapes (bf16 cache): each called once per
     shape with the counts at 0 (the probe path), then against its plain
     version (K7 bit for bit, K8 within 1e-6) and timed over copies larger
     than the L2; prints each probe's GB/s beside the kernel it floors and
     fails if a probe streams faster than 1.05 x 3.35 TB/s (skipped
     bytes).

Kernel times are device times: the calls are captured in a CUDA graph and
replayed between CUDA events, cycling over weight (or KV-cache) copies
larger than the 50 MB L2 (a decode step streams them cold); the eager
per-call time, Python wrapper included, is printed beside them.

The second-to-last line is the nvidia-smi name / power-limit line; before
it, one JSON object {"kernels": [...]} (each kernel's launches, errors and
times per decode step of its path); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Earlier, a line `details {...}` holds the per-shape rows and every phase's
numbers.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import threading
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = 989e12            # H100 SXM dense bf16 tensor core (data sheet)
PEAK_INT8_OPS = 1979e12        # H100 SXM dense int8 tensor core (data sheet)
PEAK_F32_FLOPS = 67e12         # H100 SXM f32 outside the tensor cores
L2_FLUSH_BYTES = 160 << 20     # weight copies cycled per timing loop (> 50 MB L2)
KERNEL_TOL_BF16 = 1e-2         # bf16 output: one 2^-8 rounding on either side
KERNEL_TOL_F32 = 1e-5          # f32 output: summation order only
REF_TOL = 1e-4                 # GPU vs CPU reference, f32 LLM prefill / codec
ATTN_TOL = 1e-2                # attention kernel vs plain: bf16 rounding of p;
                               # int8: of the row scale (one quantized step)
PROBE_TOL = 1e-6               # K8 vs plain: f32 sums of the tiles in another order
PROBE_MAX_RATE = 1.05 * HBM_BYTES_PER_S   # a probe above it skipped bytes

# 0.1B-Q8_0 (the main path's model, bench.py's "0.1b-q8_0" at full width)
DIM, LAYERS, HEADS, KV_HEADS, HEAD_DIM, FF = 768, 12, 12, 4, 64, 2048
N_SPEECH = 12800
MAX_TOKENS = 128
QDOT_PER_STEP = LAYERS * 4 + 1   # fused QKV, wo, fused gate/up, down; output
# batched serving (bench_batch.py's flagship mix at the 0.1B model)
SLOTS, CHUNK, SERVE_TOKENS, N_REQ, N_REQ_INT8 = 64, 20, 96, 80, 16
# attention kernel shapes (B, H, H_kv, D, S)
ATTN_SHAPES = [("0.1b", 64, 12, 4, 64, 128), ("0.1b", 64, 12, 4, 64, 256),
               ("0.1b", 64, 12, 4, 64, 512), ("2.6b", 64, 32, 8, 80, 256),
               ("2.6b", 64, 32, 8, 80, 512), ("2.6b", 128, 32, 8, 80, 256),
               ("lfm2-1.2b", 16, 32, 8, 64, 128),   # LFM2 serving: 16 slots,
               ("lfm2-1.2b", 16, 32, 8, 64, 256),   # the attn_len buckets,
               ("lfm2-1.2b", 16, 32, 8, 64, 1024),  # and long rows
               ("lfm2-1.2b", 16, 32, 8, 64, 2048),
               ("2.6b", 64, 32, 8, 80, 1024)]
ATTN_STEP_SHAPE = ("0.1b", 64, 12, 4, 64, 256)   # the serving phase's shape
ATTN_SPLIT_TOL = 1e-5          # K6 on one rank vs its plan's split: f32 sums
                               # in another order (int8: of the row scale)

# LFM2-1.2B-Q8_0: the widths of the published LFM2-1.2B
# (huggingface.co/LiquidAI/LFM2-1.2B, config.json): hidden 2048, 16 layers
# with attention at full_attn_idxs and gated short convs (conv_L_cache 3,
# no bias) elsewhere, 32 query / 8 KV heads of 64, block_ff_dim 12288 ->
# 8192 (block_auto_adjust_ff_dim: int(2 * 12288 / 3), multiple of 256),
# rope_theta 1e6, norm_eps 1e-5.  Not published: the synthetic TTS vocab
# (256 + 3 + 12800, as every bench config), random weights from a seed and
# an untied Q8_0 output head.
LFM2_ATTN_IDX = (2, 5, 8, 10, 12, 14)
LFM2_LAYERS = 16
LFM2_QDOT_PER_STEP = LFM2_LAYERS * 4 + 1   # in/out_proj or QKV/wo, gate/up, down
LFM2_SLOTS, LFM2_REQ = 16, 24
LFM2_AFTER_REQ = 16                        # serving under MIOTTS_QDOT_BF16=after
LFM2_REF_LAYERS = 6                        # GPU vs CPU: layers 0-5, 2 attention
# K5 shapes (label, B, H, H_kv, D, S)
K5_SHAPES = [("lfm2-1.2b", 1, 32, 8, 64, 256), ("lfm2-1.2b", 1, 32, 8, 64, 512),
             ("lfm2-1.2b", 1, 32, 8, 64, 1024), ("lfm2-1.2b", 1, 32, 8, 64, 2048),
             ("lfm2-1.2b", 4, 32, 8, 64, 512),
             ("0.1b", 1, 12, 4, 64, 256), ("d80", 2, 32, 8, 80, 512)]
K5_STEP_SHAPE = ("lfm2-1.2b", 1, 32, 8, 64, 256)   # the offline decode's
# the offline decode's default cache (engine.py: max_tokens 700 -> S = 1024)
# and the port's n_ctx (2048)
K5_LONG_SHAPES = (("lfm2-1.2b", 1, 32, 8, 64, 1024),
                  ("lfm2-1.2b", 1, 32, 8, 64, 2048))
K5_TOL = 1e-5                  # kernel vs plain: both f32, summation order
K5_SPLIT_TOL = 1e-5            # one rank vs the plan's split: f32 sums only

# 2.6B-Q4_K_M: bench.py's "2.6b-q4_k" widths (qwen2, dim 2560, 32 layers,
# 32/8 heads of 80, ff 8192, QKV bias, rope theta 1e6), written with
# llama.cpp's Q4_K_M mix (attn_v and ffn_down in Q6_K, the rest Q4_K): the
# fused QKV and w_down are int8 values (g16), wo, gate/up and the output head
# packed Q4_K nibbles (g32, mins).
Q4KM_LAYERS = 32
Q4KM_QDOT_PER_STEP = Q4KM_LAYERS * 4 + 1     # 129
Q4KM_REF_LAYERS = 2                          # GPU vs CPU: layers 0-1
# the JAX package's switches of each route (ops/qmat.QdotRoute.from_env)
Q4KM_ROUTES = {"default": {}, "w8a8": {"MIOTTS_QDOT_GEMV": "w8a8"},
               "groupdot": {"MIOTTS_QDOT_GEMV": "groupdot"},
               "split": {"MIOTTS_PACK4_SPLIT": "1"},
               "bf16dot": {"MIOTTS_QDOT_BF16": "1"},
               "bf16after": {"MIOTTS_QDOT_BF16": "after"}}
# phase 15's depth: the routes other than the default synthesize
# Q4KM_AGREE_TOKENS (the greedy tokens compared with the default route), and
# only Q4KM_PROFILED are profiled (the profiler's processing grows with
# every launch it records)
Q4KM_AGREE_TOKENS = 32
Q4KM_PROFILED = ("default", "bf16after")
# the shared headers of the quantized matmul (the split-K GEMV at M = 1, the
# tile at M > 1) and of the attention kernels, beside each kernel's own
# source in the kernels line
GEMV_HEADER = "miotts_tpu_torch/ops/csrc/qdot_gemv.cuh"
TILE_HEADER = "miotts_tpu_torch/ops/csrc/qdot_tile.cuh"
ATTN_HEADER = "miotts_tpu_torch/ops/csrc/attn_common.cuh"
# bench_qmat.py's SHAPES: the 2.6B per-layer (K, N) of K8's own configuration
K8_SHAPES = [(2560, 3840), (2560, 2560), (2560, 16384), (8192, 2560)]
# GPU vs CPU under w8a8: each K4 call agrees with its plain version on the
# same input to ~3e-7, but a 1e-5 difference upstream flips some int8
# roundings (each moves a whole weight row's term by 1/254 of its group's
# amax), and the MLP multiplies the flips: on the H100, 2 flips at layer 1's
# wo became 13, 443 and 356 at gate/up, w_down and the head, 6.3e-3 of the
# logits in one step and 1.6e-2 (RMS) over 8.  So the bound is the JAX
# package's own tolerance of W8A8 against the dense product (rtol 0.05,
# tests/test_qmat.py:441), on the RMS relative difference.
W8A8_REF_TOL = 5e-2
BF16_REF_TOL = 2e-2            # GPU vs CPU in bf16 (groupdot)


def lfm2_config():
    from miotts_tpu_torch.models.llm import LLMConfig
    return LLMConfig(
        arch="lfm2", n_layers=LFM2_LAYERS, dim=2048, n_heads=32, n_kv_heads=8,
        head_dim=64, ff_dim=8192, n_vocab=256 + 3 + N_SPEECH, n_ctx=128000,
        rope_theta=1e6, rms_eps=1e-5, rope_style="neox", qkv_bias=False,
        qk_norm=True, conv_l_cache=3,
        layer_types=tuple("attn" if i in LFM2_ATTN_IDX else "conv"
                          for i in range(LFM2_LAYERS)))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def rand_qtensor(torch, qmat, k, n, fmt, gen):
    """A QTensor at the planar layout of GGUF format `fmt`, random on the
    card: q8_0 (int8, g32), q6_k (-32..31, g16), q4_k (0..15 + mins, g32,
    packed), q4_0 (-8..7, g32, packed -> centring folded into mins)."""
    dev = "cuda"
    group = 16 if fmt == "q6_k" else 32
    lo, hi = {"q8_0": (-127, 128), "q6_k": (-32, 32), "q4_k": (0, 16),
              "q4_0": (-8, 8)}[fmt]
    vals = torch.randint(lo, hi, (k, n), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int8)
    scales = (torch.rand((k // group, n), generator=gen, device=dev) + 0.5) \
        * (1.0 / (hi * math.sqrt(k)))
    mins = None
    if fmt == "q4_k":
        mins = torch.rand((k // group, n), generator=gen, device=dev) \
            * (8.0 / (hi * math.sqrt(k)))
    qt = qmat.QTensor(values=vals, scales=scales, mins=mins, group=group,
                      n_out=n)
    return qt.pack4() if fmt in ("q4_k", "q4_0") else qt


def shape_cases(torch, qmat, gen):
    """(label, QTensor, Ms): the main path's 0.1B-Q8_0 shapes, then the
    other formats at 2.6B-Q4_K_M shapes (bench.py '2.6b-q4_k': dim 2560,
    ff 8192, 32 heads, 8 KV heads of 80 -> fused QKV N = 2560 + 2 * 640)."""
    q = lambda k, n, f: rand_qtensor(torch, qmat, k, n, f, gen)
    kvd = KV_HEADS * HEAD_DIM
    cases = [
        ("0.1b wqkv q8_0", q(DIM, HEADS * HEAD_DIM + 2 * kvd, "q8_0"), (1, 64)),
        ("0.1b wo q8_0", q(HEADS * HEAD_DIM, DIM, "q8_0"), (1, 64)),
        ("0.1b w_gateup q8_0", q(DIM, 2 * FF, "q8_0"), (1, 64)),
        ("0.1b w_down q8_0", q(FF, DIM, "q8_0"), (1, 64)),
        ("0.1b output q8_0", q(DIM, 256 + 3 + N_SPEECH, "q8_0"), (1, 64)),
    ]
    # the Q4_K_M mix: attn_v in Q6_K beside Q4_K q/k -> unpacked g16 + mins
    wqkv = qmat.concat_qtensors([q(2560, 2560, "q4_k"), q(2560, 640, "q4_k"),
                                 q(2560, 640, "q6_k")])
    gateup = qmat.concat_qtensors([q(2560, 8192, "q4_k"), q(2560, 8192, "q4_k")])
    assert not wqkv.packed and wqkv.group == 16 and wqkv.mins is not None
    assert gateup.packed and gateup.group == 32 and gateup.mins is not None
    # M = 16: a 16-slot step or a speculative verify on the 2.6B widths
    ms = (1, 7, 16, 64)
    cases += [
        ("2.6b wqkv q4_k+q6_k", wqkv, ms),
        ("2.6b w_gateup q4_k packed", gateup, ms),
        ("2.6b w_down q6_k", q(8192, 2560, "q6_k"), ms),
        ("2.6b q4_0 packed", q(2560, 2560, "q4_0"), ms),
        ("2.6b wo q4_k packed", q(2560, 2560, "q4_k"), ms),
        ("2.6b output q4_k packed", q(2560, 256 + 3 + N_SPEECH, "q4_k"), ms),
    ]
    # LFM2-1.2B-Q8_0: M = 1 offline, M = 16 the serving phase's slots
    ms = (1, LFM2_SLOTS)
    cases += [
        ("lfm2 in_proj q8_0", q(2048, 6144, "q8_0"), ms),
        ("lfm2 out_proj/wo q8_0", q(2048, 2048, "q8_0"), ms),
        ("lfm2 wqkv q8_0", q(2048, 3072, "q8_0"), ms),
        ("lfm2 w_gateup q8_0", q(2048, 16384, "q8_0"), ms),
        ("lfm2 w_down q8_0", q(8192, 2048, "q8_0"), ms),
        ("lfm2 output q8_0", q(2048, 256 + 3 + N_SPEECH, "q8_0"), ms),
    ]
    return cases


def qt_bytes(qt) -> int:
    n = qt.values.numel() * qt.values.element_size()
    n += qt.scales.numel() * 4
    if qt.mins is not None:
        n += qt.mins.numel() * 4
    return n


def copies_of(torch, qmat, qt, count):
    out = [qt]
    for _ in range(count - 1):
        out.append(qmat.QTensor(
            values=qt.values.clone(), scales=qt.scales.clone(),
            mins=None if qt.mins is None else qt.mins.clone(),
            group=qt.group, n_out=qt.n_out, packed=qt.packed))
    return out


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn(i) over `iters` back-to-back calls (CUDA
    events around the loop, after a warm-up)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, n: int, reps: int = 5) -> float:
    """Device time per call: `n` calls captured in one CUDA graph and the
    graph replayed `reps` times between CUDA events, so no Python dispatch
    sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def plan_splits(qmat, m: int, K: int, N: int, group: int) -> int:
    """The splits of K in the plan the kernel runs: the split-K GEMV's
    cluster at M = 1, the tile's at M > 1."""
    import torch
    sms = qmat._sm_count(torch.device("cuda"))
    if m == 1:
        return qmat._gemv_plan(K, N, group, sms).splits
    return qmat._tile_plan(m, K, N, group, sms).splits


def phase_kernels(torch, qmat, card: str) -> list[dict]:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for label, qt, ms_list in shape_cases(torch, qmat, gen):
        K, N = qt.k, qt.shape[0]
        n_copies = max(2, min(256, -(-L2_FLUSH_BYTES // qt_bytes(qt))))
        qts = copies_of(torch, qmat, qt, n_copies)
        w_lib = [c.dequant_t(torch.float32).to(torch.bfloat16)
                 for c in qts[: max(2, min(256, -(-L2_FLUSH_BYTES
                                                 // (2 * K * N))))]]
        for m in ms_list:
            err = {}
            for dtype, tol in ((torch.float32, KERNEL_TOL_F32),
                               (torch.bfloat16, KERNEL_TOL_BF16)):
                x = torch.randn((m, K), generator=gen, device="cuda").to(dtype)
                got = qmat.qdot(x, qt)
                want = qmat.qdot_plain(x, qt)
                torch.cuda.synchronize()
                if got.shape != (m, N) or got.dtype != dtype:
                    raise AssertionError(f"{label} M={m}: bad output "
                                         f"{tuple(got.shape)} {got.dtype}")
                e = rel_err(got.float(), want.float())
                if not e < tol:
                    raise AssertionError(f"{label} M={m} {dtype}: kernel vs "
                                         f"plain rel err {e} >= {tol}")
                if not torch.equal(qmat.qdot(x, qt), got):
                    raise AssertionError(f"{label} M={m} {dtype}: two calls "
                                         f"differ (split-K not deterministic)")
                err[str(dtype)] = e
            abs_err = float((got.float() - want.float()).abs().max())
            # device time (graph replay over weight copies that exceed the
            # L2, as a decode step streams every layer's weights cold) and
            # the eager per-call time, Python wrapper included
            kern = lambda i: qmat.qdot(x, qts[i % n_copies])
            plain = lambda i: qmat.qdot_plain(x, qts[i % n_copies])
            lib = lambda i: torch.matmul(x, w_lib[i % len(w_lib)])
            n_graph = max(20, min(256, n_copies))
            k_ms = graph_ms(torch, kern, n_graph)
            p_ms = graph_ms(torch, plain, 10)
            l_ms = graph_ms(torch, lib, max(20, min(256, len(w_lib))))
            k_host = time_ms(torch, kern, 50)
            l_host = time_ms(torch, lib, 50)
            nbytes = qt_bytes(qt) + 2 * m * K + 2 * m * N
            flops = 2.0 * m * K * N
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS * 1e3
            row = dict(shape=label, M=m, K=K, N=N, bytes=nbytes, flops=flops,
                       group=qt.group, packed=qt.packed,
                       mins=qt.mins is not None, ms=k_ms, plain_ms=p_ms,
                       library_ms=l_ms, eager_ms=k_host,
                       library_eager_ms=l_host, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       max_abs_err=abs_err, rel_err_bf16=err[str(torch.bfloat16)],
                       rel_err_f32=err[str(torch.float32)],
                       splits=plan_splits(qmat, m, K, N, qt.group),
                       bit_identical=True)
            rows.append(row)
            log(f"qdot {label:28s} M={m:<3d} K={K:<5d} N={N:<6d} "
                f"kernel {k_ms:.4f} ms (eager {k_host:.4f})  plain {p_ms:.4f} "
                f"ms  library {l_ms:.4f} ms (eager {l_host:.4f})  bound "
                f"{row['bound_ms']:.4f} ms "
                f"({row['bound_by']})  rel_err bf16 {row['rel_err_bf16']:.2e}"
                f" f32 {row['rel_err_f32']:.2e}  [{card}]")
        del qts, w_lib
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 14: the single-stream routes (K2, K3, K4a, K4b) vs plain
# ---------------------------------------------------------------------------

# the Q8_0 (g32, no mins) linears of the 0.1B and LFM2-1.2B models: (label,
# K, N)
Q8_LINEARS = (
    ("0.1b wqkv", DIM, HEADS * HEAD_DIM + 2 * KV_HEADS * HEAD_DIM),
    ("0.1b wo", HEADS * HEAD_DIM, DIM), ("0.1b w_gateup", DIM, 2 * FF),
    ("0.1b w_down", FF, DIM), ("0.1b output", DIM, 256 + 3 + N_SPEECH),
    ("lfm2 in_proj", 2048, 6144), ("lfm2 out_proj/wo", 2048, 2048),
    ("lfm2 wqkv", 2048, 3072), ("lfm2 w_gateup", 2048, 16384),
    ("lfm2 w_down", 8192, 2048), ("lfm2 output", 2048, 256 + 3 + N_SPEECH))


def q4km_cases(torch, qmat, gen):
    """(label, QTensor) at the 2.6B-Q4_K_M widths, then the Q8_0 (g32, no
    mins) shapes of the 0.1B and LFM2-1.2B models."""
    q = lambda k, n, f: rand_qtensor(torch, qmat, k, n, f, gen)
    cases = [
        ("2.6b wqkv q4_k+q6_k", qmat.concat_qtensors([
            q(2560, 2560, "q4_k"), q(2560, 640, "q4_k"), q(2560, 640, "q6_k")])),
        ("2.6b wo q4_k", q(2560, 2560, "q4_k")),
        ("2.6b w_gateup q4_k", qmat.concat_qtensors([
            q(2560, 8192, "q4_k"), q(2560, 8192, "q4_k")])),
        ("2.6b w_down q6_k", q(8192, 2560, "q6_k")),
        ("2.6b output q4_k", q(2560, 256 + 3 + N_SPEECH, "q4_k")),
    ]
    for label, k, n in Q8_LINEARS:
        cases.append((label + " q8_0", q(k, n, "q8_0")))
    return cases


def variant_work(kernel: str, qt, m: int, el: int):
    """(bytes, ops, peak ops/s) one call must move / do: the weight's values,
    scales and mins, x and y once each; 2MKN operations at the rate of their
    type (K4: int8; K2 / K3 at M = 1: f32 on the CUDA cores; K2 at M > 1:
    K1's tile on the bf16 tensor cores, three passes for an f32 x)."""
    K, N = qt.k, qt.shape[0]
    nbytes = qt_bytes(qt) + m * K * el + m * N * el
    ops = 2.0 * m * K * N
    if kernel.startswith("K4"):
        return nbytes, ops, PEAK_INT8_OPS
    if m > 1:
        return nbytes, ops * (3 if el == 4 else 1), PEAK_FLOPS
    return nbytes, ops, PEAK_F32_FLOPS


def phase_variants(torch, qmat, card: str) -> list[dict]:
    """Every single-stream kernel against its plain version on the card, with
    kernel / plain / library times: K2 on the packed shapes at M = 1, 7, 64
    (bit for bit equal to K1: the same GEMV at M = 1, the same tile at
    M > 1), K3 at M = 1 in bf16 (bit for bit equal to K1: the same GEMV),
    K4a / K4b at M = 1 in f32 and bf16 (the GEMV's integer-partial form).
    K2, K3 and K4 give the same bits on a second call.  Every x has an
    all-zero quant group (K4's sx = 1 rule)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows = []
    for label, qt in q4km_cases(torch, qmat, gen):
        K, N = qt.k, qt.shape[0]
        n_copies = max(2, min(256, -(-L2_FLUSH_BYTES // qt_bytes(qt))))
        qts = copies_of(torch, qmat, qt, n_copies)
        w_lib = [c.dequant_t(torch.float32).to(torch.bfloat16)
                 for c in qts[: max(2, min(256, -(-L2_FLUSH_BYTES
                                                 // (2 * K * N))))]]
        runs = [("K3", qmat.qdot_group, qmat.qdot_group_plain, 1,
                 torch.bfloat16)]
        k4 = "K4b" if qt.packed else "K4a"
        runs += [(k4, qmat.qdot_w8a8, qmat.qdot_w8a8_plain, 1, dt)
                 for dt in (torch.float32, torch.bfloat16)]
        if qt.packed:
            runs += [("K2", qmat.qdot_split, qmat.qdot_split_plain, m, dt)
                     for m in (1, 7, 64)
                     for dt in (torch.float32, torch.bfloat16)]
        for kernel, fn, plain_fn, m, dtype in runs:
            x = torch.randn((m, K), generator=gen, device="cuda")
            x[:, 32:64] = 0.0
            x = x.to(dtype)
            got = fn(x, qt)
            want = plain_fn(x, qt)
            torch.cuda.synchronize()
            if got.shape != (m, N) or got.dtype != dtype:
                raise AssertionError(f"{kernel} {label} M={m}: bad output "
                                     f"{tuple(got.shape)} {got.dtype}")
            tol = KERNEL_TOL_F32 if dtype == torch.float32 else KERNEL_TOL_BF16
            e = rel_err(got.float(), want.float())
            if not e < tol:
                raise AssertionError(f"{kernel} {label} M={m} {dtype}: kernel "
                                     f"vs plain rel err {e} >= {tol}")
            e_k1 = None
            if not torch.equal(fn(x, qt), got):
                raise AssertionError(f"{kernel} {label} M={m} {dtype}: "
                                     f"two calls differ")
            if kernel in ("K2", "K3"):
                # K1 on the same plan runs the same GEMV (M = 1) or tile
                if not torch.equal(got, qmat._qdot_cuda(x, qt)):
                    raise AssertionError(f"{kernel} {label} M={m} {dtype}: "
                                         f"not bit for bit K1")
                e_k1 = 0.0
            xl = x.to(torch.bfloat16)
            kern = lambda i: fn(x, qts[i % n_copies])
            k_ms = graph_ms(torch, kern, max(20, min(256, n_copies)))
            p_ms = graph_ms(torch, lambda i: plain_fn(x, qts[i % n_copies]), 10)
            l_ms = graph_ms(torch, lambda i: torch.matmul(
                xl, w_lib[i % len(w_lib)]), max(20, min(256, len(w_lib))))
            e_ms = time_ms(torch, kern, 50)
            nbytes, ops, peak = variant_work(kernel, qt, m, x.element_size())
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / peak * 1e3
            dt = "f32" if dtype == torch.float32 else "bf16"
            splits = plan_splits(qmat, m, K, N, qt.group)
            row = dict(kernel=kernel, shape=label, M=m, K=K, N=N, dtype=dt,
                       group=qt.group, packed=qt.packed,
                       mins=qt.mins is not None, bytes=nbytes, ops=ops,
                       ms=k_ms, plain_ms=p_ms, library_ms=l_ms, eager_ms=e_ms,
                       bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes,
                       ops_ms=t_ops,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       max_abs_err=float((got.float() - want.float()).abs()
                                         .max()),
                       rel_err=e, rel_err_vs_k1=e_k1, splits=splits,
                       bit_identical=True)
            rows.append(row)
            log(f"{kernel:3s} {label:22s} M={m:<3d} {dt:4s} K={K:<5d} "
                f"N={N:<6d} splits {splits}  kernel {k_ms:.4f} ms (eager "
                f"{e_ms:.4f})  plain "
                f"{p_ms:.4f} ms  library {l_ms:.4f} ms  bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})  rel_err "
                f"{e:.2e}" + ("" if e_k1 is None else " (bit for bit K1)")
                + f"  [{card}]")
        del qts, w_lib
        torch.cuda.empty_cache()
    return rows


# per layer of the 2.6B-Q4_K_M decode, the linears each kernel takes
Q4KM_LAYER_LINEARS = {
    "K2": ("wo", "w_gateup"),                       # + output (packed)
    "K3": ("wqkv", "wo", "w_gateup", "w_down"),     # + output
    "K4a": ("wqkv", "w_down"),                      # int8 values
    "K4b": ("wo", "w_gateup"),                      # + output (packed)
}


def q4km_step(rows: list[dict], kernel: str, key: str, m: int = 1):
    """One 2.6B-Q4_K_M decode step's `key` of `kernel` at M = m (1: a single
    stream; 64: a 64-slot batched step), bf16 x (the engine's activations):
    32 layers of its linears, plus the output head where the head is its
    (every kernel but K4a)."""
    by = {r["shape"].split()[1]: r[key] for r in rows
          if r["kernel"] == kernel and r["M"] == m and r["dtype"] == "bf16"
          and r["shape"].startswith("2.6b")}
    layer = sum(by[n] for n in Q4KM_LAYER_LINEARS[kernel])
    return Q4KM_LAYERS * layer + (by["output"] if kernel != "K4a" else 0)


# ---------------------------------------------------------------------------
# Phase 17: K1v (the bf16-dot variants) vs plain
# ---------------------------------------------------------------------------

def phase_bf16(torch, qmat, card: str, k1_rows: list[dict]) -> list[dict]:
    """K1v in both modes against its plain version at phase 2's shapes (f32
    x within 1e-5, bf16 x within 1e-2), then, at bf16 x (the engine's
    activations), the device time of each mode beside K1's (phase 2's row
    of the same shape), the plain version's (mode after), `torch.matmul` on
    a dequantized bf16 weight, and the bound: bytes over 3.35 TB/s or 2MKN
    over the bf16 tensor-core rate."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1 = {(r["shape"], r["M"]): r for r in k1_rows}
    modes = qmat.BF16_MODES[1:]          # "1", "after"
    rows = []
    for label, qt, ms_list in shape_cases(torch, qmat, gen):
        K, N = qt.k, qt.shape[0]
        n_copies = max(2, min(256, -(-L2_FLUSH_BYTES // qt_bytes(qt))))
        qts = copies_of(torch, qmat, qt, n_copies)
        w_lib = [c.dequant_t(torch.float32).to(torch.bfloat16)
                 for c in qts[: max(2, min(256, -(-L2_FLUSH_BYTES
                                                 // (2 * K * N))))]]
        for m in ms_list:
            err, abs_err = {}, 0.0
            for mode in modes:
                for dtype, tol in ((torch.float32, KERNEL_TOL_F32),
                                   (torch.bfloat16, KERNEL_TOL_BF16)):
                    x = torch.randn((m, K), generator=gen,
                                    device="cuda").to(dtype)
                    got = qmat.qdot_bf16(x, qt, mode)
                    want = qmat.qdot_bf16_plain(x, qt, mode)
                    torch.cuda.synchronize()
                    if got.shape != (m, N) or got.dtype != dtype:
                        raise AssertionError(f"K1v {label} M={m}: bad output "
                                             f"{tuple(got.shape)} {got.dtype}")
                    e = rel_err(got.float(), want.float())
                    if not e < tol:
                        raise AssertionError(f"K1v {label} M={m} mode {mode} "
                                             f"{dtype}: kernel vs plain rel "
                                             f"err {e} >= {tol}")
                    if not torch.equal(qmat.qdot_bf16(x, qt, mode), got):
                        raise AssertionError(f"K1v {label} M={m} mode {mode} "
                                             f"{dtype}: two calls differ")
                    err[(mode, str(dtype))] = e
                    abs_err = max(abs_err, float((got.float() - want.float())
                                                 .abs().max()))
            # x is bf16 here: the engine's activations
            n_graph = max(20, min(256, n_copies))
            k_ms = {mode: graph_ms(torch, lambda i, mode=mode: qmat.qdot_bf16(
                x, qts[i % n_copies], mode), n_graph) for mode in modes}
            p_ms = graph_ms(torch, lambda i: qmat.qdot_bf16_plain(
                x, qts[i % n_copies], "after"), 10)
            l_ms = graph_ms(torch, lambda i: torch.matmul(
                x, w_lib[i % len(w_lib)]), max(20, min(256, len(w_lib))))
            e_ms = time_ms(torch, lambda i: qmat.qdot_bf16(
                x, qts[i % n_copies], "after"), 50)
            nbytes = qt_bytes(qt) + 2 * m * K + 2 * m * N
            flops = 2.0 * m * K * N
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS * 1e3
            row = dict(shape=label, M=m, K=K, N=N, bytes=nbytes, flops=flops,
                       group=qt.group, packed=qt.packed,
                       mins=qt.mins is not None, ms=k_ms["after"],
                       ms_mode1=k_ms["1"], plain_ms=p_ms, library_ms=l_ms,
                       eager_ms=e_ms, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       k1_ms=k1[(label, m)]["ms"] if k1 else None,
                       splits=plan_splits(qmat, m, K, N, qt.group),
                       max_abs_err=abs_err, bit_identical=True,
                       rel_err_f32=max(v for (_, d), v in err.items()
                                       if d == str(torch.float32)),
                       rel_err_bf16=max(v for (_, d), v in err.items()
                                        if d == str(torch.bfloat16)))
            rows.append(row)
            k1_txt = "n/a" if not k1 else f"{row['k1_ms']:.4f} ms"
            log(f"K1v {label:28s} M={m:<3d} K={K:<5d} N={N:<6d} kernel after "
                f"{k_ms['after']:.4f} / 1 {k_ms['1']:.4f} ms (eager "
                f"{e_ms:.4f})  K1 {k1_txt}  plain {p_ms:.4f} ms"
                f"  library {l_ms:.4f} ms  bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})  rel_err f32 {row['rel_err_f32']:.2e} "
                f"bf16 {row['rel_err_bf16']:.2e}  [{card}]")
        del qts, w_lib
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 18: the bandwidth-floor probes K7 / K8
# ---------------------------------------------------------------------------

def probe_qtensors(torch, qmat, gen):
    """(label, QTensor) of K8's domain (int8 values, g32, f32 scales): at
    bench_qmat.py's 2.6B shapes its own tensor (values 0..15, scales in
    [0.01, 0.03), mins in [0, 0.01): make_qt), then the 0.1B and LFM2-1.2B
    Q8_0 linears."""
    def bench_qt(k, n):
        return qmat.QTensor(
            values=torch.randint(0, 16, (k, n), generator=gen, device="cuda",
                                 dtype=torch.int32).to(torch.int8),
            scales=torch.rand((k // 32, n), generator=gen, device="cuda")
            * 0.02 + 0.01,
            mins=torch.rand((k // 32, n), generator=gen, device="cuda") * 0.01,
            group=32, n_out=n)
    cases = [(f"2.6b bench_qmat {k}x{n}", bench_qt(k, n)) for k, n in K8_SHAPES]
    for label, k, n in Q8_LINEARS:
        cases.append((label + " q8_0", rand_qtensor(torch, qmat, k, n, "q8_0",
                                                    gen)))
    return cases


def probe_counters(qmat, da):
    return {"K7": (da.dma_floor, "kernel_launches"),
            "K8": (qmat.qdot_dma_floor, "kernel_launches")}


def phase_probes(torch, qmat, card: str, k5_rows: list[dict],
                 attn_rows: list[dict]) -> dict:
    """The probe path (each probe once per shape, counted), then each probe
    against its plain version (K7 bit for bit, K8 within 1e-6) and timed
    over copies larger than the L2, beside the kernel it floors: K8 beside
    K1 at M = 1 (bf16 x) on the same copies, K7 beside K5 (phase 10) and
    K6 (phase 6) at the same shape (bf16 cache).  Fails if a probe streams
    faster than PROBE_MAX_RATE."""
    from miotts_tpu_torch.ops import decode_attn as da
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    k8_cases = probe_qtensors(torch, qmat, gen)
    k7_cases = []
    for label, B, H, H_kv, D, S in K5_SHAPES + ATTN_SHAPES:
        k, v = (torch.randn((B, H_kv, S, D), generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        k7_cases.append(((label, B, H, H_kv, D, S), k, v))

    counters = probe_counters(qmat, da)
    reset_counts(counters)
    for _, qt in k8_cases:
        qmat.qdot_dma_floor(qt)
    for _, k, v in k7_cases:
        da.dma_floor(k, v)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    if launches != {"K7": len(k7_cases), "K8": len(k8_cases)}:
        raise AssertionError(f"probes: launches {launches} for "
                             f"{len(k7_cases)} K7 and {len(k8_cases)} K8 "
                             f"shapes")

    def check_rate(name, label, nbytes, ms):
        rate = nbytes / (ms * 1e-3)
        if rate > PROBE_MAX_RATE:
            raise AssertionError(f"{name} {label}: {rate / 1e9:.1f} GB/s "
                                 f"exceeds 1.05 x HBM: bytes were skipped")
        return rate

    k8_rows = []
    for label, qt in k8_cases:
        K, N = qt.k, qt.shape[0]
        got = qmat.qdot_dma_floor(qt)
        want = qmat.qdot_dma_floor_plain(qt)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        if got.shape != (1, N) or not e < PROBE_TOL:
            raise AssertionError(f"K8 {label}: kernel vs plain rel err {e}")
        streamed = qt.values.numel() + qt.scales.numel() * 4
        n_copies = max(2, min(256, -(-L2_FLUSH_BYTES // streamed)))
        qts = copies_of(torch, qmat, qt, n_copies)
        x = torch.randn((1, K), generator=gen, device="cuda").bfloat16()
        n_graph = max(20, min(256, n_copies))
        p_ms = graph_ms(torch, lambda i: qmat.qdot_dma_floor(
            qts[i % n_copies]), n_graph)
        plain_ms = graph_ms(torch, lambda i: qmat.qdot_dma_floor_plain(
            qts[i % n_copies]), 10)
        k1_ms = graph_ms(torch, lambda i: qmat._qdot_cuda(
            x, qts[i % n_copies]), n_graph)
        nbytes = streamed + 4 * N
        k1_bytes = qt_bytes(qt) + 2 * K + 2 * N
        rate = check_rate("K8", label, nbytes, p_ms)
        row = dict(shape=label, K=K, N=N, bytes=nbytes, ms=p_ms,
                   plain_ms=plain_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   gb_s=rate / 1e9, k1_ms=k1_ms, k1_bytes=k1_bytes,
                   k1_gb_s=k1_bytes / (k1_ms * 1e-3) / 1e9,
                   max_abs_err=float((got - want).abs().max()), rel_err=e)
        k8_rows.append(row)
        log(f"K8 {label:26s} K={K:<5d} N={N:<6d} probe {p_ms:.4f} ms "
            f"({row['gb_s']:.1f} GB/s)  plain {plain_ms:.4f} ms  bound "
            f"{row['bound_ms']:.4f} ms  | K1 M=1 {k1_ms:.4f} ms "
            f"({row['k1_gb_s']:.1f} GB/s)  rel_err {e:.2e}  [{card}]")
        del qts
        torch.cuda.empty_cache()

    def beside(rows, key):
        r = next((r for r in rows if r["mode"] == "bf16" and (
            r["shape"], r["B"], r["H"], r["H_kv"], r["D"], r["S"]) == key),
            None)
        return None if r is None else dict(
            ms=r["ms"], gb_s=r["bytes"] / (r["ms"] * 1e-3) / 1e9)

    k7_rows = []
    for key, k, v in k7_cases:
        label, B, H, H_kv, D, S = key
        got = da.dma_floor(k, v)
        want = da.dma_floor_plain(k, v)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K7 {key}: kernel differs from plain (max "
                                 f"{float((got - want).abs().max())})")
        s_tile = min(S, 512)
        streamed = 2 * B * H_kv * (S // s_tile) * s_tile * D * k.element_size()
        n_copies = max(2, min(512, -(-L2_FLUSH_BYTES // streamed)))
        copies = [(k, v)] + [(k.clone(), v.clone())
                             for _ in range(n_copies - 1)]
        p_ms = graph_ms(torch, lambda i: da.dma_floor(
            *copies[i % n_copies]), max(20, n_copies))
        plain_ms = graph_ms(torch, lambda i: da.dma_floor_plain(
            *copies[i % n_copies]), 4)
        nbytes = streamed + B * H_kv * 8 * D * 4
        rate = check_rate("K7", key, nbytes, p_ms)
        row = dict(shape=label, B=B, H=H, H_kv=H_kv, D=D, S=S, bytes=nbytes,
                   ms=p_ms, plain_ms=plain_ms,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, gb_s=rate / 1e9,
                   k5=beside(k5_rows, key), k6=beside(attn_rows, key),
                   max_abs_err=0.0)
        k7_rows.append(row)
        near = "  ".join(f"| {n} {r['ms']:.4f} ms ({r['gb_s']:.1f} GB/s)"
                         for n, r in (("K5", row["k5"]), ("K6", row["k6"]))
                         if r is not None)
        log(f"K7 {label} B={B:<3d} H_kv={H_kv} D={D} S={S:<4d} probe "
            f"{p_ms:.4f} ms ({row['gb_s']:.1f} GB/s)  plain {plain_ms:.4f} ms"
            f"  bound {row['bound_ms']:.5f} ms  {near}  [{card}]")
        del copies
        torch.cuda.empty_cache()
    return dict(launches=launches, k8=k8_rows, k7=k7_rows)


# ---------------------------------------------------------------------------
# Phase 6: attention kernel vs plain
# ---------------------------------------------------------------------------

def attn_inputs(torch, B, H, H_kv, D, S, mode, gen):
    """q, k, v, fill, q_pos, k_scale, v_scale on the card: staggered fills
    in [1, S], every 7th row idle (fill 0), some q_pos below fill."""
    from miotts_tpu_torch.models.llm import _kv_quantize
    dev = "cuda"
    q = torch.randn((B, H, D), generator=gen, device=dev)
    k = torch.randn((B, H_kv, S, D), generator=gen, device=dev)
    v = torch.randn((B, H_kv, S, D), generator=gen, device=dev)
    fill = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    fill[::7] = 0
    q_pos = fill.clone()
    q_pos[3::5] = fill[3::5] // 2
    if mode == "int8":
        (k, ks), (v, vs) = _kv_quantize(k), _kv_quantize(v)
        return q.bfloat16(), k, v, fill, q_pos, ks, vs
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), fill, q_pos, None, None


def attn_work(torch, B, H, H_kv, D, mode, fill, q_pos, S):
    """(bytes, ops) the call must move / do for THIS data: the k and v rows
    of every valid key (plus their scales), q and the f32 output."""
    limit = torch.minimum(torch.minimum(fill, q_pos + 1),
                          torch.full_like(fill, S)).clamp(min=0)
    keys = int(limit.sum()) * H_kv
    el = 1 if mode == "int8" else 2
    nbytes = 2 * keys * D * el + B * H * D * 2 + B * H * D * 4
    if mode == "int8":
        nbytes += 2 * keys * 4
    ops = 4 * keys * (H // H_kv) * D
    return nbytes, ops


def row_rel(got, want) -> float:
    """Largest difference relative to each output row's own scale."""
    scale = want.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    return float(((got - want).abs() / scale).max())


def check_one_rank(torch, da, inp, plan, label: str) -> float:
    """K6 on one rank against the plan's split on the same inputs: m the
    same bits, int8's acc the same bits (the same p_i8, integer rank sums),
    the output within ATTN_SPLIT_TOL (int8: of the row scale).  Returns the
    output's difference."""
    one = da.AttnPlan(ranks=1)
    acc, m, _ = da.decode_attention_batched(*inp, return_stats=True,
                                            plan=plan)
    acc1, m1, _ = da.decode_attention_batched(*inp, return_stats=True,
                                              plan=one)
    out = da.decode_attention_batched(*inp, plan=plan)
    out1 = da.decode_attention_batched(*inp, plan=one)
    torch.cuda.synchronize()
    int8 = inp[1].dtype == torch.int8
    e = row_rel(out, out1) if int8 else rel_err(out, out1)
    if (not torch.equal(m, m1) or (int8 and not torch.equal(acc, acc1))
            or not e < ATTN_SPLIT_TOL):
        raise AssertionError(f"attn {label}: {plan.ranks} ranks vs one: "
                             f"err {e}, m equal {torch.equal(m, m1)}, acc "
                             f"equal {torch.equal(acc, acc1)}")
    return e


def phase_attn_kernels(torch, card: str) -> list[dict]:
    from miotts_tpu_torch.ops import decode_attn, qmat
    da = decode_attn
    F = torch.nn.functional
    sms = qmat._sm_count(torch.device("cuda"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = []
    for label, B, H, H_kv, D, S in ATTN_SHAPES:
        for mode in ("bf16", "int8"):
            plan = da._attn_plan(B, H_kv, S, sms, mode == "int8")
            inp = attn_inputs(torch, B, H, H_kv, D, S, mode, gen)
            q, k, v, fill, q_pos, ks, vs = inp
            errs = {}
            for stats in (False, True):
                got = da.decode_attention_batched(*inp, return_stats=stats)
                again = da.decode_attention_batched(*inp, return_stats=stats)
                want = da.decode_attention_batched_plain(*inp,
                                                         return_stats=stats)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(
                        got if stats else (got,), again if stats else (again,))):
                    raise AssertionError(f"attn {label} S={S} {mode} stats="
                                         f"{stats}: a second call differs")
                g0 = got[0] if stats else got
                w0 = want[0] if stats else want
                if g0.shape != (B, H, D) or not torch.isfinite(g0).all():
                    raise AssertionError(f"attn {label} S={S} {mode}: bad "
                                         f"output {tuple(g0.shape)}")
                if mode == "int8":
                    scale = w0.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
                    e = float(((g0 - w0).abs() / scale).max())
                else:
                    e = rel_err(g0, w0)
                if not e < ATTN_TOL:
                    raise AssertionError(f"attn {label} S={S} {mode} stats="
                                         f"{stats}: kernel vs plain err {e}")
                errs[stats] = e
            abs_err = float((g0 - w0).abs().max())
            split_err = (check_one_rank(torch, da, inp, plan, f"{label} S={S}"
                                        f" {mode}") if plan.ranks > 1 else 0.0)
            cache_bytes = 2 * k.numel() * k.element_size()
            n_copies = max(2, min(64, -(-L2_FLUSH_BYTES // cache_bytes)))
            copies = [(k, v, ks, vs)] + [
                (k.clone(), v.clone(), None if ks is None else ks.clone(),
                 None if vs is None else vs.clone())
                for _ in range(n_copies - 1)]

            def kern(i):
                c = copies[i % n_copies]
                return da.decode_attention_batched(q, c[0], c[1], fill, q_pos,
                                                   c[2], c[3])

            def kern_one(i):
                c = copies[i % n_copies]
                return da.decode_attention_batched(
                    q, c[0], c[1], fill, q_pos, c[2], c[3],
                    plan=da.AttnPlan(ranks=1))

            def plain(i):
                c = copies[i % n_copies]
                return da.decode_attention_batched_plain(
                    q, c[0], c[1], fill, q_pos, c[2], c[3])
            k_ms = graph_ms(torch, kern, max(20, n_copies))
            r1_ms = (graph_ms(torch, kern_one, max(20, n_copies))
                     if plan.ranks > 1 else k_ms)
            p_ms = graph_ms(torch, plain, 4)
            e_ms = time_ms(torch, kern, 50)
            l_ms = None
            if mode == "bf16":
                # scaled_dot_product_attention over each row's valid keys,
                # heads expanded beforehand (a yardstick, never the port's)
                rep_ = H // H_kv
                limit = torch.minimum(fill, q_pos + 1)
                mask = (torch.arange(S, device="cuda")[None, :]
                        < limit[:, None])[:, None, None, :]
                kx = [c[0].repeat_interleave(rep_, dim=1) for c in copies]
                vx = [c[1].repeat_interleave(rep_, dim=1) for c in copies]
                q4 = q[:, :, None, :]
                l_ms = graph_ms(torch, lambda i: F.scaled_dot_product_attention(
                    q4, kx[i % n_copies], vx[i % n_copies], attn_mask=mask),
                    max(20, n_copies))
                del kx, vx
            nbytes, ops = attn_work(torch, B, H, H_kv, D, mode, fill, q_pos, S)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / (PEAK_INT8_OPS if mode == "int8" else PEAK_FLOPS) * 1e3
            row = dict(shape=label, B=B, H=H, H_kv=H_kv, D=D, S=S, mode=mode,
                       bytes=nbytes, ops=ops, ms=k_ms, eager_ms=e_ms,
                       plain_ms=p_ms, library_ms=l_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       ranks=plan.ranks, r1_ms=r1_ms, split_err=split_err,
                       max_abs_err=abs_err, err=errs[False],
                       err_stats=errs[True])
            rows.append(row)
            lib = "none" if l_ms is None else f"{l_ms:.4f} ms"
            log(f"attn {label} B={B:<3d} H={H}/{H_kv} D={D} S={S:<4d} {mode:4s}"
                f" kernel {k_ms:.4f} ms (eager {e_ms:.4f}; {plan.ranks} ranks,"
                f" one rank {r1_ms:.4f})  plain {p_ms:.4f} ms  library {lib}"
                f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']})  err "
                f"{errs[False]:.2e} / stats {errs[True]:.2e} / split "
                f"{split_err:.1e}  [{card}]")
            del copies
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 10 (a): K5 vs plain
# ---------------------------------------------------------------------------

def k5_inputs(torch, B, H, H_kv, D, S, mode, gen):
    """q, k, v, fill, q_pos, k_scale, v_scale on the card.  B = 1: the
    hybrid decode's rows, fill 3/4 of S less 2 (190 keys at S = 256) and
    q_pos = fill - 1; B > 1: staggered fills, row 1 idle (fill 0), row 0's
    q_pos below fill - 1.  q is bf16 (the bf16 model's) except in f32
    mode."""
    from miotts_tpu_torch.models.llm import _kv_quantize
    dev = "cuda"
    q = torch.randn((B, H, D), generator=gen, device=dev)
    k = torch.randn((B, H_kv, S, D), generator=gen, device=dev)
    v = torch.randn((B, H_kv, S, D), generator=gen, device=dev)
    if B == 1:
        fill = torch.full((1,), S * 3 // 4 - 2, dtype=torch.int32, device=dev)
        q_pos = fill - 1
    else:
        fill = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
        fill[1] = 0
        q_pos = fill - 1
        q_pos[0] = fill[0] // 2
    if mode == "f32":
        return q, k, v, fill, q_pos, None, None
    if mode == "int8":
        (k, ks), (v, vs) = _kv_quantize(k), _kv_quantize(v)
        return q.bfloat16(), k, v, fill, q_pos, ks, vs
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), fill, q_pos, None, None


def phase_k5(torch, card: str) -> list[dict]:
    from miotts_tpu_torch.ops import decode_attn as da, qmat
    F = torch.nn.functional
    sms = qmat._sm_count(torch.device("cuda"))
    one = da.AttnPlan(ranks=1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rows = []
    for label, B, H, H_kv, D, S in K5_SHAPES:
        plan = da._single_plan(B, H_kv, S, sms)
        for mode in ("bf16", "f32", "int8"):
            inp = k5_inputs(torch, B, H, H_kv, D, S, mode, gen)
            q, k, v, fill, q_pos, ks, vs = inp
            got = da.decode_attention(*inp)
            again = da.decode_attention(*inp)
            got1 = da.decode_attention(*inp, plan=one)
            want = da.decode_attention_plain(*inp)
            torch.cuda.synchronize()
            if (got.shape != (B, H, D) or not torch.isfinite(got).all()
                    or not (got[fill == 0] == 0).all()):
                raise AssertionError(f"k5 {label} S={S} {mode}: bad output")
            if not torch.equal(got, again):
                raise AssertionError(f"k5 {label} B={B} S={S} {mode}: a "
                                     f"second call differs")
            e = rel_err(got, want)
            if not e < K5_TOL:
                raise AssertionError(f"k5 {label} B={B} S={S} {mode}: kernel "
                                     f"vs plain rel err {e} >= {K5_TOL}")
            split_err = rel_err(got, got1)
            if not split_err < K5_SPLIT_TOL:
                raise AssertionError(f"k5 {label} B={B} S={S} {mode}: "
                                     f"{plan.ranks} ranks vs one: rel err "
                                     f"{split_err} >= {K5_SPLIT_TOL}")
            abs_err = float((got - want).abs().max())
            cache_bytes = 2 * k.numel() * k.element_size() + (
                0 if ks is None else 2 * ks.numel() * 4)
            n_copies = max(2, min(512, -(-L2_FLUSH_BYTES // cache_bytes)))
            copies = [(k, v, ks, vs)] + [
                (k.clone(), v.clone(), None if ks is None else ks.clone(),
                 None if vs is None else vs.clone())
                for _ in range(n_copies - 1)]

            def kern(i, plan=None):
                c = copies[i % n_copies]
                return da.decode_attention(q, c[0], c[1], fill, q_pos, c[2],
                                           c[3], plan=plan)

            def plain(i):
                c = copies[i % n_copies]
                return da.decode_attention_plain(q, c[0], c[1], fill, q_pos,
                                                 c[2], c[3])
            k_ms = graph_ms(torch, kern, n_copies)
            r1_ms = (graph_ms(torch, lambda i: kern(i, one), n_copies)
                     if plan.ranks > 1 else k_ms)
            p_ms = graph_ms(torch, plain, 4)
            e_ms = time_ms(torch, kern, 50)
            l_ms = None
            if mode != "int8":
                # scaled_dot_product_attention over each row's valid keys,
                # heads expanded beforehand (a yardstick, never the port's)
                rep_ = H // H_kv
                limit = torch.minimum(fill, q_pos + 1)
                mask = (torch.arange(S, device="cuda")[None, :]
                        < limit[:, None])[:, None, None, :]
                kx = [c[0].repeat_interleave(rep_, dim=1) for c in copies]
                vx = [c[1].repeat_interleave(rep_, dim=1) for c in copies]
                q4 = q.to(k.dtype)[:, :, None, :]
                l_ms = graph_ms(torch, lambda i: F.scaled_dot_product_attention(
                    q4, kx[i % n_copies], vx[i % n_copies], attn_mask=mask),
                    n_copies)
                del kx, vx
            limit = torch.minimum(fill, q_pos + 1).clamp(0, S)
            keys = int(limit.sum()) * H_kv
            nbytes = (2 * keys * D * k.element_size() + q.numel()
                      * q.element_size() + B * H * D * 4)
            if mode == "int8":
                nbytes += 2 * keys * 4
            ops = 4 * keys * (H // H_kv) * D
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_F32_FLOPS * 1e3
            row = dict(shape=label, B=B, H=H, H_kv=H_kv, D=D, S=S, mode=mode,
                       valid_keys=int(limit.sum()), bytes=nbytes, ops=ops,
                       ms=k_ms, eager_ms=e_ms, plain_ms=p_ms, library_ms=l_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       ranks=plan.ranks, r1_ms=r1_ms, split_err=split_err,
                       max_abs_err=abs_err, err=e)
            rows.append(row)
            lib = "none" if l_ms is None else f"{l_ms:.4f} ms"
            log(f"k5 {label} B={B} H={H}/{H_kv} D={D} S={S:<4d} {mode:4s} "
                f"kernel {k_ms:.4f} ms (eager {e_ms:.4f}; {plan.ranks} ranks,"
                f" one rank {r1_ms:.4f})  plain {p_ms:.4f} ms  library {lib}"
                f"  bound {row['bound_ms']:.5f} ms ({row['bound_by']})  err "
                f"{e:.2e} / split {split_err:.1e}  [{card}]")
            del copies
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 3/4: main path
# ---------------------------------------------------------------------------

def write_models(d: str):
    import numpy as np
    from miotts_tpu_torch.gguf import GGML_Q8_0, write_voice_embedding
    from miotts_tpu_torch.models.codec import CodecConfig
    from miotts_tpu_torch.models.llm import LLMConfig
    from miotts_tpu_torch.models.synthetic import (write_synthetic_codec,
                                                   write_synthetic_llm)
    paths = {k: os.path.join(d, f"{k}.gguf") for k in ("llm", "codec", "voice")}
    cfg = LLMConfig(arch="qwen2", n_layers=LAYERS, dim=DIM, n_heads=HEADS,
                    n_kv_heads=KV_HEADS, head_dim=HEAD_DIM, ff_dim=FF,
                    n_vocab=256 + 3 + N_SPEECH, n_ctx=2048, rope_theta=1e6,
                    rope_style="neox", qkv_bias=True, qk_norm=False)
    write_synthetic_llm(paths["llm"], cfg=cfg, quant_type=GGML_Q8_0, seed=0)
    write_synthetic_codec(paths["codec"], cfg=CodecConfig(), n_codes=N_SPEECH,
                          seed=1)
    write_voice_embedding(paths["voice"], np.random.default_rng(7)
                          .standard_normal(128).astype(np.float32) * 0.3)
    return paths


def phase_main_path(torch, qmat, paths: dict, out_dir: str, card: str) -> dict:
    import numpy as np
    from miotts_tpu_torch.audio.wav import wav_read
    from miotts_tpu_torch.runtime.engine import (EngineConfig, Options,
                                                 TTSEngine, VoiceModel)
    t0 = time.perf_counter()
    eng = TTSEngine(EngineConfig(model_path=paths["llm"],
                                 codec_path=paths["codec"], device="cuda",
                                 max_tokens=MAX_TOKENS, temperature=0.0))
    voice = VoiceModel(paths["voice"])
    log(f"main: engine load {time.perf_counter() - t0:.2f} s")
    text = "The quick brown fox jumps over the lazy dog."
    opts = Options(temperature=0.0, max_tokens=MAX_TOKENS)
    eng.synthesize(voice, text, Options(temperature=0.0, max_tokens=8))  # warm

    from miotts_tpu_torch.ops import decode_attn
    wav = os.path.join(out_dir, "main.wav")
    prof: dict = {}
    qmat.qdot.kernel_launches = 0
    decode_attn.decode_attention.kernel_launches = 0
    t0 = time.perf_counter()
    eng.synthesize_to_file(voice, text, wav, opts, profile=prof)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = qmat.qdot.kernel_launches
    k5 = decode_attn.decode_attention.kernel_launches
    if k5:
        raise AssertionError(f"the dense decode (deferred write) launched K5 "
                             f"{k5} times")

    audio, sr = wav_read(wav)
    n_codes = prof["n_codes"]
    if not (np.isfinite(audio).all() and sr == eng.sample_rate
            and audio.size == n_codes * eng.samples_per_token):
        raise AssertionError(f"bad WAV: {audio.size} samples at {sr} Hz for "
                             f"{n_codes} codes")
    peak = float(np.max(np.abs(audio)))
    if abs(peak - 0.95) > 1e-3:
        raise AssertionError(f"peak {peak} != 0.95")
    want = QDOT_PER_STEP * (1 + prof["decode_steps"])
    if launches != want:
        raise AssertionError(f"qdot kernel launches {launches} != {want} "
                             f"(49 per decode step + 49 for the prefill)")
    audio_s = audio.size / sr
    res = dict(prefill_ms=prof["prefill_sec"] * 1e3,
               decode_tok_s=prof["decode_steps"] / prof["decode_sec"],
               decode_steps=prof["decode_steps"], llm_tokens=prof["llm_tokens"],
               n_codes=n_codes, codec_istft_s=prof["codec_sec"],
               audio_s=audio_s, wall_s=wall, x_realtime=audio_s / wall,
               qdot_launches=launches, k5_launches=k5)
    for k in ("prefill_ms", "decode_tok_s", "codec_istft_s", "audio_s",
              "wall_s", "x_realtime"):
        log(f"main: {k} {res[k]:.4f}  [{card}]")
    log(f"main: {res['llm_tokens']} tokens kept of {res['decode_steps']} "
        f"decode steps, {n_codes} codes, {launches} qdot launches")

    # --- GPU vs CPU reference (f32 LLM prefill logits, codec spectrogram)
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.codec import codec_decode_spec
    from miotts_tpu_torch.models.llm import init_kv_cache, llm_prefill, load_llm_params
    toks = torch.arange(3, 3 + 64)[None] * 37 % (256 + 3 + N_SPEECH)
    logits = []
    with GGUFReader(paths["llm"]) as r:
        for dev in ("cuda", "cpu"):
            params, cfg = load_llm_params(r, dtype=torch.float32, device=dev)
            cache = init_kv_cache(cfg, 1, 128, dtype=torch.float32, device=dev)
            last, _ = llm_prefill(params, toks.to(dev), torch.tensor([50]),
                                  cache, cfg)
            logits.append(last.cpu())
            del params, cache
    e_llm = rel_err(logits[0], logits[1])
    codes = torch.arange(32, dtype=torch.int32) * 397 % N_SPEECH
    emb = voice.device_embedding("cpu")
    spec_gpu = codec_decode_spec(eng.codec_params, codes.cuda(), emb.cuda(),
                                 eng.codec_cfg, n_real=27)
    spec_cpu = codec_decode_spec(_to_cpu(eng.codec_params), codes, emb,
                                 eng.codec_cfg, n_real=27)
    frames = 27 * eng.codec_cfg.total_upsample
    e_codec = max(rel_err(g[:frames].cpu(), c[:frames])
                  for g, c in zip(spec_gpu, spec_cpu))
    log(f"main: GPU vs CPU reference rel err: LLM f32 prefill logits "
        f"{e_llm:.2e}, codec spectrogram {e_codec:.2e} (tol {REF_TOL})")
    if not (e_llm < REF_TOL and e_codec < REF_TOL):
        raise AssertionError("GPU path disagrees with the CPU reference")
    res.update(ref_rel_err_llm=e_llm, ref_rel_err_codec=e_codec)

    # --- phase 4: --skip-llm through the same engine
    qmat.qdot.kernel_launches = 0
    skip_codes = [int(c) for c in codes[:20]]
    skip_text = "".join(f"<|s_{c}|>" for c in skip_codes)
    wav2 = os.path.join(out_dir, "skip.wav")
    eng.synthesize_to_file(voice, skip_text, wav2, Options(skip_llm=True))
    audio2, _ = wav_read(wav2)
    if audio2.size != 20 * eng.samples_per_token or not np.isfinite(audio2).all():
        raise AssertionError(f"skip-llm WAV has {audio2.size} samples")
    if qmat.qdot.kernel_launches != 0:
        raise AssertionError("skip-llm path launched the LLM kernel")
    log(f"skip-llm: {audio2.size} samples, peak "
        f"{float(np.max(np.abs(audio2))):.4f}")
    res["profile"] = profile_decode(torch, eng, text, Options, card)
    return res


def device_profile(torch, fn, label: str, card: str) -> dict:
    """torch.profiler over fn() (which returns the decode steps it ran):
    device time by kernel, the device-busy share of the wall time and host
    kernel launches per step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)
    kernels = sorted((e for e in events if dev_us(e) > 0), key=dev_us,
                     reverse=True)
    busy_s = sum(dev_us(e) for e in kernels) * 1e-6
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    # the 12 largest by device time, and every kernel of the port
    shown = kernels[:12] + [e for e in kernels[12:]
                            if "qdot" in e.key or "decode_attn" in e.key]
    out = dict(wall_s=wall, steps=steps, device_busy_s=busy_s,
               busy_share=busy_s / wall if busy_s else None,
               host_launches_per_step=launches / steps,
               top=[dict(name=e.key[:80], count=e.count, ms=dev_us(e) * 1e-3)
                    for e in shown])
    if not busy_s:
        log(f"profile {label}: the profiler reported no device time "
            f"(not measured)")
        return out
    log(f"profile {label}: wall {wall:.4f} s, device busy {busy_s:.4f} s "
        f"({100 * busy_s / wall:.1f}%), {out['host_launches_per_step']:.0f} "
        f"kernel launches per step over {steps} steps  [{card}]")
    for t in out["top"]:
        log(f"profile:   {t['ms']:9.3f} ms  x{t['count']:<6d} {t['name']}")
    return out


def profile_decode(torch, eng, text, Options, card: str,
                   label: str = "prefill + 64 decode steps") -> dict:
    """Where one generate_tokens call (prefill + one 64-step chunk) spends
    its time."""
    opts = Options(temperature=0.0, max_tokens=16)
    eng.generate_tokens(text, opts)

    def run():
        eng.generate_tokens(text, opts)
        return 65
    return device_profile(torch, run, label, card)


# ---------------------------------------------------------------------------
# Phase 7/8/9: batched serving, GPU vs CPU chunk, HTTP
# ---------------------------------------------------------------------------

def serve_requests(torch, batcher, voice, n_req: int, Options) -> dict:
    """Submit n_req requests (bench_batch.py's mix) and run to completion;
    checks every request's audio and the launches: K6 once per attention
    layer and the quantized linears 4 per layer plus the head per batched
    step (also per prefill wave), through K1, or through K1v alone where
    the engine's route is MIOTTS_QDOT_BF16 on bf16 activations; K5 never.
    Returns the run's numbers."""
    import numpy as np
    from miotts_tpu_torch.ops import decode_attn, qmat
    eng = batcher.engine
    k1v_route = bool(eng.config.qdot_route.bf16) and eng.dtype == torch.bfloat16
    cfg = batcher.engine.llm_cfg
    attn_layers = len(cfg.attn_layer_idx)
    qdot_per_step = 4 * cfg.n_layers + 1
    spt = batcher.engine.samples_per_token
    sr = batcher.engine.sample_rate
    got = {i: {"samples": 0, "finite": True, "peak": 0.0, "final": False,
               "req": None} for i in range(n_req)}

    def make_cb(i):
        def cb(samples, rate, is_last):
            if samples is not None and len(samples):
                a = np.asarray(samples)
                got[i]["samples"] += a.size
                got[i]["finite"] &= bool(np.isfinite(a).all())
                got[i]["peak"] = max(got[i]["peak"], float(np.abs(a).max()))
            got[i]["final"] |= bool(is_last)
            return True
        return cb

    decode_attn.decode_attention_batched.kernel_launches = 0
    decode_attn.decode_attention.kernel_launches = 0
    qmat.qdot.kernel_launches = 0
    qmat.qdot_bf16.kernel_launches = 0
    t0 = time.perf_counter()
    for i in range(n_req):
        batcher.submit(f"concurrent utterance number {i} for serving", voice,
                       make_cb(i), Options(max_tokens=SERVE_TOKENS,
                                           temperature=0.8, seed=100 + i),
                       on_finish=lambda r, i=i: got[i].__setitem__("req", r))
    batcher.run_until_done(max_iters=5000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k6 = decode_attn.decode_attention_batched.kernel_launches
    k5 = decode_attn.decode_attention.kernel_launches
    qd = qmat.qdot.kernel_launches
    qv = qmat.qdot_bf16.kernel_launches
    st = dict(batcher.stage)
    if batcher.pending:
        raise AssertionError(f"serving: {batcher.pending} requests pending")
    for i, g in got.items():
        r = g["req"]
        if r is None or not g["final"]:
            raise AssertionError(f"serving: request {i} got no final callback")
        # the int16 wire format decodes -32768 to -32768 / 32767
        if not g["finite"] or g["peak"] > 32768 / 32767:
            raise AssertionError(f"serving: request {i} audio not finite or "
                                 f"|x| > 1 (peak {g['peak']})")
        if not r.failed and g["samples"] != len(r.codes) * spt:
            raise AssertionError(f"serving: request {i} emitted {g['samples']}"
                                 f" samples for {len(r.codes)} codes")
    steps = st["device_steps"]
    if k6 != attn_layers * steps:
        raise AssertionError(f"serving: attention kernel launches {k6} != "
                             f"{attn_layers} x {steps} device steps")
    linears, other = (qv, qd) if k1v_route else (qd, qv)
    if linears != qdot_per_step * (steps + st["prefills"]) or other:
        raise AssertionError(f"serving: K1 / K1v launches {qd} / {qv}: want "
                             f"{qdot_per_step} x ({steps} steps + "
                             f"{st['prefills']} prefills) through "
                             f"{'K1v' if k1v_route else 'K1'} alone")
    if k5:
        raise AssertionError(f"serving: K5 launched {k5} times")
    audio_s = sum(g["samples"] for g in got.values()) / sr
    ttfa = sorted(g["req"].first_audio_at - g["req"].submitted_at
                  for g in got.values() if g["req"].first_audio_at >= 0)
    return dict(n_req=n_req, wall_s=wall, audio_s=audio_s,
                aggregate_x_realtime=audio_s / wall,
                ttfa_p50_s=ttfa[len(ttfa) // 2] if ttfa else None,
                ttfa_max_s=ttfa[-1] if ttfa else None,
                codes=sum(len(g["req"].codes) for g in got.values()),
                failed=sum(g["req"].failed for g in got.values()),
                attn_launches=k6, k5_launches=k5, qdot_launches=qd,
                qdot_bf16_launches=qv, stage=st)


def phase_serving(torch, paths: dict, card: str) -> dict:
    from miotts_tpu_torch.runtime.batching import ContinuousBatcher
    from miotts_tpu_torch.runtime.engine import (EngineConfig, Options,
                                                 TTSEngine, VoiceModel)
    eng = TTSEngine(EngineConfig(model_path=paths["llm"],
                                 codec_path=paths["codec"], device="cuda",
                                 max_tokens=SERVE_TOKENS))
    voice = VoiceModel(paths["voice"])
    out = {}
    for tag, quant, n_req in (("bf16", False, N_REQ),
                              ("int8", True, N_REQ_INT8)):
        batcher = ContinuousBatcher(eng, n_slots=SLOTS, chunk_steps=CHUNK,
                                    quantized_kv=quant)
        t0 = time.perf_counter()
        batcher.warmup(prompt_len=16)
        torch.cuda.synchronize()
        log(f"serving[{tag}]: warmup {time.perf_counter() - t0:.2f} s")
        res = serve_requests(torch, batcher, voice, n_req, Options)
        out[tag] = res
        st = res["stage"]
        log(f"serving[{tag}]: {n_req} requests on {SLOTS} slots, wall "
            f"{res['wall_s']:.4f} s, audio {res['audio_s']:.4f} s, aggregate "
            f"x_realtime {res['aggregate_x_realtime']:.4f}, TTFA p50 "
            f"{res['ttfa_p50_s']:.4f} s (max {res['ttfa_max_s']:.4f} s), "
            f"{res['codes']} codes, {res['failed']} failed  [{card}]")
        log(f"serving[{tag}]: {st['device_steps']} device steps in "
            f"{st['chunks']} chunks, {st['prefills']} prefills, "
            f"{st['decodes']} codec decodes; attention launches "
            f"{res['attn_launches']}, qdot launches {res['qdot_launches']}")
        log(f"serving[{tag}]: stage " + json.dumps(
            {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in st.items()}))
        del batcher
        torch.cuda.empty_cache()
    # where a serving run's time goes: 64 requests x 40 tokens, bf16 cache
    batcher = ContinuousBatcher(eng, n_slots=SLOTS, chunk_steps=CHUNK)
    batcher.warmup(prompt_len=16)

    def run():
        for i in range(SLOTS):
            batcher.submit(f"profiled utterance number {i}", voice,
                           lambda *a: True,
                           Options(max_tokens=40, temperature=0.8, seed=i))
        batcher.run_until_done(max_iters=1000)
        return batcher.stage["device_steps"]
    out["profile"] = device_profile(torch, run, "serving 64 x 40 tokens",
                                    card)
    out["profile"]["stage"] = dict(batcher.stage)
    del batcher
    out["engine"] = eng
    out["voice"] = voice
    return out


def phase_gpu_vs_cpu(torch, paths: dict) -> dict:
    """One greedy 20-step batched chunk of the f32 model on 4 slots (3
    active), on the card (kernels) and on the CPU (plain versions)."""
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.llm import (init_kv_cache,
                                             llm_generate_chunk_batched,
                                             llm_prefill_slots,
                                             load_llm_params)
    n_vocab = 256 + 3 + N_SPEECH
    toks = (torch.arange(3 * 40).reshape(3, 40) * 37 + 11) % n_vocab
    n_real = torch.tensor([40, 23, 31], dtype=torch.int32)
    slots = torch.tensor([0, 2, 3])
    res = {}
    with GGUFReader(paths["llm"]) as r:
        for dev in ("cuda", "cpu"):
            params, cfg = load_llm_params(r, dtype=torch.float32, device=dev)
            cache = init_kv_cache(cfg, 4, 256, dtype=torch.float32, device=dev)
            last, cache = llm_prefill_slots(params, toks.to(dev), n_real,
                                            cache, slots, cfg)
            logits = torch.zeros((4, n_vocab), device=dev)
            logits[slots.to(dev)] = last
            active = torch.tensor([True, False, True, True], device=dev)
            buf, _, last2, cache, _ = llm_generate_chunk_batched(
                params, logits, cache, active,
                torch.zeros(4, dtype=torch.int64, device=dev),
                torch.zeros(4, dtype=torch.int64, device=dev),
                torch.zeros(4, device=dev),
                torch.tensor([-1], device=dev), cfg, 20, 128)
            res[dev] = (last.cpu(), buf.cpu(), last2[slots.to(dev)].cpu())
            del params, cache
    e_first = rel_err(res["cuda"][0], res["cpu"][0])
    e_last = rel_err(res["cuda"][2], res["cpu"][2])
    same = bool(torch.equal(res["cuda"][1], res["cpu"][1]))
    log(f"gpu-vs-cpu: batched chunk f32, 4 slots, 20 steps: tokens "
        f"{'identical' if same else 'DIFFER'}, first-step logits rel err "
        f"{e_first:.2e} (tol {REF_TOL}), last-step {e_last:.2e}")
    if not (same and e_first < REF_TOL):
        raise AssertionError("batched chunk on the card disagrees with the "
                             "CPU plain path")
    return dict(tokens_identical=same, first_logits_rel_err=e_first,
                last_logits_rel_err=e_last)


def phase_http(torch, eng, voice) -> dict:
    from miotts_tpu_torch.runtime.server import TTSServer, make_http_server
    srv = TTSServer(eng, {"v": voice}, n_slots=8)
    srv.start_scheduler()
    httpd = make_http_server(srv, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    port = httpd.server_address[1]
    results = {}

    def one(i, fmt):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        c.request("POST", "/synthesize", body=json.dumps(
            {"text": f"http request number {i}", "max_tokens": 64,
             "temperature": 0.8, "seed": i, "format": fmt}),
            headers={"Content-Type": "application/json"})
        r = c.getresponse()
        results[i] = (r.status, fmt, len(r.read()))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i, f))
               for i, f in enumerate(("wav", "pcm", "wav", "pcm"))]
    for t in threads:
        t.start()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", "/health")
    h = c.getresponse()
    health = (h.status, json.loads(h.read()))
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    drained = srv.shutdown(drain_timeout_sec=60)
    httpd.shutdown()
    httpd.server_close()
    log(f"http: /health {health[0]} {health[1]}; "
        + ", ".join(f"#{i} {fmt} {st} {n} bytes"
                    for i, (st, fmt, n) in sorted(results.items()))
        + f"; wall {wall:.4f} s; drained {drained}")
    if health[0] != 200 or len(results) != 4 or drained is not True:
        raise AssertionError("http phase failed")
    for st, fmt, n in results.values():
        if st != 200 or n <= (44 if fmt == "wav" else 0):
            raise AssertionError(f"http: {fmt} response {st} with {n} bytes")
    return dict(responses=results, wall_s=wall, drained=drained)


# ---------------------------------------------------------------------------
# Phases 11-13 (b, d, c): LFM2-1.2B-Q8_0 offline, serving, GPU vs CPU
# ---------------------------------------------------------------------------

def write_lfm2(d: str) -> str:
    from miotts_tpu_torch.gguf import GGML_Q8_0
    from miotts_tpu_torch.models.synthetic import write_synthetic_llm
    path = os.path.join(d, "lfm2.gguf")
    write_synthetic_llm(path, cfg=lfm2_config(),
                        quant_type=GGML_Q8_0, seed=0)
    return path


def phase_lfm2_offline(torch, paths: dict, out_dir: str, card: str):
    """Text -> WAV through the hybrid model; returns (numbers, engine,
    voice) for the serving phase."""
    import numpy as np
    from miotts_tpu_torch.audio.wav import wav_read
    from miotts_tpu_torch.ops import decode_attn, qmat
    from miotts_tpu_torch.runtime.engine import (EngineConfig, Options,
                                                 TTSEngine, VoiceModel)
    t0 = time.perf_counter()
    eng = TTSEngine(EngineConfig(model_path=paths["lfm2"],
                                 codec_path=paths["codec"], device="cuda",
                                 max_tokens=MAX_TOKENS, temperature=0.0))
    voice = VoiceModel(paths["voice"])
    log(f"lfm2: engine load {time.perf_counter() - t0:.2f} s")
    text = "The quick brown fox jumps over the lazy dog."
    eng.synthesize(voice, text, Options(temperature=0.0, max_tokens=8))

    wav = os.path.join(out_dir, "lfm2.wav")
    prof: dict = {}
    counters = (qmat.qdot, decode_attn.decode_attention,
                decode_attn.decode_attention_batched)
    for c in counters:
        c.kernel_launches = 0
    t0 = time.perf_counter()
    eng.synthesize_to_file(voice, text, wav,
                           Options(temperature=0.0, max_tokens=MAX_TOKENS),
                           profile=prof)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    qd, k5, k6 = (c.kernel_launches for c in counters)

    audio, sr = wav_read(wav)
    n_codes = prof["n_codes"]
    if not (np.isfinite(audio).all() and sr == eng.sample_rate
            and audio.size == n_codes * eng.samples_per_token
            and abs(float(np.max(np.abs(audio))) - 0.95) < 1e-3):
        raise AssertionError(f"lfm2: bad WAV, {audio.size} samples at {sr} "
                             f"Hz for {n_codes} codes")
    steps = prof["decode_steps"]
    n_attn = len(LFM2_ATTN_IDX)
    if k5 != n_attn * steps:
        raise AssertionError(f"lfm2: K5 launches {k5} != {n_attn} x {steps} "
                             f"decode steps (none in the prefill)")
    if qd != LFM2_QDOT_PER_STEP * (1 + steps):
        raise AssertionError(f"lfm2: qdot launches {qd} != "
                             f"{LFM2_QDOT_PER_STEP} x (1 + {steps})")
    if k6:
        raise AssertionError(f"lfm2: the offline path launched K6 {k6} times")
    audio_s = audio.size / sr
    res = dict(prefill_ms=prof["prefill_sec"] * 1e3,
               decode_tok_s=steps / prof["decode_sec"], decode_steps=steps,
               llm_tokens=prof["llm_tokens"], n_codes=n_codes,
               codec_istft_s=prof["codec_sec"], audio_s=audio_s, wall_s=wall,
               x_realtime=audio_s / wall, qdot_launches=qd, k5_launches=k5)
    for k in ("prefill_ms", "decode_tok_s", "codec_istft_s", "audio_s",
              "wall_s", "x_realtime"):
        log(f"lfm2: {k} {res[k]:.4f}  [{card}]")
    log(f"lfm2: {res['llm_tokens']} tokens kept of {steps} decode steps, "
        f"{n_codes} codes; launches: K5 {k5}, qdot {qd}, K6 {k6}")

    # the conv state a request leaves must not reach the next one
    opts = Options(temperature=0.0, max_tokens=64)
    before = eng.generate_tokens(text, opts)
    eng.generate_tokens("A different request in between.", opts)
    after = eng.generate_tokens(text, opts)
    log(f"lfm2: one text before and after another request: tokens "
        f"{'identical' if before == after else 'DIFFER'} ({len(before)})")
    if before != after or not before:
        raise AssertionError("lfm2: greedy tokens depend on the previous "
                             "request")
    res["reuse_tokens_identical"] = True
    res["profile"] = profile_decode(torch, eng, text, Options, card,
                                    "lfm2 prefill + 64 decode steps")
    return res, eng, voice


def phase_lfm2_serving(torch, eng, voice, card: str) -> dict:
    from miotts_tpu_torch.runtime.batching import ContinuousBatcher
    from miotts_tpu_torch.runtime.engine import Options
    batcher = ContinuousBatcher(eng, n_slots=LFM2_SLOTS, chunk_steps=CHUNK)
    t0 = time.perf_counter()
    batcher.warmup(prompt_len=16)
    torch.cuda.synchronize()
    log(f"lfm2 serving: warmup {time.perf_counter() - t0:.2f} s")
    res = serve_requests(torch, batcher, voice, LFM2_REQ, Options)
    st = res["stage"]
    log(f"lfm2 serving: {LFM2_REQ} requests on {LFM2_SLOTS} slots, wall "
        f"{res['wall_s']:.4f} s, audio {res['audio_s']:.4f} s, aggregate "
        f"x_realtime {res['aggregate_x_realtime']:.4f}, TTFA p50 "
        f"{res['ttfa_p50_s']:.4f} s (max {res['ttfa_max_s']:.4f} s), "
        f"{res['codes']} codes, {res['failed']} failed  [{card}]")
    log(f"lfm2 serving: {st['device_steps']} device steps in {st['chunks']} "
        f"chunks, {st['prefills']} prefills; launches: K6 "
        f"{res['attn_launches']}, qdot {res['qdot_launches']}, K5 "
        f"{res['k5_launches']}")
    log("lfm2 serving: stage " + json.dumps(
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in st.items()}))

    # where a batched LFM2 step's time goes: 16 requests x 40 tokens
    def run():
        steps0 = batcher.stage["device_steps"]
        for i in range(LFM2_SLOTS):
            batcher.submit(f"profiled utterance number {i}", voice,
                           lambda *a: True,
                           Options(max_tokens=40, temperature=0.8, seed=i))
        batcher.run_until_done(max_iters=1000)
        return batcher.stage["device_steps"] - steps0
    res["profile"] = device_profile(torch, run, "lfm2 serving 16 x 40 tokens",
                                    card)
    res["after"] = lfm2_serving_after(torch, eng, voice, card, res)
    return res


def lfm2_serving_after(torch, eng, voice, card: str, default: dict) -> dict:
    """The same weights under MIOTTS_QDOT_BF16=after (K1v at M = 16, the
    batched step's tile): 16 requests x 96 tokens on 16 slots, then the
    same 16 x 40 profile; printed beside the default route's."""
    from miotts_tpu_torch.ops import qmat
    from miotts_tpu_torch.runtime.batching import ContinuousBatcher
    from miotts_tpu_torch.runtime.engine import Options
    after = eng.with_qdot_route(qmat.QdotRoute.from_env(
        {"MIOTTS_QDOT_BF16": "after"}))
    batcher = ContinuousBatcher(after, n_slots=LFM2_SLOTS, chunk_steps=CHUNK)
    batcher.warmup(prompt_len=16)
    res = serve_requests(torch, batcher, voice, LFM2_AFTER_REQ, Options)
    st = res["stage"]

    def run():
        steps0 = batcher.stage["device_steps"]
        for i in range(LFM2_SLOTS):
            batcher.submit(f"profiled utterance number {i}", voice,
                           lambda *a: True,
                           Options(max_tokens=40, temperature=0.8, seed=i))
        batcher.run_until_done(max_iters=1000)
        return batcher.stage["device_steps"] - steps0
    res["profile"] = device_profile(
        torch, run, "lfm2 serving (after) 16 x 40 tokens", card)
    log(f"lfm2 serving[after]: {LFM2_AFTER_REQ} requests x {SERVE_TOKENS} "
        f"tokens on {LFM2_SLOTS} slots, wall {res['wall_s']:.4f} s, "
        f"aggregate x_realtime {res['aggregate_x_realtime']:.4f} (default "
        f"route {default['aggregate_x_realtime']:.4f}), TTFA p50 "
        f"{res['ttfa_p50_s']:.4f} s, device busy "
        f"{res['profile']['busy_share']} (default route "
        f"{default['profile']['busy_share']}); {st['device_steps']} device "
        f"steps, {st['prefills']} prefills; launches: K1v "
        f"{res['qdot_bf16_launches']}, K6 {res['attn_launches']}, K1 "
        f"{res['qdot_launches']}, K5 {res['k5_launches']}  [{card}]")
    del batcher
    return res


def phase_lfm2_gpu_vs_cpu(torch, path: str) -> dict:
    """Layers 0-5 of the LFM2 file (4 conv, 2 attention) at full width,
    f32: a prefill and a 20-step greedy chunk on the card (K1, K5) and on
    the CPU (plain versions)."""
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.llm import (LLMConfig, init_kv_cache,
                                             llm_generate_chunk, llm_prefill,
                                             load_llm_params)
    from miotts_tpu_torch.ops import decode_attn
    n_vocab = 256 + 3 + N_SPEECH
    toks = torch.zeros((1, 48), dtype=torch.int64)
    toks[0, :40] = (torch.arange(40) * 37 + 11) % n_vocab
    res = {}
    with GGUFReader(path) as r:
        cfg = LLMConfig.from_gguf(r)
        cfg = dataclasses.replace(cfg, n_layers=LFM2_REF_LAYERS,
                                  layer_types=cfg.layer_types[:LFM2_REF_LAYERS])
        for dev in ("cuda", "cpu"):
            params, _ = load_llm_params(r, cfg, dtype=torch.float32,
                                        device=dev)
            cache = init_kv_cache(cfg, 1, 128, dtype=torch.float32, device=dev)
            decode_attn.decode_attention.kernel_launches = 0
            last, cache = llm_prefill(params, toks.to(dev), torch.tensor([40]),
                                      cache, cfg)
            first = last.cpu()
            buf, n, _, last, cache = llm_generate_chunk(
                params, last, cache, 0.0, torch.tensor([-1], device=dev), cfg,
                20)
            res[dev] = (first, buf.cpu(), last.cpu(),
                        decode_attn.decode_attention.kernel_launches)
            del params, cache
    n_attn = sum(t == "attn" for t in cfg.layer_types)
    if res["cuda"][3] != n_attn * 20:
        raise AssertionError(f"lfm2 gpu-vs-cpu: K5 launches {res['cuda'][3]}"
                             f" != {n_attn} x 20")
    e_first = rel_err(res["cuda"][0], res["cpu"][0])
    e_last = rel_err(res["cuda"][2], res["cpu"][2])
    same = bool(torch.equal(res["cuda"][1], res["cpu"][1]))
    log(f"lfm2 gpu-vs-cpu: layers 0-{LFM2_REF_LAYERS - 1} f32, prefill + 20 "
        f"greedy steps: tokens {'identical' if same else 'DIFFER'}, prefill "
        f"logits rel err {e_first:.2e}, last-step {e_last:.2e} (tol "
        f"{REF_TOL})")
    if not (same and e_first < REF_TOL and e_last < REF_TOL):
        raise AssertionError("LFM2 on the card disagrees with the CPU plain "
                             "path")
    return dict(tokens_identical=same, first_logits_rel_err=e_first,
                last_logits_rel_err=e_last, k5_launches=res["cuda"][3])


# ---------------------------------------------------------------------------
# Phases 15-16: 2.6B-Q4_K_M offline under each route, GPU vs CPU
# ---------------------------------------------------------------------------

def write_q4km(d: str) -> str:
    from miotts_tpu_torch.gguf import GGML_Q4_K
    from miotts_tpu_torch.models.llm import LLMConfig
    from miotts_tpu_torch.models.synthetic import write_synthetic_llm
    path = os.path.join(d, "q4km.gguf")
    cfg = LLMConfig(arch="qwen2", n_layers=Q4KM_LAYERS, dim=2560, n_heads=32,
                    n_kv_heads=8, head_dim=80, ff_dim=8192,
                    n_vocab=256 + 3 + N_SPEECH, n_ctx=2048, rope_theta=1e6,
                    rope_style="neox", qkv_bias=True, qk_norm=False)
    write_synthetic_llm(path, cfg=cfg, quant_type=GGML_Q4_K, seed=0,
                        mixed_k=True)
    return path


# the large model files: numpy on one host core each (LFM2-1.2B ~45 s,
# 2.6B-Q4_K_M 130-160 s), so they are written by processes of their own
# while the earlier phases run on the card
WRITERS = {"lfm2": (write_lfm2, "lfm2: LFM2-1.2B-Q8_0"),
           "q4km": (write_q4km, "q4km: 2.6B-Q4_K_M")}


def timed_write(fn, d: str, label: str) -> None:
    t0 = time.perf_counter()
    path = fn(d)
    log(f"{label} written in {time.perf_counter() - t0:.1f} s "
        f"({os.path.getsize(path) / 1e9:.3f} GB, in a process of its own)")


@contextlib.contextmanager
def background_writes(d: str, keys):
    """Start one spawned writer process per WRITERS entry in `keys`; on
    leaving, stop any that is still running (a phase failed) and join them
    all."""
    ctx = multiprocessing.get_context("spawn")
    procs = {key: ctx.Process(target=timed_write, args=(fn, d, label))
             for key, (fn, label) in WRITERS.items() if key in keys}
    try:
        for p in procs.values():
            p.start()
        yield procs
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
            if p.pid is not None:
                p.join()


def written(procs: dict, key: str, d: str) -> str:
    """Wait for the `key` file's writer; raise if it failed."""
    t0 = time.perf_counter()
    procs[key].join()
    if procs[key].exitcode != 0:
        raise RuntimeError(f"writing the {key} file failed (exit code "
                           f"{procs[key].exitcode})")
    log(f"{key}: waited {time.perf_counter() - t0:.1f} s for its file")
    return os.path.join(d, f"{key}.gguf")


def route_counters(qmat):
    """(object, attribute) of each quantized-matmul kernel's launch count."""
    return {"K1": (qmat.qdot, "kernel_launches"),
            "K2": (qmat.qdot_split, "kernel_launches"),
            "K3": (qmat.qdot_group, "kernel_launches"),
            "K4a": (qmat.qdot_w8a8, "kernel_launches"),
            "K4b": (qmat.qdot_w8a8, "packed_launches"),
            "K1v": (qmat.qdot_bf16, "kernel_launches")}


def reset_counts(counters) -> None:
    for obj, attr in counters.values():
        setattr(obj, attr, 0)


def read_counts(counters) -> dict:
    return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}


def expected_counts(route: str, steps: int, unpacked: int,
                    packed: int) -> dict:
    """Launches of each kernel for one prefill and `steps` decode steps of a
    dense model with `unpacked` int8-valued and `packed` nibble-packed
    quantized linears, under `route` (bf16 activations for groupdot and the
    K1v routes)."""
    want = dict.fromkeys(("K1", "K2", "K3", "K4a", "K4b", "K1v"), 0)
    n = unpacked + packed
    if route in ("bf16dot", "bf16after"):
        want["K1v"] = n * (1 + steps)
    elif route == "split":
        want.update(K1=unpacked * (1 + steps), K2=packed * (1 + steps))
    elif route == "w8a8":
        want.update(K1=n, K4a=unpacked * steps, K4b=packed * steps)
    elif route == "groupdot":
        want.update(K1=n, K3=n * steps)
    else:
        want["K1"] = n * (1 + steps)
    return want


def phase_q4km_offline(torch, qmat, paths: dict, out_dir: str,
                       card: str) -> dict:
    """2.6B-Q4_K_M text -> WAV on the card under each route: one engine
    loads the weights, one more per route shares them
    (TTSEngine.with_qdot_route).  Checks each WAV and each kernel's
    launches; reports the rates, the device-busy share and each route's
    greedy-token agreement with the default route."""
    import numpy as np
    from miotts_tpu_torch.audio.wav import wav_read
    from miotts_tpu_torch.ops import decode_attn
    from miotts_tpu_torch.runtime.engine import (EngineConfig, Options,
                                                 TTSEngine, VoiceModel)
    t0 = time.perf_counter()
    base = TTSEngine(EngineConfig(model_path=paths["q4km"],
                                  codec_path=paths["codec"], device="cuda",
                                  max_tokens=MAX_TOKENS, temperature=0.0,
                                  qdot_route=qmat.QdotRoute()))
    voice = VoiceModel(paths["voice"])
    log(f"q4km: engine load {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB on the card")
    text = "The quick brown fox jumps over the lazy dog."
    counters = route_counters(qmat)
    out, tokens = {}, {}
    for name, env in Q4KM_ROUTES.items():
        route = qmat.QdotRoute.from_env(env)
        eng = base if name == "default" else base.with_qdot_route(route)
        # greedy tokens (the agreement below) and the warm-up
        tokens[name] = eng.generate_tokens(
            text, Options(temperature=0.0, max_tokens=Q4KM_AGREE_TOKENS))
        wav = os.path.join(out_dir, f"q4km_{name}.wav")
        prof: dict = {}
        reset_counts(counters)
        decode_attn.decode_attention.kernel_launches = 0
        t0 = time.perf_counter()
        eng.synthesize_to_file(voice, text, wav, Options(
            temperature=0.0, max_tokens=(MAX_TOKENS if name == "default"
                                         else Q4KM_AGREE_TOKENS)),
            profile=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts(counters)
        k5 = decode_attn.decode_attention.kernel_launches
        audio, sr = wav_read(wav)
        n_codes = prof["n_codes"]
        if not (np.isfinite(audio).all() and sr == eng.sample_rate
                and audio.size == n_codes * eng.samples_per_token
                and abs(float(np.max(np.abs(audio))) - 0.95) < 1e-3):
            raise AssertionError(f"q4km[{name}]: bad WAV, {audio.size} "
                                 f"samples at {sr} Hz for {n_codes} codes")
        steps = prof["decode_steps"]
        want = expected_counts(name, steps, 2 * Q4KM_LAYERS,
                               2 * Q4KM_LAYERS + 1)
        if got != want or k5:
            raise AssertionError(f"q4km[{name}]: launches {got} (K5 {k5}) "
                                 f"!= {want} for 1 prefill + {steps} steps")
        same = sum(a == b for a, b in zip(tokens[name], tokens["default"]))
        compared = min(len(tokens[name]), len(tokens["default"]))
        audio_s = audio.size / sr
        res = dict(route=env, prefill_ms=prof["prefill_sec"] * 1e3,
                   decode_tok_s=steps / prof["decode_sec"],
                   decode_steps=steps, llm_tokens=prof["llm_tokens"],
                   n_codes=n_codes, codec_istft_s=prof["codec_sec"],
                   audio_s=audio_s, wall_s=wall, x_realtime=audio_s / wall,
                   launches=got,
                   launches_per_step={k: v / steps for k, v in got.items()
                                      if v},
                   tokens=len(tokens[name]),
                   tokens_agreeing_with_default=same,
                   tokens_compared=compared,
                   first_disagreement=next(
                       (i for i, (a, b) in enumerate(zip(
                           tokens[name], tokens["default"])) if a != b), None))
        res["profile"] = (profile_steps(
            torch, eng, card, f"q4km[{name}] prefill + 16 steps")
            if name in Q4KM_PROFILED else None)
        out[name] = res
        log(f"q4km[{name}]: prefill {res['prefill_ms']:.4f} ms, decode "
            f"{res['decode_tok_s']:.4f} tok/s, x_realtime "
            f"{res['x_realtime']:.4f}, codec + iSTFT "
            f"{res['codec_istft_s']:.4f} s, {n_codes} codes; launches {got} "
            f"over 1 prefill + {steps} steps; device busy "
            f"{res['profile'] and res['profile']['busy_share']}; tokens "
            f"agreeing with the "
            f"default route {same} of {compared}  [{card}]")
        del eng
    del base
    torch.cuda.empty_cache()
    return out


def profile_steps(torch, eng, card: str, label: str, n_steps: int = 16):
    """Where a prefill (a 64-token bucket) and an n_steps decode chunk of
    the engine's model spend their time: a shorter window than
    profile_decode's 64 steps, because the profiler's own processing grows
    with every launch it records (~2900 per step at 2.6B)."""
    from miotts_tpu_torch.models.llm import (init_kv_cache,
                                             llm_generate_chunk, llm_prefill)
    cfg = eng.llm_cfg
    toks = ((torch.arange(64) * 37 + 11) % cfg.n_vocab)[None].cuda()
    no_stop = torch.tensor([-1], device="cuda")

    def run():
        cache = init_kv_cache(cfg, 1, 256, dtype=eng.dtype, device="cuda")
        last, cache = llm_prefill(eng.llm_params, toks, torch.tensor([45]),
                                  cache, cfg)
        llm_generate_chunk(eng.llm_params, last, cache, 0.0, no_stop, cfg,
                           n_steps)
        return n_steps + 1
    run()
    return device_profile(torch, run, label, card)


def rms_rel(got, want) -> float:
    """RMS of got - want over the RMS of want."""
    got, want = got.double(), want.double()
    return float((got - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt().clamp(min=1e-30))


def phase_q4km_gpu_vs_cpu(torch, qmat, path: str) -> dict:
    """Layers 0-1 of the 2.6B-Q4_K_M file at full width (a depth cut only):
    under split and w8a8 in f32 and groupdot in bf16, a prefill and 8
    greedy steps on the card (the route's kernels), then the same on the
    CPU (their plain versions) fed the card's tokens, so that every step's
    logits compare like with like.  Checks: in f32, greedy tokens identical;
    split, every step within 1e-4 of the logit scale; w8a8, every step's
    RMS relative difference within W8A8_REF_TOL; groupdot and bf16after
    (bf16), prefill and first step within 2e-2 of the scale."""
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.llm import (LLMConfig, init_kv_cache,
                                             llm_decode_step, llm_prefill,
                                             load_llm_params)
    n_vocab = 256 + 3 + N_SPEECH
    toks = torch.zeros((1, 64), dtype=torch.int64)
    toks[0, :45] = (torch.arange(45) * 37 + 11) % n_vocab
    counters = route_counters(qmat)
    checks = {"split": (torch.float32, REF_TOL),
              "w8a8": (torch.float32, W8A8_REF_TOL),
              "groupdot": (torch.bfloat16, BF16_REF_TOL),
              "bf16after": (torch.bfloat16, BF16_REF_TOL)}
    res = {name: {} for name in checks}
    with GGUFReader(path) as r:
        cfg = dataclasses.replace(LLMConfig.from_gguf(r),
                                  n_layers=Q4KM_REF_LAYERS)
        for dev in ("cuda", "cpu"):
            params, _ = load_llm_params(r, cfg, dtype=torch.float32,
                                        device=dev)
            for name, (dtype, _) in checks.items():
                p = qmat.with_route(
                    dict(params, token_embd=params["token_embd"].to(dtype)),
                    qmat.QdotRoute.from_env(Q4KM_ROUTES[name]))
                cache = init_kv_cache(cfg, 1, 128, dtype=dtype, device=dev)
                reset_counts(counters)
                last, cache = llm_prefill(p, toks.to(dev), torch.tensor([45]),
                                          cache, cfg)
                logits, fed = [last.float().cpu()], []
                for i in range(8):
                    tok = (int(logits[-1].argmax()) if dev == "cuda"
                           else res[name]["cuda"]["tokens"][i])
                    fed.append(tok)
                    last, cache = llm_decode_step(
                        p, torch.tensor([tok], device=dev), cache, cfg)
                    logits.append(last.float().cpu())
                res[name][dev] = dict(logits=logits, tokens=fed,
                                      argmax=[int(x.argmax()) for x in logits],
                                      launches=read_counts(counters))
            del params
    out = {}
    for name, (dtype, tol) in checks.items():
        g, c = res[name]["cuda"], res[name]["cpu"]
        want = expected_counts(name, 8, 2 * Q4KM_REF_LAYERS,
                               2 * Q4KM_REF_LAYERS + 1)
        if g["launches"] != want:
            raise AssertionError(f"q4km gpu-vs-cpu[{name}]: launches "
                                 f"{g['launches']} != {want}")
        errs = [rel_err(a, b) for a, b in zip(g["logits"], c["logits"])]
        rms = [rms_rel(a, b) for a, b in zip(g["logits"], c["logits"])]
        same = g["argmax"] == c["argmax"]
        log(f"q4km gpu-vs-cpu[{name}]: layers 0-{Q4KM_REF_LAYERS - 1}, "
            f"{'f32' if dtype == torch.float32 else 'bf16'}, prefill + 8 "
            f"greedy steps (the CPU fed the card's tokens): greedy tokens "
            f"{'identical' if same else 'DIFFER'}, logits rel err prefill "
            f"{errs[0]:.2e}, first step {errs[1]:.2e}, max over steps "
            f"{max(errs):.2e}; RMS rel max {max(rms):.2e} (tol {tol}"
            f"{' RMS' if name == 'w8a8' else ''}); launches {g['launches']}")
        checked = {"split": errs, "w8a8": rms, "groupdot": errs[:2],
                   "bf16after": errs[:2]}[name]
        if max(checked) >= tol or (dtype == torch.float32 and not same):
            raise AssertionError(f"q4km gpu-vs-cpu[{name}]: the card "
                                 f"disagrees with the CPU plain path")
        out[name] = dict(tokens_identical=same, tokens=g["tokens"],
                         logits_rel_err=errs, logits_rms_rel=rms,
                         launches=g["launches"])
    return out


# kernel -> (name, source, the TPU kernel it replaces, the route that runs
# it, what one decode step of its work is)
VARIANTS = {
    "K2": ("qdot_split", "miotts_tpu/ops/qmat.py:246", "split",
           "32 x wo, gate/up; output: 65 packed linears"),
    "K3": ("qdot_group", "miotts_tpu/ops/qmat.py:285", "groupdot",
           "32 x fused QKV, wo, gate/up, w_down; output: 129 linears"),
    "K4a": ("qdot_w8a8", "miotts_tpu/ops/qmat.py:349", "w8a8",
            "32 x fused QKV, w_down: 64 int8-valued linears"),
    "K4b": ("qdot_w8a8_packed", "miotts_tpu/ops/qmat.py:401", "w8a8",
            "32 x wo, gate/up; output: 65 packed linears"),
}


def variant_entry(rows, offline, ref, kernel: str) -> dict:
    """The kernels-line entry of a single-stream kernel: launches on its
    route's 2.6B-Q4_K_M run, and one decode step of its work (phase 14's
    M = 1 bf16 rows summed over the step's linears)."""
    name, replaces, route, what = VARIANTS[kernel]
    mine = [r for r in rows if r["kernel"] == kernel]
    keys = ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")
    step = {k: q4km_step(rows, kernel, k) for k in keys}
    entry = dict(
        name=name, route="cuda",
        source="miotts_tpu_torch/ops/csrc/qdot_gemv.cu",
        sources=["miotts_tpu_torch/ops/csrc/qdot_gemv.cu", GEMV_HEADER]
        + ([TILE_HEADER] if kernel == "K2" else []), replaces=replaces,
        launches=offline[route]["launches"][kernel],
        launches_by_path={f"q4km_{route}_offline":
                          offline[route]["launches"][kernel],
                          f"q4km_{route}_gpu_vs_cpu":
                          ref[route]["launches"][kernel]},
        max_abs_err=max(r["max_abs_err"] for r in mine),
        rel_err=max(r["rel_err"] for r in mine),
        ms=step["ms"], plain_ms=step["plain_ms"],
        bound_ms=max(step["bytes_ms"], step["ops_ms"]),
        bound_by="bytes" if step["bytes_ms"] >= step["ops_ms"] else "operations",
        library_ms=step["library_ms"],
        unit=f"one 2.6B-Q4_K_M decode step of {kernel} work ({what}) at M=1, "
             f"bf16 x")
    if kernel == "K2":      # the split route's 64-slot step: K1's tile
        entry["q4km_64_slot_step"] = {k: q4km_step(rows, kernel, k, 64)
                                      for k in keys}
    return entry


def attn_step_summary(rows: list[dict], key: str, mode: str = "bf16"):
    """One 0.1B serving decode step's attention: 12 layers at the serving
    phase's shape, bf16 (or int8) cache."""
    r = next(r for r in rows if (r["shape"], r["B"], r["H"], r["H_kv"],
                                 r["D"], r["S"]) == ATTN_STEP_SHAPE
             and r["mode"] == mode)
    return None if r[key] is None else LAYERS * r[key]


def _to_cpu(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def step_summary(rows: list[dict], key: str, m: int = 1) -> float:
    """One 0.1B decode step's worth of qdot work at M = m (1: a single
    stream; 64: a 64-slot batched step): every layer's four linears plus
    the output head."""
    by = {r["shape"]: r[key] for r in rows if r["M"] == m
          and r["shape"].startswith("0.1b")}
    layer = sum(v for s, v in by.items() if not s.startswith("0.1b output"))
    return LAYERS * layer + by["0.1b output q8_0"]


def q4km_k1_step(rows: list[dict], key: str, m: int = 1) -> float:
    """One 2.6B-Q4_K_M decode step's K1 work at M = m (1: the default
    route's single stream; 64: a 64-slot batched step): 32 layers of fused
    QKV, wo, gate/up and w_down, plus the output head."""
    by = {r["shape"].split()[1]: r[key] for r in rows if r["M"] == m
          and r["shape"].startswith("2.6b") and "q4_0" not in r["shape"]}
    return Q4KM_LAYERS * (by["wqkv"] + by["wo"] + by["w_gateup"]
                          + by["w_down"]) + by["output"]


def lfm2_step_summary(rows: list[dict], key: str, m: int = 1) -> float:
    """One LFM2-1.2B decode step's qdot work at M = m: 10 conv layers (in /
    out proj, gate/up, down), 6 attention layers (QKV, wo, gate/up, down),
    the output head."""
    by = {r["shape"][5:-5]: r[key] for r in rows if r["M"] == m
          and r["shape"].startswith("lfm2 ")}
    ffn = by["w_gateup"] + by["w_down"]
    n_attn = len(LFM2_ATTN_IDX)
    return ((LFM2_LAYERS - n_attn) * (by["in_proj"] + by["out_proj/wo"] + ffn)
            + n_attn * (by["wqkv"] + by["out_proj/wo"] + ffn) + by["output"])


def single_stream_steps(res: dict) -> dict:
    """One decode step of K1's M = 1 work on the 0.1B, LFM2 and 2.6B paths
    (phase 2's rows) and of K1v's on the 2.6B path (phase 17's, both
    modes), with the two int8 output heads' rows: the numbers a change of
    the M = 1 GEMV is read by.  `res` is the `details` dict of a run (of
    this script or of an earlier commit's)."""
    out = {}
    rows = res.get("qdot_per_shape") or []
    keys = ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms")
    if rows:
        out["k1_0.1b"] = {k: step_summary(rows, k) for k in keys}
        out["k1_lfm2"] = {k: lfm2_step_summary(rows, k) for k in keys}
        out["k1_2.6b"] = {k: q4km_k1_step(rows, k) for k in keys}
        out["k1_heads_ms"] = {r["shape"]: r["ms"] for r in rows if r["M"] == 1
                              and r["shape"] in ("0.1b output q8_0",
                                                 "lfm2 output q8_0")}
    bf16_rows = res.get("bf16_per_shape") or []
    if bf16_rows:
        out["k1v_2.6b"] = {k: q4km_k1_step(bf16_rows, k)
                           for k in keys + ("ms_mode1",)}
    return out


# every phase (3 runs 3-5), and what a phase needs run before it
ALL_PHASES = (2, 3, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18)
PHASE_NEEDS = {9: {7}, 12: {11}}
MODEL_PHASES = {3, 7, 8, 9, 11, 12, 13, 15, 16}   # the 0.1B files, the codec


def parse_phases(argv) -> set:
    """The phases to run: all of them, or those of --phases (for dev runs;
    the summary and the last line are printed only when all ran)."""
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke test of the port.")
    ap.add_argument("--phases", default="",
                    help="comma-separated phase numbers to run (3 runs 3-5; "
                         "9 brings 7, 12 brings 11); default: all")
    args = ap.parse_args(argv)
    if not args.phases:
        return set(ALL_PHASES)
    run = {int(t) for t in args.phases.split(",") if t.strip()}
    if run - set(ALL_PHASES):
        ap.error(f"unknown phases {sorted(run - set(ALL_PHASES))}; "
                 f"choose from {ALL_PHASES}")
    for phase, needs in PHASE_NEEDS.items():
        if phase in run:
            run |= needs
    return run


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    run = parse_phases(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from miotts_tpu_torch.ops import _build, qmat

    t_start = time.perf_counter()
    card = nvidia_smi_line()
    log(f"device: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    _build.load_kernels()
    log(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(logs) or 'cached'})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"build {name}: {line.strip()}")

    def done(label: str) -> None:
        log(f"phase {label} done at {time.perf_counter() - t_start:.1f} s")

    res: dict = {}
    rows = []
    if 2 in run:
        rows = res["qdot_per_shape"] = phase_kernels(torch, qmat, card)
        done("2")

    writers_for = {"lfm2": {11, 12, 13}, "q4km": {15, 16}}
    keys = {k for k, phases in writers_for.items() if run & phases}
    with tempfile.TemporaryDirectory() as d, background_writes(d, keys) as writers:
        paths = {}
        if run & MODEL_PHASES:
            t0 = time.perf_counter()
            paths = write_models(d)
            log(f"models written in {time.perf_counter() - t0:.1f} s")
        if 3 in run:
            res["main_path"] = phase_main_path(torch, qmat, paths, d, card)
            done("3/4/5")
        attn_rows = []
        if 6 in run:
            attn_rows = res["attn_per_shape"] = phase_attn_kernels(torch, card)
            done("6")
        if 7 in run:
            res["serving"] = phase_serving(torch, paths, card)
            done("7")
        if 8 in run:
            res["gpu_vs_cpu"] = phase_gpu_vs_cpu(torch, paths)
            done("8")
        if 7 in run:
            eng, voice = res["serving"].pop("engine"), res["serving"].pop("voice")
            if 9 in run:
                res["http"] = phase_http(torch, eng, voice)
                done("9")
            del eng, voice
        torch.cuda.empty_cache()
        k5_rows = []
        if 10 in run:
            k5_rows = res["k5_per_shape"] = phase_k5(torch, card)
            done("10 (a)")
        if "lfm2" in keys:
            paths["lfm2"] = written(writers, "lfm2", d)
        if 11 in run:
            res["lfm2_offline"], lfm2_eng, lfm2_voice = phase_lfm2_offline(
                torch, paths, d, card)
            done("11 (b)")
            if 12 in run:
                res["lfm2_serving"] = phase_lfm2_serving(torch, lfm2_eng,
                                                         lfm2_voice, card)
                done("12 (d)")
            del lfm2_eng
            torch.cuda.empty_cache()
        if 13 in run:
            res["lfm2_gpu_vs_cpu"] = phase_lfm2_gpu_vs_cpu(torch, paths["lfm2"])
            done("13 (c)")
        if 14 in run:
            res["variants_per_shape"] = phase_variants(torch, qmat, card)
            done("14")
        if 17 in run:
            res["bf16_per_shape"] = phase_bf16(torch, qmat, card, rows)
            done("17")
        if 18 in run:
            res["probes"] = phase_probes(torch, qmat, card, k5_rows, attn_rows)
            done("18")
        if "lfm2" in keys:
            os.remove(paths.pop("lfm2"))
        if "q4km" in keys:
            paths["q4km"] = written(writers, "q4km", d)
        if 15 in run:
            res["q4km_offline"] = phase_q4km_offline(torch, qmat, paths, d, card)
            done("15")
        if 16 in run:
            res["q4km_gpu_vs_cpu"] = phase_q4km_gpu_vs_cpu(torch, qmat,
                                                           paths["q4km"])
            done("16")

    if run != set(ALL_PHASES):
        log("details " + json.dumps(res))
        log("steps " + json.dumps(single_stream_steps(res)))
        log(f"total {time.perf_counter() - t_start:.1f} s (phases "
            f"{sorted(run)} only: no summary)")
        return 0
    main_res, serve_res, ref_res = (res["main_path"], res["serving"],
                                    res["gpu_vs_cpu"])
    lfm2_res, lfm2_serve, lfm2_ref = (res["lfm2_offline"], res["lfm2_serving"],
                                      res["lfm2_gpu_vs_cpu"])
    var_rows, bf16_rows, probes = (res["variants_per_shape"],
                                   res["bf16_per_shape"], res["probes"])
    q4km_res, q4km_ref = res["q4km_offline"], res["q4km_gpu_vs_cpu"]
    steps = single_stream_steps(res)
    qdot_entry = dict(
        name="qdot", route="cuda", source="miotts_tpu_torch/ops/csrc/qdot.cu",
        sources=["miotts_tpu_torch/ops/csrc/qdot.cu", GEMV_HEADER, TILE_HEADER],
        replaces="miotts_tpu/ops/qmat.py:191",
        launches=serve_res["bf16"]["qdot_launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows),
        rel_err=max(max(r["rel_err_bf16"], r["rel_err_f32"]) for r in rows),
        ms=step_summary(rows, "ms", SLOTS),
        plain_ms=step_summary(rows, "plain_ms", SLOTS),
        bound_ms=step_summary(rows, "bound_ms", SLOTS),
        bound_by=("bytes" if step_summary(rows, "bytes", SLOTS)
                  / HBM_BYTES_PER_S >= step_summary(rows, "flops", SLOTS)
                  / PEAK_FLOPS else "operations"),
        library_ms=step_summary(rows, "library_ms", SLOTS),
        unit="one 0.1B-Q8_0 64-slot batched decode step of qdot work "
             "(12 x 4 linears + output) at M=64, bf16 x",
        single_stream_step=steps["k1_0.1b"],
        lfm2_single_stream_step=steps["k1_lfm2"],
        lfm2_16_slot_step={k: lfm2_step_summary(rows, k, LFM2_SLOTS) for k in
                           ("ms", "plain_ms", "bound_ms", "library_ms")},
        q4km_single_stream_step=steps["k1_2.6b"],
        q4km_64_slot_step={k: q4km_k1_step(rows, k, 64) for k in
                           ("ms", "plain_ms", "bound_ms", "library_ms")},
        launches_by_path={"serving_bf16": serve_res["bf16"]["qdot_launches"],
                          "serving_int8": serve_res["int8"]["qdot_launches"],
                          "offline": main_res["qdot_launches"],
                          "lfm2_offline": lfm2_res["qdot_launches"],
                          "lfm2_serving": lfm2_serve["qdot_launches"],
                          "lfm2_serving_after": lfm2_serve["after"][
                              "qdot_launches"],
                          **{f"q4km_{name}_offline": r["launches"]["K1"]
                             for name, r in q4km_res.items()}})
    step_rows = [r for r in attn_rows if r["mode"] == "bf16"
                 and (r["shape"], r["B"], r["H"], r["H_kv"], r["D"],
                      r["S"]) == ATTN_STEP_SHAPE]
    int8_step = next(r for r in attn_rows if r["mode"] == "int8"
                     and (r["shape"], r["B"], r["H"], r["H_kv"], r["D"],
                          r["S"]) == ATTN_STEP_SHAPE)
    attn_entry = dict(
        name="decode_attention_batched", route="cuda",
        source="miotts_tpu_torch/ops/csrc/decode_attn.cu",
        sources=["miotts_tpu_torch/ops/csrc/decode_attn.cu", ATTN_HEADER],
        replaces="miotts_tpu/ops/decode_attn.py:181",
        launches=serve_res["bf16"]["attn_launches"],
        max_abs_err=max(r["max_abs_err"] for r in attn_rows),
        rel_err=max(max(r["err"], r["err_stats"]) for r in attn_rows),
        ms=attn_step_summary(attn_rows, "ms"),
        plain_ms=attn_step_summary(attn_rows, "plain_ms"),
        bound_ms=attn_step_summary(attn_rows, "bound_ms"),
        bound_by=step_rows[0]["bound_by"],
        library_ms=attn_step_summary(attn_rows, "library_ms"),
        unit="one 0.1B serving decode step of attention (12 layers) at "
             "B=64, H=12/4, D=64, S=256, bf16 cache",
        ranks=step_rows[0]["ranks"],
        one_rank_ms=attn_step_summary(attn_rows, "r1_ms"),
        int8_step=dict(
            {k: attn_step_summary(attn_rows, k, "int8")
             for k in ("ms", "plain_ms", "bound_ms", "r1_ms")},
            bound_by=int8_step["bound_by"], library_ms=None,
            unit="the same step on an int8 cache; no single PyTorch call "
                 "computes its quantized-p function"),
        launches_by_path={"serving_bf16": serve_res["bf16"]["attn_launches"],
                          "serving_int8": serve_res["int8"]["attn_launches"],
                          "lfm2_serving": lfm2_serve["attn_launches"]})
    def k5_row(shape):
        return next(r for r in k5_rows if r["mode"] == "bf16" and (
            r["shape"], r["B"], r["H"], r["H_kv"], r["D"], r["S"]) == shape)
    k5_step = k5_row(K5_STEP_SHAPE)
    n_attn = len(LFM2_ATTN_IDX)
    k5_entry = dict(
        name="decode_attention", route="cuda",
        source="miotts_tpu_torch/ops/csrc/decode_attn_single.cu",
        sources=["miotts_tpu_torch/ops/csrc/decode_attn_single.cu",
                 ATTN_HEADER],
        replaces="miotts_tpu/ops/decode_attn.py:55",
        launches=lfm2_res["k5_launches"],
        max_abs_err=max(r["max_abs_err"] for r in k5_rows),
        rel_err=max(r["err"] for r in k5_rows),
        ms=n_attn * k5_step["ms"], plain_ms=n_attn * k5_step["plain_ms"],
        bound_ms=n_attn * k5_step["bound_ms"], bound_by=k5_step["bound_by"],
        library_ms=n_attn * k5_step["library_ms"],
        unit="one LFM2-1.2B offline decode step of attention (6 layers) at "
             "B=1, H=32/8, D=64, S=256 (190 valid keys), bf16 cache",
        ranks=k5_step["ranks"], one_rank_ms=n_attn * k5_step["r1_ms"],
        long_rows={str(shape[-1]): {k: k5_row(shape)[k] for k in (
            "valid_keys", "ranks", "ms", "r1_ms", "library_ms", "bound_ms")}
            for shape in K5_LONG_SHAPES},
        launches_by_path={"lfm2_offline": lfm2_res["k5_launches"],
                          "lfm2_serving": lfm2_serve["k5_launches"],
                          "lfm2_gpu_vs_cpu": lfm2_ref["k5_launches"],
                          "offline": main_res["k5_launches"],
                          "serving_bf16": serve_res["bf16"]["k5_launches"]})
    variant_entries = [variant_entry(var_rows, q4km_res, q4km_ref, kernel)
                       for kernel in VARIANTS]
    lfm2_after = lfm2_serve["after"]
    step16 = {k: lfm2_step_summary(bf16_rows, k, LFM2_SLOTS) for k in
              ("ms", "plain_ms", "bound_ms", "library_ms", "bytes", "flops",
               "k1_ms", "ms_mode1")}
    bf16_entry = dict(
        name="qdot_bf16", route="cuda",
        source="miotts_tpu_torch/ops/csrc/qdot_bf16.cu",
        sources=["miotts_tpu_torch/ops/csrc/qdot_bf16.cu", GEMV_HEADER,
                 TILE_HEADER],
        replaces="miotts_tpu/ops/qmat.py:191",
        launches=lfm2_after["qdot_bf16_launches"],
        launches_by_path={
            "lfm2_serving_after": lfm2_after["qdot_bf16_launches"],
            "q4km_bf16dot_offline": q4km_res["bf16dot"]["launches"]["K1v"],
            "q4km_bf16after_offline": q4km_res["bf16after"]["launches"]["K1v"],
            "q4km_bf16after_gpu_vs_cpu":
                q4km_ref["bf16after"]["launches"]["K1v"]},
        max_abs_err=max(r["max_abs_err"] for r in bf16_rows),
        rel_err=max(max(r["rel_err_bf16"], r["rel_err_f32"])
                    for r in bf16_rows),
        ms=step16["ms"], plain_ms=step16["plain_ms"],
        bound_ms=step16["bound_ms"],
        bound_by=("bytes" if step16["bytes"] / HBM_BYTES_PER_S
                  >= step16["flops"] / PEAK_FLOPS else "operations"),
        library_ms=step16["library_ms"], k1_ms=step16["k1_ms"],
        mode1_ms=step16["ms_mode1"],
        unit="one LFM2-1.2B 16-slot batched decode step of K1v work (65 "
             "linears at M=16), mode after, bf16 x",
        q4km_single_stream_step=dict(steps["k1v_2.6b"],
                                     k1_ms=q4km_k1_step(bf16_rows, "k1_ms")),
        q4km_64_slot_step={k: q4km_k1_step(bf16_rows, k, 64) for k in
                           ("ms", "ms_mode1", "plain_ms", "bound_ms",
                            "library_ms", "k1_ms")})
    k7_step = next(r for r in probes["k7"] if (
        r["shape"], r["B"], r["H"], r["H_kv"], r["D"], r["S"]) == K5_STEP_SHAPE)
    k7_entry = dict(
        name="attn_dma_floor", route="cuda",
        source="miotts_tpu_torch/ops/csrc/dma_floor.cu",
        replaces="miotts_tpu/ops/decode_attn.py:391",
        launches=probes["launches"]["K7"],
        launches_by_path={"probes": probes["launches"]["K7"]},
        max_abs_err=0.0, rel_err=0.0,
        ms=n_attn * k7_step["ms"], plain_ms=n_attn * k7_step["plain_ms"],
        bound_ms=n_attn * k7_step["bound_ms"], bound_by="bytes",
        library_ms=None, gb_s=k7_step["gb_s"],
        unit="one LFM2-1.2B offline decode step of K5's k/v streams (6 "
             "layers) at B=1, H_kv=8, D=64, S=256 (all rows), bf16 cache; "
             "no single PyTorch call computes it")
    k8_bench = [r for r in probes["k8"] if "bench_qmat" in r["shape"]]
    k8_entry = dict(
        name="qdot_dma_floor", route="cuda",
        source="miotts_tpu_torch/ops/csrc/dma_floor.cu",
        replaces="benchmarks/bench_qmat.py:57",
        launches=probes["launches"]["K8"],
        launches_by_path={"probes": probes["launches"]["K8"]},
        max_abs_err=max(r["max_abs_err"] for r in probes["k8"]),
        rel_err=max(r["rel_err"] for r in probes["k8"]),
        ms=Q4KM_LAYERS * sum(r["ms"] for r in k8_bench),
        plain_ms=Q4KM_LAYERS * sum(r["plain_ms"] for r in k8_bench),
        bound_ms=Q4KM_LAYERS * sum(r["bound_ms"] for r in k8_bench),
        bound_by="bytes", library_ms=None,
        k1_ms=Q4KM_LAYERS * sum(r["k1_ms"] for r in k8_bench),
        unit="one 2.6B decode step of K1's value/scale blocks in "
             "bench_qmat.py's configuration (32 layers x its 4 shapes, int8 "
             "g32); no single PyTorch call computes it")
    # the per-shape rows and every phase's numbers, on a line of their own
    # (the kernels line stays short)
    log("details " + json.dumps(res))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [qdot_entry, attn_entry, k5_entry]
                      + variant_entries + [bf16_entry, k7_entry, k8_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
