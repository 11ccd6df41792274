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
  5. profile: torch.profiler over a prefill + one 32-step decode chunk
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
     a prefill + 32 steps;
 12. (d) LFM2 serving: ContinuousBatcher(16 slots, 20-step chunks) on the
     same engine serves 24 requests of 96 tokens (bf16 cache): K6 = 6 x
     device steps, qdot = 65 x (device steps + prefill waves), K5 none;
     then profiles 16 requests x 20 tokens; then the same engine's weights
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
     tokens, the others 16: the harness's time limit); checks each
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
     version (K7 bit for bit, K8 within 1e-6) on its plan (K7: K5's
     `_single_plan`, K8: K1's `_gemv_plan`) and on one rank / one split, a
     second call bit for bit, and timed on both over copies larger than the
     L2; prints each probe's GB/s beside the kernel it floors and fails if
     a probe streams faster than 1.05 x 3.35 TB/s (skipped bytes);
 19. 0.1B streaming: TTSEngine.synthesize_stream on phase 3's files and
     prompt at temperature 0, 128 tokens, after warmup(): the fused path at
     stream_pipeline_depth 1 and 2, the unfused path, the pipelined-codec
     path and the window mode (64 codes); each keeps the offline path's
     tokens (phase 3's), ends with is_last on its last sample, and
     launches qdot 49 x (1 + steps) and K5 never; fused vs unfused within
     1e-4 with the same callbacks and decodes, depth 1 bit for bit depth 2,
     pipelined codec within 1e-6 of unfused; the skip-llm stream of the
     offline codes within 1e-6 of their offline decode; decode_codes_async
     makes no synchronizing call (PyTorch's sync debug mode) and equals
     decode_codes, with its kernel launches and the launch queue's
     back-pressure behind a spin logged; an abort
     at depth 3 gives one callback; `cli bench`, `cli compare` and `cli stream -o
     FILE` in process (the file within one s16 step of the fused stream);
     each run's stream_bench.* numbers with the stage split after
     attribute_stages(), and the device-busy share of a traced 60-token
     fused stream (runtime/profile.device_trace);
 20. LFM2-1.2B streaming on phase 11's engine (full depth) at temperature
     0, 128 tokens: the fused and unfused paths keep phase 11's offline
     tokens, agree within 1e-4 with the same callbacks and decodes, and
     launch K5 6 and qdot 65 per step (qdot 65 for the prefill).
 21. speculative decoding: the 2.6B-Q4_K_M target (phase 15's bf16 engine,
     and an f32 engine over its quantized weights, only the embedding read
     again) with the 0.1B-Q8_0 draft of phase 3 at k = 6: (a)
     K1 vs plain at the verify's shapes (the five 2.6B linears at M = 2,
     4, 7) with times, bound and library; (b) f32, temperature 0, k = 1,
     3, 6 over 16 tokens: the tokens of plain decoding; (c) bf16, k = 6,
     32 tokens: agreement with plain greedy (where they part, the plain
     path's top two logits within 2e-2 of the logit scale), rounds,
     acceptance, tok/s against plain, K1 launches = both prefills + rounds
     x (7 x 49 + 129), and where a round's time goes (a draft step, the
     verify, spec_accept, a plain step; one round profiled); (d) the 0.1B
     drafting for itself at f32, k = 4, 128 tokens, accepts every draft
     (or parts at a near tie); (e) forced acceptance
     (MIOTTS_SPEC_FORCE_ACCEPT 0, 0.5, 0.8, 1) at bf16, 16 tokens: tok/s,
     round time, tokens a round, p = 1 accepting all and p = 0 none; (f)
     a chunk at
     temperature 0 under sync debug mode "error" (at 0.8 what happens is
     recorded, and whether one torch.multinomial draw waits for the
     device); (g) the f32 stream of
     48 tokens with the draft (unfused) within 1e-4 of the plain (fused)
     stream; (h) `cli synth` and `cli bench` with --draft-model /
     --spec-tokens in process (the 0.1B drafting for itself), bench
     printing the two spec lines.
 22. fused serving on phase 7's engine and mix: (a) ContinuousBatcher(64
     slots, 20-step chunks, fused=True), bf16 cache, 80 requests, against
     the unfused batcher at depth 1 (the same schedule) with f32 slices:
     per request the same tokens and sample count, PCM within 1e-4, is_last
     on the last sample, K1 49 x (device steps + prefills) and K6 12 x
     device steps; aggregate x_realtime, TTFA p50 and the stage split beside
     the unfused runs' (phase 7's too); (b) the same on an int8 cache, 16
     requests; (c) codec_fast: 16 requests' codes decoded exact and fast
     (relative RMS within 1e-2, an exact decode after the fast one the same
     bits, both timed), then the unfused batcher with codec_fast over the
     mix; (d) the codec on a CUDA stream of its own (codec_device=0):
     sample-exact against phase 7's run;
 23. the single-stream int8 KV cache (quantized_kv): (a) phase 3's engine,
     128 tokens at bf16: the WAV, qdot 49 per step and per prefill, tok/s
     beside phase 3's; (b) phase 11's LFM2 engine, 128 tokens: K5 6 per
     decode step, every launch on the int8 cache, none in the prefill, qdot
     65 per step and prefill, tok/s beside phase 11's; (c) GPU vs CPU, f32,
     int8 cache, a prefill + 20 greedy steps on LFM2 layers 0-5 and on the
     full-depth 0.1B: tokens identical, logits within 1e-2 of their scale
     (one int8 step at a rounding tie).
 24. the JAX package's remaining switches and the codec's debug surface,
     on loaded engines: (a) MIOTTS_NO_PACK4 on phase 15's 2.6B-Q4_K_M
     engine, its QTensors unpacked on the card (no second load): one Q4_K
     tensor read under the switch has their bits (values, scales, mins);
     32 tokens text -> WAV on the default route (K1 129 a step and
     prefill, K2 / K4b none; the tokens phase 15's or parting at a 2e-2
     near tie), 16 under w8a8 (K4a 129 a step, K4b none) and split (K2
     none, K1 129); f32 tokens identical to the packed weights', logits
     within 1e-4; (b) MIOTTS_FORCE_XLA_QDOT (dequantize + torch.matmul) on
     phase 3's 0.1B: bf16, 64 tokens, no kernel launch, qdot_xla 49 a step
     and prefill, tok/s and agreement beside phase 3's; f32 tokens
     identical to the kernel route's, logits within 1e-4; (c)
     MIOTTS_ATTN_NOCAT on the same engines: f32 tokens identical to the cat
     path's, logits within 1e-5, bf16 64 tokens with qdot 49 a step; (d)
     MIOTTS_WARMUP_VERBOSE: warmup's `warmup: <label>: <s>s` lines with the
     JAX package's labels, none without it; (e) codec_decode_stages on the
     card against the CPU (each stage within 1e-4 of its scale),
     codec_decoder_layer_substeps at the first and last decoder layer (the
     expansion within 1e-4 of the layer output's scale, layer_in = prior,
     layer_out = decoder), codec_decode_audio within 1e-6 of the engine's
     decode, `cli synth --dump-tensors` in process.

Kernel times are device times: the calls are captured in a CUDA graph and
replayed between CUDA events, cycling over weight (or KV-cache) copies
larger than the 50 MB L2 (a decode step streams them cold); the eager
per-call time, Python wrapper included, is printed beside them.

The second-to-last line is the nvidia-smi name / power-limit line; before
it, one JSON object {"kernels": [...]} (each kernel's launches, errors and
times per decode step of its path); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Earlier, a line `details {...}` holds the per-shape rows, every phase's
numbers and each phase's seconds (`phase_seconds`).  Imports nothing of JAX
or of the JAX package.
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
# the serving profiles' tokens a request (phases 7 and 12), cut from 40 for
# the smoke's time: the profiler's processing grows with every launch it
# records (PR 16 full2: phase 12 took 95.6 s with its two profiles at 40,
# phase 7 62.5 s); 20 tokens still profile two chunks (40 steps)
PROFILE_TOKENS = 20
# the single-stream profiles' decode steps (phases 3 and 11: 1111 and 970
# launches a step; phase 15: ~2900), cut from 64 and 16 for the smoke's time
# when phase 24 came (the whole run then took 851.6 s on the H100); a
# steady step's launches and device time do not depend on the window
PROFILE_DECODE_STEPS = 32
Q4KM_PROFILE_STEPS = 8
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
# phase 15's depth: the default route's greedy tokens are Q4KM_AGREE_TOKENS
# (phase 24 holds the unpacked weights' against them), the other routes
# generate and synthesize Q4KM_ROUTE_TOKENS (their greedy tokens compared
# with the default route's; cut from 32 for the smoke's time when phase 24
# came), and only Q4KM_PROFILED are profiled (the profiler's processing
# grows with every launch it records)
Q4KM_AGREE_TOKENS = 32
Q4KM_ROUTE_TOKENS = 16
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
# streaming (phases 19-20)
STREAM_TOL = 1e-4          # fused vs unfused PCM
STREAM_OFFLINE_TOL = 1e-6  # a skip-llm stream (one emit) vs the offline
                           # decode; the pipelined-codec vs the unfused path
STREAM_WINDOW = 64         # phase 19's window mode (stream_window_codes)
STREAM_TRACE_TOKENS = 60   # the traced stream: the first commit (40 codes)
                           # and the final flush
BF16_REF_TOL = 2e-2            # GPU vs CPU in bf16 (groupdot)
# speculative decoding (phase 21): bench_spec.py's defaults (the 0.1B-Q8_0
# draft, k = 6) on the 2.6B-Q4_K_M target; the verify runs K1 at M = k + 1
SPEC_K = 6
SPEC_MS = (2, 4, 7)            # M = k + 1 at k = 1, 3, 6
SPEC_PARITY_KS = (1, 3, 6)     # f32 greedy parity with plain decoding
# token counts cut for the phase's time (150 s budgeted): the bf16 run and
# each forced acceptance at 128 tokens took 202 s on the H100, at 64 and
# 64 169 s, at 64 and 32 151 s; when phase 24 came (the whole run took
# 851.6 s on a host at phase 3's 45.6 tok/s, 995.1 s at 26.8) the parity
# runs went from 32 to 16 tokens, the bf16 run from 48 to 32 and the
# forced runs from 32 to 16 (the stream keeps 48: a commit before its
# final flush)
SPEC_PARITY_TOKENS = 16
SPEC_TOKENS = 32               # the bf16 run
SPEC_FORCED_TOKENS = 16        # each forced acceptance
SPEC_FORCE_P = (0.0, 0.5, 0.8, 1.0)
SPEC_SELF_K = 4                # the 0.1B drafting for itself
SPEC_STREAM_TOKENS = 48        # the f32 stream; the CLI's budget
SPEC_TIE_TOL = BF16_REF_TOL    # bf16: where spec and plain part, the plain
                               # path's top two logits (of the logit scale)
# phases 22-23: codec_fast against exact audio, relative RMS: TF32 (a 10-bit
# mantissa) in the codec's matmuls and convolutions, inside the JAX
# package's bf16-input fast mode (~1e-3 relative by its own account)
FAST_RMS_TOL = 1e-2
# GPU vs CPU over an int8 KV cache (f32 activations): the two paths' k / v
# differ by ~1e-6 before quantization, so a value at a rounding tie lands
# one int8 step (1 / 127 of its row's amax) apart; such a step moves a
# score or a value column by under 1 % of its scale, and the logits stay
# within that of theirs (the f32 cache's paths agree to REF_TOL)
INT8_KV_REF_TOL = 1e-2
# phase 24: the switches on loaded engines, the codec's debug surface
SWITCH_TOKENS = 32         # NO_PACK4's default route; each f32 parity
SWITCH_ROUTE_TOKENS = 16   # NO_PACK4 under w8a8 and under split
SWITCH_BF16_TOKENS = 64    # the 0.1B's bf16 runs under xla and nocat
SWITCH_STEPS = 8           # the 2.6B f32 logits: prefill + 8 decode steps
NOCAT_TOL = 1e-5           # f32 logits, nocat vs cat: the softmax's sums
WARMUP_CODES = 32          # warmup's max_codes under WARMUP_VERBOSE
DEBUG_CODES = 16           # the codec's debug surface
AUDIO_TOL = 1e-6           # codec_decode_audio vs the engine's decode: the
                           # same operations on the same inputs


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
    return kernel_rows(torch, qmat, shape_cases(torch, qmat, gen), gen, card)


def kernel_rows(torch, qmat, cases, gen, card: str) -> list[dict]:
    """K1 (`qdot`) against `qdot_plain` for each (label, QTensor, Ms) case:
    f32 x within 1e-5 and bf16 x within 1e-2, a second call bit for bit,
    and the kernel / eager / plain / library / bound times of the bf16
    call."""
    rows = []
    for label, qt, ms_list in cases:
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
    against its plain version (K7 bit for bit, K8 within 1e-6) on its plan
    and on one rank / one split (the parent's decomposition), a second call
    bit for bit, each timed over copies larger than the L2, beside the
    kernel it floors: K8 beside K1 at M = 1 (bf16 x) on the same copies, K7
    beside K5 (phase 10) and K6 (phase 6) at the same shape (bf16 cache).
    Fails if a probe streams faster than PROBE_MAX_RATE."""
    from miotts_tpu_torch.ops import decode_attn as da
    sms = qmat._sm_count(torch.device("cuda"))
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
        plan = qmat._gemv_plan(K, N, 32, sms)
        one = qmat.GemvPlan(splits=1, k_split=K)
        got = qmat.qdot_dma_floor(qt)
        again = qmat.qdot_dma_floor(qt)
        got1 = qmat.qdot_dma_floor(qt, one)
        want = qmat.qdot_dma_floor_plain(qt)
        torch.cuda.synchronize()
        e, e1 = rel_err(got, want), rel_err(got1, want)
        if got.shape != (1, N) or not (e < PROBE_TOL and e1 < PROBE_TOL):
            raise AssertionError(f"K8 {label}: kernel vs plain rel err {e} "
                                 f"({plan.splits} splits), {e1} (one)")
        if not torch.equal(got, again):
            raise AssertionError(f"K8 {label}: a second call differs")
        streamed = qt.values.numel() + qt.scales.numel() * 4
        n_copies = max(2, min(256, -(-L2_FLUSH_BYTES // streamed)))
        qts = copies_of(torch, qmat, qt, n_copies)
        x = torch.randn((1, K), generator=gen, device="cuda").bfloat16()
        n_graph = max(20, min(256, n_copies))
        p_ms = graph_ms(torch, lambda i: qmat.qdot_dma_floor(
            qts[i % n_copies]), n_graph)
        one_ms = graph_ms(torch, lambda i: qmat.qdot_dma_floor(
            qts[i % n_copies], one), n_graph)
        plain_ms = graph_ms(torch, lambda i: qmat.qdot_dma_floor_plain(
            qts[i % n_copies]), 10)
        k1_ms = graph_ms(torch, lambda i: qmat._qdot_cuda(
            x, qts[i % n_copies]), n_graph)
        nbytes = streamed + 4 * N
        k1_bytes = qt_bytes(qt) + 2 * K + 2 * N
        rate = check_rate("K8", label, nbytes, p_ms)
        check_rate("K8 one split", label, nbytes, one_ms)
        row = dict(shape=label, K=K, N=N, bytes=nbytes, splits=plan.splits,
                   ms=p_ms, one_ms=one_ms, plain_ms=plain_ms,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, gb_s=rate / 1e9,
                   one_gb_s=nbytes / (one_ms * 1e-3) / 1e9, k1_ms=k1_ms,
                   k1_bytes=k1_bytes, k1_gb_s=k1_bytes / (k1_ms * 1e-3) / 1e9,
                   max_abs_err=float((got - want).abs().max()), rel_err=e,
                   rel_err_one=e1)
        k8_rows.append(row)
        log(f"K8 {label:26s} K={K:<5d} N={N:<6d} probe {p_ms:.4f} ms "
            f"({row['gb_s']:.1f} GB/s, {plan.splits} splits; one split "
            f"{one_ms:.4f} ms)  plain {plain_ms:.4f} ms  bound "
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
    one = da.AttnPlan(ranks=1)
    for key, k, v in k7_cases:
        label, B, H, H_kv, D, S = key
        plan = da._single_plan(B, H_kv, S, sms)
        got = da.dma_floor(k, v)
        again = da.dma_floor(k, v)
        got1 = da.dma_floor(k, v, one)
        want = da.dma_floor_plain(k, v)
        torch.cuda.synchronize()
        for name, out in (("plan", got), ("second call", again),
                          ("one rank", got1)):
            if not torch.equal(out, want):
                raise AssertionError(
                    f"K7 {key}: kernel ({name}) differs from plain (max "
                    f"{float((out - want).abs().max())})")
        s_tile = min(S, 512)
        streamed = 2 * B * H_kv * (S // s_tile) * s_tile * D * k.element_size()
        n_copies = max(2, min(512, -(-L2_FLUSH_BYTES // streamed)))
        copies = [(k, v)] + [(k.clone(), v.clone())
                             for _ in range(n_copies - 1)]
        n_graph = max(20, n_copies)
        p_ms = graph_ms(torch, lambda i: da.dma_floor(
            *copies[i % n_copies]), n_graph)
        one_ms = graph_ms(torch, lambda i: da.dma_floor(
            *copies[i % n_copies], one), n_graph)
        plain_ms = graph_ms(torch, lambda i: da.dma_floor_plain(
            *copies[i % n_copies]), 4)
        nbytes = streamed + B * H_kv * 8 * D * 4
        rate = check_rate("K7", key, nbytes, p_ms)
        check_rate("K7 one rank", key, nbytes, one_ms)
        row = dict(shape=label, B=B, H=H, H_kv=H_kv, D=D, S=S, bytes=nbytes,
                   ranks=plan.ranks, ms=p_ms, one_ms=one_ms,
                   plain_ms=plain_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   gb_s=rate / 1e9, one_gb_s=nbytes / (one_ms * 1e-3) / 1e9,
                   k5=beside(k5_rows, key), k6=beside(attn_rows, key),
                   max_abs_err=0.0)
        k7_rows.append(row)
        near = "  ".join(f"| {n} {r['ms']:.4f} ms ({r['gb_s']:.1f} GB/s)"
                         for n, r in (("K5", row["k5"]), ("K6", row["k6"]))
                         if r is not None)
        log(f"K7 {label} B={B:<3d} H_kv={H_kv} D={D} S={S:<4d} probe "
            f"{p_ms:.4f} ms ({row['gb_s']:.1f} GB/s, {plan.ranks} ranks; one "
            f"rank {one_ms:.4f} ms)  plain {plain_ms:.4f} ms  bound "
            f"{row['bound_ms']:.5f} ms  {near}  [{card}]")
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
    from miotts_tpu_torch.runtime.profile import StreamProfile
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
    prof = StreamProfile()
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
    n_codes = prof.decoded_codes
    if not (np.isfinite(audio).all() and sr == eng.sample_rate
            and audio.size == n_codes * eng.samples_per_token):
        raise AssertionError(f"bad WAV: {audio.size} samples at {sr} Hz for "
                             f"{n_codes} codes")
    peak = float(np.max(np.abs(audio)))
    if abs(peak - 0.95) > 1e-3:
        raise AssertionError(f"peak {peak} != 0.95")
    want = QDOT_PER_STEP * (1 + prof.decode_steps)
    if launches != want:
        raise AssertionError(f"qdot kernel launches {launches} != {want} "
                             f"(49 per decode step + 49 for the prefill)")
    audio_s = audio.size / sr
    res = dict(prefill_ms=prof.prefill_sec * 1e3,
               decode_tok_s=prof.decode_steps / prof.llm_sec,
               decode_steps=prof.decode_steps, llm_tokens=prof.llm_tokens,
               n_codes=n_codes, codec_istft_s=prof.codec_sec + prof.istft_sec,
               audio_s=audio_s, wall_s=wall, x_realtime=audio_s / wall,
               qdot_launches=launches, k5_launches=k5,
               tokens=list(prof.token_ids))
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
    res["engine"], res["voice"] = eng, voice    # phase 23 (a); popped
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
                   label: str = f"prefill + {PROFILE_DECODE_STEPS} decode "
                                f"steps") -> dict:
    """Where one generate_tokens call (prefill + one PROFILE_DECODE_STEPS
    chunk) spends its time."""
    opts = Options(temperature=0.0, max_tokens=PROFILE_DECODE_STEPS)
    eng.generate_tokens(text, opts)

    def run():
        eng.generate_tokens(text, opts)
        return PROFILE_DECODE_STEPS + 1
    return device_profile(torch, run, label, card)


# ---------------------------------------------------------------------------
# Phase 7/8/9: batched serving, GPU vs CPU chunk, HTTP
# ---------------------------------------------------------------------------

def serve_requests(torch, batcher, voice, n_req: int, Options,
                   keep: bool = False) -> dict:
    """Submit n_req requests (bench_batch.py's mix) and run to completion;
    checks every request's audio and the launches: K6 once per attention
    layer and the quantized linears 4 per layer plus the head per batched
    step (also per prefill wave), through K1, or through K1v alone where
    the engine's route is MIOTTS_QDOT_BF16 on bf16 activations; K5 never.
    Returns the run's numbers; with `keep`, also "per_request": {i: codes,
    n_tokens, pcm, and whether the last callback was is_last with
    samples} (not JSON: pop it before the details line)."""
    import numpy as np
    from miotts_tpu_torch.ops import decode_attn, qmat
    eng = batcher.engine
    k1v_route = bool(eng.config.qdot_route.bf16) and eng.dtype == torch.bfloat16
    i16 = eng.config.serving_i16_transfer and not batcher.use_fused
    cfg = batcher.engine.llm_cfg
    attn_layers = len(cfg.attn_layer_idx)
    qdot_per_step = 4 * cfg.n_layers + 1
    spt = batcher.engine.samples_per_token
    sr = batcher.engine.sample_rate
    got = {i: {"samples": 0, "finite": True, "peak": 0.0, "final": False,
               "req": None, "pcm": [], "last": None} for i in range(n_req)}

    def make_cb(i):
        def cb(samples, rate, is_last):
            if samples is not None and len(samples):
                a = np.asarray(samples)
                got[i]["samples"] += a.size
                got[i]["finite"] &= bool(np.isfinite(a).all())
                got[i]["peak"] = max(got[i]["peak"], float(np.abs(a).max()))
                if keep:
                    got[i]["pcm"].append(a.astype(np.float32))
            got[i]["final"] |= bool(is_last)
            got[i]["last"] = (samples is not None and len(samples) > 0
                              and bool(is_last))
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
        # the int16 wire format decodes -32768 to -32768 / 32767 (f32
        # slices, and the fused path's, are not clamped)
        if not g["finite"] or (i16 and g["peak"] > 32768 / 32767):
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
    extra = {}
    if keep:
        extra["per_request"] = {
            i: dict(codes=list(g["req"].codes), n_tokens=g["req"].n_tokens,
                    pcm=(np.concatenate(g["pcm"]) if g["pcm"]
                         else np.zeros(0, np.float32)),
                    last_with_samples=g["last"])
            for i, g in got.items()}
    return dict(extra, n_req=n_req, wall_s=wall, audio_s=audio_s,
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
        res = serve_requests(torch, batcher, voice, n_req, Options,
                             keep=tag == "bf16")
        if tag == "bf16":
            out["bf16_requests"] = res.pop("per_request")
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
    # where a serving run's time goes: 64 requests x PROFILE_TOKENS, bf16
    # cache
    batcher = ContinuousBatcher(eng, n_slots=SLOTS, chunk_steps=CHUNK)
    batcher.warmup(prompt_len=16)

    def run():
        for i in range(SLOTS):
            batcher.submit(f"profiled utterance number {i}", voice,
                           lambda *a: True,
                           Options(max_tokens=PROFILE_TOKENS, temperature=0.8,
                                   seed=i))
        batcher.run_until_done(max_iters=1000)
        return batcher.stage["device_steps"]
    out["profile"] = device_profile(torch, run,
                                    f"serving 64 x {PROFILE_TOKENS} tokens",
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
    from miotts_tpu_torch.runtime.profile import StreamProfile
    t0 = time.perf_counter()
    eng = TTSEngine(EngineConfig(model_path=paths["lfm2"],
                                 codec_path=paths["codec"], device="cuda",
                                 max_tokens=MAX_TOKENS, temperature=0.0))
    voice = VoiceModel(paths["voice"])
    log(f"lfm2: engine load {time.perf_counter() - t0:.2f} s")
    text = "The quick brown fox jumps over the lazy dog."
    eng.synthesize(voice, text, Options(temperature=0.0, max_tokens=8))

    wav = os.path.join(out_dir, "lfm2.wav")
    prof = StreamProfile()
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
    n_codes = prof.decoded_codes
    if not (np.isfinite(audio).all() and sr == eng.sample_rate
            and audio.size == n_codes * eng.samples_per_token
            and abs(float(np.max(np.abs(audio))) - 0.95) < 1e-3):
        raise AssertionError(f"lfm2: bad WAV, {audio.size} samples at {sr} "
                             f"Hz for {n_codes} codes")
    steps = prof.decode_steps
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
    res = dict(prefill_ms=prof.prefill_sec * 1e3,
               decode_tok_s=steps / prof.llm_sec, decode_steps=steps,
               llm_tokens=prof.llm_tokens, n_codes=n_codes,
               codec_istft_s=prof.codec_sec + prof.istft_sec, audio_s=audio_s,
               wall_s=wall, x_realtime=audio_s / wall, qdot_launches=qd,
               k5_launches=k5, tokens=list(prof.token_ids))
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
    res["profile"] = profile_decode(
        torch, eng, text, Options, card,
        f"lfm2 prefill + {PROFILE_DECODE_STEPS} decode steps")
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

    # where a batched LFM2 step's time goes: 16 requests x PROFILE_TOKENS
    def run():
        steps0 = batcher.stage["device_steps"]
        for i in range(LFM2_SLOTS):
            batcher.submit(f"profiled utterance number {i}", voice,
                           lambda *a: True,
                           Options(max_tokens=PROFILE_TOKENS, temperature=0.8,
                                   seed=i))
        batcher.run_until_done(max_iters=1000)
        return batcher.stage["device_steps"] - steps0
    res["profile"] = device_profile(torch, run, f"lfm2 serving 16 x "
                                    f"{PROFILE_TOKENS} tokens",
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
                           Options(max_tokens=PROFILE_TOKENS, temperature=0.8,
                                   seed=i))
        batcher.run_until_done(max_iters=1000)
        return batcher.stage["device_steps"] - steps0
    res["profile"] = device_profile(
        torch, run, f"lfm2 serving (after) 16 x {PROFILE_TOKENS} tokens",
        card)
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
# Phases 19-20: streaming synthesis (0.1B-Q8_0, LFM2-1.2B-Q8_0)
# ---------------------------------------------------------------------------

def stream_run(torch, eng, voice, text, opts, cb_ok=True, **cfg) -> dict:
    """One synthesize_stream with `cfg` set on the engine's config (and
    restored): its PCM, (n_samples, is_last) events, profile, result and
    wall time.  With cb_ok False every callback returns False (an abort)."""
    import numpy as np
    from miotts_tpu_torch.runtime.profile import StreamProfile
    saved = {k: getattr(eng.config, k) for k in cfg}
    chunks, events = [], []

    def cb(samples, sr, is_last):
        events.append((0 if samples is None else len(samples), is_last))
        if samples is not None:
            chunks.append(samples.copy())
        return cb_ok

    prof = StreamProfile()
    try:
        for k, v in cfg.items():
            setattr(eng.config, k, v)
        t0 = time.perf_counter()
        ok = eng.synthesize_stream(voice, text, cb, options=opts, profile=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            setattr(eng.config, k, v)
    pcm = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    return dict(pcm=pcm, events=events, profile=prof, ok=ok, wall=wall)


def stream_numbers(eng, run: dict) -> dict:
    """A run's stream_bench.* numbers, the stage split after
    attribute_stages, and its decode buckets."""
    prof = run["profile"]
    eng.attribute_stages(prof)
    m = prof.as_metrics(run["pcm"].size / eng.sample_rate)
    out = {k[len("stream_bench."):]: v for k, v in m.items()}
    out.update(stages_trusted=prof.stages_trusted,
               decode_bucket_codes=list(prof.decode_bucket_codes),
               decode_steps=prof.decode_steps, wall_s=run["wall"])
    return out


def log_stream(label: str, name: str, num: dict, card: str) -> None:
    total = max(num["total_sec"], 1e-12)
    stages = ", ".join(
        f"{k[6:-4]} {num[k]:.4f} s ({100 * num[k] / total:.1f}%)"
        for k in ("stage.prefill_sec", "stage.llm_sec", "stage.codec_sec",
                  "stage.istft_sec", "stage.callback_sec") if k in num)
    log(f"{label}[{name}]: first_audio_sec {num.get('first_audio_sec', -1):.4f}"
        f", x_realtime {num['x_realtime']:.4f}, total {num['total_sec']:.4f} "
        f"s, {num['llm_tokens']} tokens, decode_calls {num['decode_calls']}, "
        f"decoded_codes {num['decoded_codes']} (buckets "
        f"{num['decode_bucket_codes']}); stages: {stages}  [{card}]")


def check_stream(label: str, name: str, run: dict, offline: list) -> None:
    """Every stream: True, the offline path's tokens, the last sample out
    with is_last."""
    prof, ev = run["profile"], run["events"]
    if not run["ok"] or not ev or not ev[-1][1] or not ev[-1][0]:
        raise AssertionError(f"{label}[{name}]: ok {run['ok']}, last events "
                             f"{ev[-3:]} (the last sample must go out with "
                             f"is_last)")
    if prof.token_ids != offline:
        raise AssertionError(f"{label}[{name}]: {len(prof.token_ids)} tokens "
                             f"differ from the offline path's {len(offline)}")


def same_stream(label: str, a: str, b: str, runs: dict, tol: float) -> float:
    """Two runs of one stream: the same events and decode counts, PCM
    within `tol` (0: bit for bit).  Returns the max difference."""
    import numpy as np
    ra, rb = runs[a], runs[b]
    pa, pb = ra["profile"], rb["profile"]
    if (ra["events"] != rb["events"]
            or (pa.decode_calls, pa.decoded_codes)
            != (pb.decode_calls, pb.decoded_codes)
            or ra["pcm"].shape != rb["pcm"].shape):
        raise AssertionError(f"{label}: {a} and {b} differ in their emit "
                             f"schedule or decodes")
    err = float(np.max(np.abs(ra["pcm"] - rb["pcm"]))) if ra["pcm"].size else 0.0
    log(f"{label}: {a} vs {b}: the same {len(ra['events'])} callbacks and "
        f"{pa.decode_calls} decodes, PCM max |diff| {err:.3e} (tol {tol})")
    if err > tol:
        raise AssertionError(f"{label}: {a} vs {b} PCM differ by {err}")
    return err


def launches_of(torch, fn) -> int:
    """The kernels the host launches in fn(), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))


def queue_wait_s(torch, n: int) -> float:
    """Host seconds to enqueue n one-element kernels behind a 1e9-cycle
    spin (0.5 s at the H100's 1.98 GHz peak clock): about 0 while the
    launch queue has room for them, about the spin once it has not."""
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt


def trace_busy(path: str, wall: float) -> dict:
    """The device's busy time in a Chrome trace (the union of its kernel,
    copy and set intervals) over the traced run's wall time."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(device_busy_s=busy * 1e-6, wall_s=wall,
                busy_share=busy * 1e-6 / wall if wall else None,
                device_events=len(spans))


def phase_stream_0p1b(torch, qmat, paths: dict, d: str, card: str,
                      phase3_tokens=None) -> dict:
    """0.1B-Q8_0 streaming on phase 3's files and prompt at temperature 0:
    warmup; the fused path at depth 1 and 2, the unfused and pipelined-
    codec paths, the window mode; the skip-llm stream against the offline
    decode; an abort with steps in flight; `cli bench`, `cli compare` and
    `cli stream -o FILE` in process; a traced fused stream."""
    import io
    import numpy as np
    from miotts_tpu_torch import cli
    from miotts_tpu_torch.audio.wav import f32_to_s16
    from miotts_tpu_torch.ops import decode_attn
    from miotts_tpu_torch.runtime.engine import (EngineConfig, Options,
                                                 TTSEngine, VoiceModel)
    from miotts_tpu_torch.runtime.profile import device_trace
    from miotts_tpu_torch.text import (build_prompt, format_speech_tokens,
                                       normalize_tts_text)
    label = "stream"
    t0 = time.perf_counter()
    eng = TTSEngine(EngineConfig(model_path=paths["llm"],
                                 codec_path=paths["codec"], device="cuda",
                                 max_tokens=MAX_TOKENS, temperature=0.0))
    voice = VoiceModel(paths["voice"])
    text = "The quick brown fox jumps over the lazy dog."
    opts = Options(temperature=0.0, max_tokens=MAX_TOKENS)
    n_prompt = len(eng.tokenizer.encode(build_prompt(normalize_tts_text(text)),
                                        add_special=True, parse_special=True))
    t1 = time.perf_counter()
    eng.warmup(max_codes=MAX_TOKENS, prompt_len=n_prompt)
    torch.cuda.synchronize()
    res = dict(load_s=t1 - t0, warmup_s=time.perf_counter() - t1)
    offline = eng.generate_tokens(text, opts)
    if phase3_tokens is not None and offline != phase3_tokens:
        raise AssertionError(f"{label}: generate_tokens gave other tokens "
                             f"than phase 3's synthesize")
    codes = eng.tokens_to_codes(offline)
    off_pcm = eng.decode_codes(codes, voice, apply_peak_normalization=False)
    log(f"{label}: engine load {res['load_s']:.2f} s, warmup "
        f"{res['warmup_s']:.2f} s; offline {len(offline)} tokens, "
        f"{len(codes)} codes")

    runs, nums = {}, {}
    for name, cfg in (("fused_depth1", dict(stream_pipeline_depth=1)),
                      ("fused_depth2", {}),
                      ("unfused", dict(fused_streaming=False)),
                      ("pipelined_codec", dict(pipeline_codec=True)),
                      ("window", dict(stream_window_codes=STREAM_WINDOW))):
        qmat.qdot.kernel_launches = 0
        decode_attn.decode_attention.kernel_launches = 0
        r = runs[name] = stream_run(torch, eng, voice, text, opts, **cfg)
        r["qdot_launches"] = qmat.qdot.kernel_launches
        k5 = decode_attn.decode_attention.kernel_launches
        check_stream(label, name, r, offline)
        want = QDOT_PER_STEP * (1 + r["profile"].decode_steps)
        if r["qdot_launches"] != want or k5:
            raise AssertionError(f"{label}[{name}]: qdot launches "
                                 f"{r['qdot_launches']} != {want} (49 x (1 + "
                                 f"{r['profile'].decode_steps} steps)), K5 {k5}")
        nums[name] = stream_numbers(eng, r)
        nums[name]["qdot_launches"] = r["qdot_launches"]
        log_stream(label, name, nums[name], card)
        log(f"{label}[{name}]: launches qdot {r['qdot_launches']} "
            f"({QDOT_PER_STEP} x (1 + {r['profile'].decode_steps})), K5 0")
    res["runs"] = nums
    res["max_abs_diff"] = {
        "fused_vs_unfused": same_stream(label, "fused_depth2", "unfused",
                                        runs, STREAM_TOL),
        "depth1_vs_depth2": same_stream(label, "fused_depth1",
                                        "fused_depth2", runs, 0.0),
        "pipelined_vs_unfused": same_stream(label, "pipelined_codec",
                                            "unfused", runs,
                                            STREAM_OFFLINE_TOL)}
    full, win = runs["fused_depth2"], runs["window"]
    if ([e[0] for e in win["events"]] != [e[0] for e in full["events"]]
            or win["profile"].decode_calls != full["profile"].decode_calls
            or win["profile"].decoded_codes > full["profile"].decoded_codes):
        raise AssertionError(f"{label}: the window mode's commit schedule "
                             f"differs from the full re-decode's")
    res["max_abs_diff"]["window_vs_full"] = float(
        np.max(np.abs(win["pcm"] - full["pcm"])))
    log(f"{label}: window {STREAM_WINDOW} vs full re-decode: the same "
        f"schedule, PCM max |diff| {res['max_abs_diff']['window_vs_full']:.3e}"
        f" (peak {float(np.max(np.abs(full['pcm']))):.3e}; decode buckets "
        f"{win['profile'].decode_bucket_codes} in window mode, "
        f"{full['profile'].decode_bucket_codes} in full mode)")

    # skip-llm: one decode, one emit, nothing blended
    r = stream_run(torch, eng, voice, format_speech_tokens(codes),
                   Options(skip_llm=True))
    err = (float(np.max(np.abs(r["pcm"] - off_pcm)))
           if r["pcm"].shape == off_pcm.shape else float("inf"))
    log(f"{label}: skip-llm stream of the {len(codes)} offline codes vs their "
        f"offline decode: max |diff| {err:.3e} (tol {STREAM_OFFLINE_TOL})")
    if not (r["ok"] and r["events"][-1][1] and err <= STREAM_OFFLINE_TOL):
        raise AssertionError(f"{label}: skip-llm stream differs from the "
                             f"offline decode ({err})")
    res["max_abs_diff"]["skip_llm_vs_offline"] = err

    # decode_codes_async enqueues and returns without a host sync: PyTorch's
    # sync debug mode raises on any call in it that waits for the device (a
    # blocking copy, .item(), a synchronize); the decode read later equals
    # decode_codes' bit for bit.  Whether the stream is still busy when it
    # returns says nothing here: one decode launches more kernels than the
    # card's launch queue holds, so behind a long kernel the host waits for
    # room in the queue (the probe below), not for a sync
    n_launch = launches_of(torch, lambda: eng.decode_codes_async(codes, voice))
    wait = {n: queue_wait_s(torch, n) for n in (256, 4096)}
    log(f"{label}: one decode_codes_async launches {n_launch} kernels; "
        f"behind a 1e9-cycle spin the host enqueues 256 tiny kernels in "
        f"{wait[256]:.4f} s and 4096 in {wait[4096]:.4f} s (the launch "
        f"queue's back-pressure)  [{card}]")
    res["decode_async"] = dict(launches=n_launch, queue_wait_s=wait)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        audio_dev, n_dec = eng.decode_codes_async(codes, voice)
    except RuntimeError as e:
        raise AssertionError(f"{label}: decode_codes_async waited for the "
                             f"device: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = audio_dev[:n_dec * eng.samples_per_token].cpu().numpy()
    same = bool(got.shape == off_pcm.shape and np.array_equal(got, off_pcm))
    log(f"{label}: decode_codes_async made no synchronizing call; its decode "
        f"{'equals' if same else 'DIFFERS from'} decode_codes'")
    if not same:
        raise AssertionError(f"{label}: decode_codes_async decoded other "
                             f"samples than decode_codes")

    # an abort at the first emit, two chunks still in flight
    r = stream_run(torch, eng, voice, text, opts, cb_ok=False,
                   stream_pipeline_depth=3)
    log(f"{label}: abort at depth 3: returned {r['ok']}, "
        f"{len(r['events'])} callback(s)")
    if r["ok"] or len(r["events"]) != 1:
        raise AssertionError(f"{label}: an abort gave {len(r['events'])} "
                             f"callbacks (want 1), returned {r['ok']}")

    # the CLI in process (each builds its own engine on the card)
    model = ["-m", paths["llm"], "-c", paths["codec"], "-v", paths["voice"],
             "-p", text, "-t", "0", "--max-tokens", str(MAX_TOKENS)]
    res["cli"] = {}
    for sub in ("bench", "compare"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([sub] + model)
        lines = dict(line.split("=", 1) for line in buf.getvalue().splitlines()
                     if "=" in line)
        res["cli"][sub] = lines
        for k, v in lines.items():
            log(f"{label}: cli {sub}: {k}={v}  [{card}]")
        if rc != 0:
            raise AssertionError(f"{label}: cli {sub} exited {rc}")
    cmp = res["cli"]["compare"]
    n_samples = len(codes) * eng.samples_per_token
    if (int(cmp["compare.offline_samples"]) != n_samples
            or int(cmp["compare.stream_samples"]) != n_samples
            or float(cmp["compare.max_abs"]) > STREAM_OFFLINE_TOL):
        raise AssertionError(f"{label}: cli compare: {cmp}")
    if "stream_bench.first_audio_sec" not in res["cli"]["bench"]:
        raise AssertionError(f"{label}: cli bench printed no first audio")
    pcm_path = os.path.join(d, "stream.pcm")
    if cli.main(["stream"] + model + ["-o", pcm_path]) != 0:
        raise AssertionError(f"{label}: cli stream failed")
    got = np.fromfile(pcm_path, dtype="<i2").astype(np.int32)
    want = f32_to_s16(full["pcm"]).astype(np.int32)
    step = (int(np.max(np.abs(got - want))) if got.size == want.size
            else None)
    log(f"{label}: cli stream -o FILE: {got.size} s16 samples, max |diff| "
        f"{step} s16 steps against the fused stream")
    if step is None or step > 1:
        raise AssertionError(f"{label}: cli stream's PCM differs from the "
                             f"fused stream's")
    res["cli"]["stream_s16_max_step"] = step

    # where a fused stream's time goes: a Chrome trace of a shorter stream
    # (the prefill, the first commit at 40 codes and the final flush; the
    # profiler's processing grows with every launch it records)
    trace_dir = os.path.join(d, "stream_trace")
    with device_trace(trace_dir):
        r = stream_run(torch, eng, voice, text,
                       Options(temperature=0.0,
                               max_tokens=STREAM_TRACE_TOKENS))
    res["trace"] = trace_busy(os.path.join(trace_dir, "trace.json"),
                              r["wall"])
    res["trace"]["decode_calls"] = r["profile"].decode_calls
    res["trace"]["steps"] = r["profile"].decode_steps
    t = res["trace"]
    log(f"{label}: traced fused stream of {t['steps']} steps and "
        f"{t['decode_calls']} decodes: wall {t['wall_s']:.4f} s, device busy "
        f"{t['device_busy_s']:.4f} s ({100 * (t['busy_share'] or 0):.1f}%) "
        f"over {t['device_events']} device events  [{card}]")
    return res


def phase_stream_lfm2(torch, eng, voice, card: str, offline: list) -> dict:
    """LFM2-1.2B-Q8_0 streaming on phase 11's engine at temperature 0: the
    fused and the unfused path; phase 11's offline tokens, the same
    schedule, PCM within STREAM_TOL; K5 6 and K1 65 launches a step."""
    from miotts_tpu_torch.ops import decode_attn, qmat
    from miotts_tpu_torch.runtime.engine import Options
    from miotts_tpu_torch.text import build_prompt, normalize_tts_text
    label = "lfm2 stream"
    text = "The quick brown fox jumps over the lazy dog."
    opts = Options(temperature=0.0, max_tokens=MAX_TOKENS)
    t0 = time.perf_counter()
    eng.warmup(max_codes=MAX_TOKENS, prompt_len=len(eng.tokenizer.encode(
        build_prompt(normalize_tts_text(text)), add_special=True,
        parse_special=True)))
    torch.cuda.synchronize()
    res = dict(warmup_s=time.perf_counter() - t0)
    runs, nums = {}, {}
    n_attn = len(LFM2_ATTN_IDX)
    for name, cfg in (("fused_depth2", {}),
                      ("unfused", dict(fused_streaming=False))):
        qmat.qdot.kernel_launches = 0
        decode_attn.decode_attention.kernel_launches = 0
        r = runs[name] = stream_run(torch, eng, voice, text, opts, **cfg)
        qd = qmat.qdot.kernel_launches
        k5 = decode_attn.decode_attention.kernel_launches
        check_stream(label, name, r, offline)
        steps = r["profile"].decode_steps
        if qd != LFM2_QDOT_PER_STEP * (1 + steps) or k5 != n_attn * steps:
            raise AssertionError(f"{label}[{name}]: qdot {qd}, K5 {k5} for 1 "
                                 f"prefill + {steps} steps")
        nums[name] = stream_numbers(eng, r)
        nums[name].update(qdot_launches=qd, k5_launches=k5)
        log_stream(label, name, nums[name], card)
        log(f"{label}[{name}]: launches K5 {k5} ({n_attn} x {steps}), qdot "
            f"{qd} ({LFM2_QDOT_PER_STEP} x (1 + {steps}))")
    res["runs"] = nums
    res["max_abs_diff"] = {"fused_vs_unfused": same_stream(
        label, "fused_depth2", "unfused", runs, STREAM_TOL)}
    return res


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
                       card: str, keep_engine: bool = False) -> dict:
    """2.6B-Q4_K_M text -> WAV on the card under each route: one engine
    loads the weights, one more per route shares them
    (TTSEngine.with_qdot_route).  Checks each WAV and each kernel's
    launches; reports the rates, the device-busy share and each route's
    greedy-token agreement with the default route.  With `keep_engine`,
    the loaded (default-route, bf16) engine is returned as "engine"."""
    import numpy as np
    from miotts_tpu_torch.audio.wav import wav_read
    from miotts_tpu_torch.ops import decode_attn
    from miotts_tpu_torch.runtime.engine import (EngineConfig, Options,
                                                 TTSEngine, VoiceModel)
    from miotts_tpu_torch.runtime.profile import StreamProfile
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
            text, Options(temperature=0.0, max_tokens=(
                Q4KM_AGREE_TOKENS if name == "default"
                else Q4KM_ROUTE_TOKENS)))
        wav = os.path.join(out_dir, f"q4km_{name}.wav")
        prof = StreamProfile()
        reset_counts(counters)
        decode_attn.decode_attention.kernel_launches = 0
        t0 = time.perf_counter()
        eng.synthesize_to_file(voice, text, wav, Options(
            temperature=0.0, max_tokens=(MAX_TOKENS if name == "default"
                                         else Q4KM_ROUTE_TOKENS)),
            profile=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts(counters)
        k5 = decode_attn.decode_attention.kernel_launches
        audio, sr = wav_read(wav)
        n_codes = prof.decoded_codes
        if not (np.isfinite(audio).all() and sr == eng.sample_rate
                and audio.size == n_codes * eng.samples_per_token
                and abs(float(np.max(np.abs(audio))) - 0.95) < 1e-3):
            raise AssertionError(f"q4km[{name}]: bad WAV, {audio.size} "
                                 f"samples at {sr} Hz for {n_codes} codes")
        steps = prof.decode_steps
        want = expected_counts(name, steps, 2 * Q4KM_LAYERS,
                               2 * Q4KM_LAYERS + 1)
        if got != want or k5:
            raise AssertionError(f"q4km[{name}]: launches {got} (K5 {k5}) "
                                 f"!= {want} for 1 prefill + {steps} steps")
        same = sum(a == b for a, b in zip(tokens[name], tokens["default"]))
        compared = min(len(tokens[name]), len(tokens["default"]))
        audio_s = audio.size / sr
        res = dict(route=env, prefill_ms=prof.prefill_sec * 1e3,
                   decode_tok_s=steps / prof.llm_sec,
                   decode_steps=steps, llm_tokens=prof.llm_tokens,
                   n_codes=n_codes,
                   codec_istft_s=prof.codec_sec + prof.istft_sec,
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
            torch, eng, card,
            f"q4km[{name}] prefill + {Q4KM_PROFILE_STEPS} steps")
            if name in Q4KM_PROFILED else None)
        if name == "default":      # phase 24's unpacked weights against them
            res["token_ids"] = tokens[name]
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
    if keep_engine:
        out["engine"] = base
    del base
    torch.cuda.empty_cache()
    return out


def profile_steps(torch, eng, card: str, label: str,
                  n_steps: int = Q4KM_PROFILE_STEPS):
    """Where a prefill (a 64-token bucket) and an n_steps decode chunk of
    the engine's model spend their time: a shorter window than
    profile_decode's, because the profiler's own processing grows with
    every launch it records (~2900 per step at 2.6B)."""
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


# ---------------------------------------------------------------------------
# Phase 21: speculative decoding, the 2.6B-Q4_K_M target with the 0.1B-Q8_0
# draft
# ---------------------------------------------------------------------------

def engine_variant(eng, **config):
    """Another engine over `eng`'s loaded weights, codec and tokenizer
    (shared, not copied) with `config`'s fields replaced and KV caches of
    its own.  A test harness's shortcut, for the fields that need no new
    load (quantized_kv, i16_transfer, llm_dtype with f32_engine's
    parameters); codec_fast / codec_device: codec_variant."""
    import copy
    v = copy.copy(eng)
    v.config = dataclasses.replace(eng.config, **config)
    v._cache = v._dcache = v._spec_stats = None
    return v


def codec_variant(torch, eng, fast: bool = False, stream: bool = False):
    """engine_variant with the codec's fast mode (what TTSEngine does for
    codec_fast) or its decodes on a CUDA stream of their own on the same
    card (what it does for codec_device=0 on one GPU)."""
    v = engine_variant(eng, codec_fast=fast, codec_device=0 if stream else -1)
    if fast:
        v.codec_cfg = dataclasses.replace(eng.codec_cfg, fast=True)
    if stream:
        v.codec_device = torch.device("cuda", 0)
        v._codec_stream = torch.cuda.Stream(v.codec_device)
    return v


def f32_engine(torch, base, path: str, **config):
    """An f32 engine over the bf16 engine `base`'s QTensors: a quantized
    weight takes no dtype (models/llm._load_matrix), and the norms and
    biases load in f32 whatever the dtype, so only `token_embd` (and a
    dense output head) is read again, in f32, from `path`; a dense matrix
    in a block (none in the 2.6B-Q4_K_M file) fails here.  Takes phase 21's 2.6B f32 target from
    a 35-51 s load (PR 15) to the embedding's few seconds."""
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.ops.qmat import QTensor

    def check(tree, where):
        if isinstance(tree, dict):
            for k, v in tree.items():
                check(v, f"{where}.{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                check(v, f"{where}[{i}]")
        elif not isinstance(tree, QTensor) and tree.dtype != torch.float32:
            raise AssertionError(f"f32_engine: {where} is a dense "
                                 f"{tree.dtype} tensor: read it again too")

    params = dict(base.llm_params)
    dense = ["token_embd"] + [k for k in ("output",) if k in params and
                              not isinstance(params[k], QTensor)]
    with GGUFReader(path) as r:
        for k in dense:
            params[k] = torch.from_numpy(r.tensor_f32(f"{k}.weight")).to(
                base.device, torch.float32)
    check({k: v for k, v in params.items() if k not in dense}, "params")
    eng = engine_variant(base, llm_dtype="float32", **config)
    eng.dtype = torch.float32
    eng.llm_params = params
    eng.draft_params = eng.draft_cfg = None
    return eng


def prompt_ids(eng, text: str) -> list:
    """The engine's prompt token ids of `text`."""
    from miotts_tpu_torch.text import build_prompt, normalize_tts_text
    return eng.tokenizer.encode(build_prompt(normalize_tts_text(text)),
                                add_special=True, parse_special=True)


def prefilled(torch, eng, ids: list, s_max: int, draft: bool = False):
    """(last logits, cache of s_max positions) of the target's (or the
    draft's) prefill of `ids` on the card, in the engine's dtype."""
    from miotts_tpu_torch.models.llm import init_kv_cache, llm_prefill
    params, cfg = ((eng.draft_params, eng.draft_cfg) if draft
                   else (eng.llm_params, eng.llm_cfg))
    cache = init_kv_cache(cfg, 1, s_max, dtype=eng.dtype, device="cuda")
    return llm_prefill(params, torch.tensor([ids], device="cuda"),
                       torch.tensor([len(ids)]), cache, cfg)


def top2_gap(torch, eng, text: str, prefix: list) -> dict:
    """The plain path's top two next-token logits after the prompt of
    `text` and `prefix`, read from one target forward over both (a
    prefill), and their gap over the logit scale (max |logit|)."""
    ids = prompt_ids(eng, text) + [int(t) for t in prefix]
    last = prefilled(torch, eng, ids, len(ids))[0]
    top = last[0].topk(2)
    return dict(top2=top.indices.tolist(), top2_logits=top.values.tolist(),
                gap=float((top.values[0] - top.values[1])
                          / last[0].abs().max()))


def near_tie(torch, eng, text: str, plain: list, spec: list,
             label: str) -> dict:
    """Where the tokens `spec` of another path (speculative decoding, an
    unpacked weight's sums) first part from plain greedy decoding `plain`
    (None when they never do): there the plain path's top two logits must
    lie within SPEC_TIE_TOL of the logit scale (bf16: the sums run in
    another order); a wider gap is a fault.  `label` prefixes the log."""
    i = next((j for j, (a, b) in enumerate(zip(plain, spec)) if a != b),
             None if len(plain) == len(spec) else min(len(plain), len(spec)))
    if i is None:
        return dict(first_divergence=None)
    out = dict(first_divergence=i,
               plain_token=plain[i] if i < len(plain) else None,
               spec_token=spec[i] if i < len(spec) else None,
               **top2_gap(torch, eng, text, plain[:i]))
    log(f"{label}: first divergence from plain greedy at token {i}: "
        f"plain {out['plain_token']}, other {out['spec_token']}, top two "
        f"{out['top2']} with gap {out['gap']:.3e} of the logit scale (tol "
        f"{SPEC_TIE_TOL})")
    if not out["gap"] <= SPEC_TIE_TOL:
        raise AssertionError(f"{label}: tokens part at {i} where the "
                             f"plain path's top two logits are "
                             f"{out['gap']:.3e} apart (> {SPEC_TIE_TOL})")
    return out


def timed_tokens(eng, text: str, Options, n: int) -> tuple:
    """(tokens, profile) of one greedy generate_tokens of n tokens."""
    from miotts_tpu_torch.runtime.profile import StreamProfile
    prof = StreamProfile()
    toks = eng.generate_tokens(text, Options(temperature=0.0, max_tokens=n),
                               profile=prof)
    return toks, prof


def spec_numbers(eng, toks: list, prof) -> dict:
    st = dict(eng._spec_stats)
    rounds = max(st["rounds"], 1)
    return dict(tokens=len(toks), tok_s=len(toks) / prof.llm_sec,
                llm_sec=prof.llm_sec, prefill_ms=prof.prefill_sec * 1e3,
                device_rounds=prof.decode_steps, **st,
                accept_rate=st["accepted"] / max(st["drafted"], 1),
                round_ms=prof.llm_sec / rounds * 1e3,
                tokens_per_round=(len(toks) - 1) / rounds)


def spec_sync_check(torch, eng, text: str) -> dict:
    """One speculative chunk enqueued under PyTorch's sync debug mode: at
    temperature 0 it must make no synchronizing call; at temperature 0.8
    (torch.multinomial's draws) what happens is recorded."""
    from miotts_tpu_torch.models.llm import llm_generate_chunk_spec
    ids = prompt_ids(eng, text)
    k = eng.config.spec_tokens
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for temp in (0.0, 0.8):
        last, cache = prefilled(torch, eng, ids, 256)
        dcache = prefilled(torch, eng, ids, 256, draft=True)[1]
        pending = torch.argmax(last, dim=-1)
        limit = torch.full((), CHUNK, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            llm_generate_chunk_spec(
                eng.llm_params, eng.draft_params, pending, cache, dcache,
                temp, eng._stop_ids, eng.llm_cfg, eng.draft_cfg,
                -(-CHUNK // (k + 1)), k, limit=limit, generator=gen)
            out[str(temp)] = "no synchronizing call"
        except RuntimeError as e:
            if temp == 0.0:
                raise AssertionError(f"spec: a temperature-0 chunk made a "
                                     f"synchronizing call: {e}") from e
            out[str(temp)] = f"raised: {str(e).splitlines()[0]}"
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    # the debug mode "does not yet detect all synchronizing operations":
    # whether torch.multinomial's one draw waits for the device, behind a
    # 1e9-cycle spin (~0.5 s)
    probs = torch.softmax(torch.randn((1, eng.llm_cfg.n_vocab),
                                      device="cuda"), dim=-1)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    t0 = time.perf_counter()
    torch.multinomial(probs, 1, generator=gen)
    out["multinomial_host_s_behind_spin"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    log(f"spec: one chunk under sync debug mode 'error': temperature 0: "
        f"{out['0.0']}; temperature 0.8: {out['0.8']}; one "
        f"torch.multinomial draw behind a ~0.5 s spin returned after "
        f"{out['multinomial_host_s_behind_spin']:.4f} s")
    return out


def round_breakdown(torch, eng, text: str, card: str, reps: int = 5) -> dict:
    """Where a speculative round's time goes (k = spec_tokens): the host
    time of one call (the mean of `reps` calls, then a synchronize) and
    the kernel launches of one draft step, the verify at M = k + 1 and
    `spec_accept`, beside one plain decode step of the target; then one
    whole round under torch.profiler (device-busy share, launches)."""
    from miotts_tpu_torch.models.llm import (llm_forward,
                                             llm_generate_chunk_spec,
                                             spec_accept)
    ids = prompt_ids(eng, text)
    n, k = len(ids), eng.config.spec_tokens
    cache = prefilled(torch, eng, ids, 256)[1]
    dcache = prefilled(torch, eng, ids, 256, draft=True)[1]
    tok = torch.tensor([[ids[-1]]], device="cuda")
    pos = torch.tensor([[n]], device="cuda")
    vtoks = torch.tensor([ids[-(k + 1):]], device="cuda")
    vpos = (n + torch.arange(k + 1, device="cuda"))[None]
    t_logits = llm_forward(eng.llm_params, vtoks, vpos, cache,
                           eng.llm_cfg)[0][0]
    d_logits = t_logits[:k].flip(-1)
    d_toks = torch.argmax(d_logits, dim=-1)
    parts = {
        "draft_step": lambda: llm_forward(eng.draft_params, tok, pos, dcache,
                                          eng.draft_cfg),
        "verify": lambda: llm_forward(eng.llm_params, vtoks, vpos, cache,
                                      eng.llm_cfg),
        "spec_accept": lambda: spec_accept(d_toks, t_logits, d_logits, 0.0),
        "plain_target_step": lambda: llm_forward(eng.llm_params, tok, pos,
                                                 cache, eng.llm_cfg)}
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = dict(host_ms=(time.perf_counter() - t0) / reps * 1e3,
                         launches=launches_of(torch, fn))
    out["sum_ms"] = ((k + 1) * out["draft_step"]["host_ms"]
                     + out["verify"]["host_ms"] + out["spec_accept"]["host_ms"])
    pending = torch.tensor([ids[-1]], device="cuda")

    def one_round():
        cache["fill"] = torch.tensor([n], dtype=torch.int32, device="cuda")
        dcache["fill"] = cache["fill"].clone()
        llm_generate_chunk_spec(eng.llm_params, eng.draft_params, pending,
                                cache, dcache, 0.0, eng._stop_ids,
                                eng.llm_cfg, eng.draft_cfg, 1, k)
        return 1
    one_round()
    out["round_profile"] = device_profile(torch, one_round,
                                          f"spec round (k={k})", card)
    log(f"spec: a round's parts (host ms a call / launches): "
        + ", ".join(f"{p} {out[p]['host_ms']:.4f} / {out[p]['launches']}"
                    for p in parts)
        + f"; (k + 1) drafts + verify + accept {out['sum_ms']:.4f} ms  "
          f"[{card}]")
    return out


def phase_spec(torch, qmat, paths: dict, d: str, card: str, base) -> dict:
    """Speculative decoding on the card: the 2.6B-Q4_K_M target (phase 15's
    bf16 engine `base`, and an f32 load) with the 0.1B-Q8_0 draft.  (a) K1
    vs plain at the verify's shapes; (b) f32 greedy parity at k = 1, 3, 6;
    (c) bf16 at k = 6 against plain (agreement, the near-tie rule, rates,
    K1 launches); (d) the 0.1B drafting for itself at f32; (e) forced
    acceptance; (f) a chunk under sync debug mode; (g) the stream with a
    draft against the draft-less stream; (h) the CLI in process."""
    import io
    import numpy as np
    from miotts_tpu_torch import cli
    from miotts_tpu_torch.runtime.engine import (EngineConfig, Options,
                                                 TTSEngine, VoiceModel)
    res: dict = {}
    text = "The quick brown fox jumps over the lazy dog."
    voice = VoiceModel(paths["voice"])
    counters = route_counters(qmat)

    # (a) K1 at M = k + 1 on the 2.6B linears
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    cases = [(label, qt, SPEC_MS) for label, qt, _ in shape_cases(
        torch, qmat, gen) if label.startswith("2.6b") and "q4_0" not in label]
    res["kernel_rows"] = kernel_rows(torch, qmat, cases, gen, card)
    del cases
    torch.cuda.empty_cache()
    for m in SPEC_MS:
        step = {k: q4km_k1_step(res["kernel_rows"], k, m)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        log(f"spec: one verify's K1 work at M={m} (129 linears): kernel "
            f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f}, library "
            f"{step['library_ms']:.4f}, bound {step['bound_ms']:.4f}  [{card}]")

    # (b) f32: the speculative tokens are plain greedy decoding's
    t0 = time.perf_counter()
    eng32 = f32_engine(torch, base, paths["q4km"],
                       max_tokens=SPEC_STREAM_TOKENS).with_draft(
                           paths["llm"], SPEC_K)
    res["f32_load_s"] = time.perf_counter() - t0
    log(f"spec: f32 target over phase 15's quantized weights + f32 draft "
        f"load {res['f32_load_s']:.2f} s")
    plain32 = eng32.with_draft("")
    want = timed_tokens(plain32, text, Options, SPEC_PARITY_TOKENS)[0]
    res["f32_parity"] = {}
    for k in SPEC_PARITY_KS:
        eng = eng32 if k == SPEC_K else eng32.with_draft(paths["llm"], k)
        got, prof = timed_tokens(eng, text, Options, SPEC_PARITY_TOKENS)
        num = spec_numbers(eng, got, prof)
        res["f32_parity"][str(k)] = dict(num, identical=got == want)
        log(f"spec[f32 k={k}]: {len(got)} tokens identical to plain: "
            f"{got == want}; rounds {num['rounds']}, accepted "
            f"{num['accepted']} of {num['drafted']}")
        if got != want:
            raise AssertionError(f"spec[f32 k={k}]: tokens differ from plain "
                                 f"greedy: {got} against {want}")

    # (g) the stream with the draft (unfused) against the plain stream
    opts = Options(temperature=0.0, max_tokens=SPEC_STREAM_TOKENS,
                   apply_peak_normalization=False)
    runs = {"plain": stream_run(torch, plain32, voice, text, opts),
            "spec": stream_run(torch, eng32, voice, text, opts)}
    if not (runs["spec"]["ok"] and runs["plain"]["ok"]):
        raise AssertionError("spec: a stream failed")
    n = runs["plain"]["pcm"].size
    err = (float(np.max(np.abs(runs["spec"]["pcm"] - runs["plain"]["pcm"])))
           if runs["spec"]["pcm"].size == n > 0 else None)
    res["stream"] = dict(samples=n, max_abs=err,
                         spec_rounds=eng32._spec_stats["rounds"],
                         plain_total_s=runs["plain"]["wall"],
                         spec_total_s=runs["spec"]["wall"])
    log(f"spec: f32 stream of {SPEC_STREAM_TOKENS} tokens with the draft "
        f"(unfused) vs without (fused): {n} samples, max |diff| {err} (tol "
        f"{STREAM_TOL})")
    if err is None or err > STREAM_TOL:
        raise AssertionError("spec: the stream with a draft differs from the "
                             "plain stream")
    del eng32, plain32, runs
    torch.cuda.empty_cache()

    # (c) bf16, k = 6: agreement, rates, K1 launches
    spec16 = base.with_draft(paths["llm"], SPEC_K)
    t0 = time.perf_counter()
    spec16.warmup(max_codes=SPEC_TOKENS)
    res["warmup_s"] = time.perf_counter() - t0
    plain_toks, pprof = timed_tokens(base, text, Options, SPEC_TOKENS)
    plain_rate = len(plain_toks) / pprof.llm_sec
    reset_counts(counters)
    toks, prof = timed_tokens(spec16, text, Options, SPEC_TOKENS)
    got = read_counts(counters)
    num = spec_numbers(spec16, toks, prof)
    # both prefills, then per round k + 1 draft steps and one verify
    want_k1 = (Q4KM_QDOT_PER_STEP + QDOT_PER_STEP + prof.decode_steps
               * ((SPEC_K + 1) * QDOT_PER_STEP + Q4KM_QDOT_PER_STEP))
    agree = sum(a == b for a, b in zip(toks, plain_toks))
    res["bf16"] = dict(num, plain_tok_s=plain_rate,
                       speedup=num["tok_s"] / plain_rate, launches=got,
                       agreeing=agree, compared=min(len(toks),
                                                    len(plain_toks)),
                       near_tie=near_tie(torch, base, text, plain_toks, toks,
                                         "spec[bf16 k=6]"))
    log(f"spec[bf16 k=6]: {len(toks)} tokens at {num['tok_s']:.4f} tok/s "
        f"(plain {plain_rate:.4f}, x{res['bf16']['speedup']:.4f}); rounds "
        f"{num['rounds']} ({prof.decode_steps} run), accepted "
        f"{num['accepted']} of {num['drafted']}, round "
        f"{num['round_ms']:.4f} ms; {agree} of "
        f"{res['bf16']['compared']} tokens agree with plain greedy; K1 "
        f"launches {got['K1']} (want {want_k1}); warmup "
        f"{res['warmup_s']:.2f} s  [{card}]")
    if got != dict(dict.fromkeys(got, 0), K1=want_k1):
        raise AssertionError(f"spec[bf16]: launches {got}, want K1 {want_k1} "
                             f"only")
    res["round"] = round_breakdown(torch, spec16, text, card)

    # (e) forced acceptance: the speedup curve
    res["forced"] = {}
    try:
        for p in SPEC_FORCE_P:
            os.environ["MIOTTS_SPEC_FORCE_ACCEPT"] = str(p)
            toks, prof = timed_tokens(spec16, text, Options,
                                      SPEC_FORCED_TOKENS)
            num = spec_numbers(spec16, toks, prof)
            num["speedup"] = num["tok_s"] / plain_rate
            res["forced"][str(p)] = num
            log(f"spec[forced p={p}]: {len(toks)} tokens at "
                f"{num['tok_s']:.4f} tok/s (x{num['speedup']:.4f} plain), "
                f"round {num['round_ms']:.4f} ms, "
                f"{num['tokens_per_round']:.4f} tokens a round, accepted "
                f"{num['accepted']} of {num['drafted']}  [{card}]")
            if ((p == 1.0 and num["accepted"] != num["drafted"])
                    or (p == 0.0 and num["accepted"] != 0)):
                raise AssertionError(f"spec[forced p={p}]: accepted "
                                     f"{num['accepted']} of {num['drafted']}")
    finally:
        os.environ.pop("MIOTTS_SPEC_FORCE_ACCEPT", None)

    # (f) no host sync in a temperature-0 chunk
    res["sync"] = spec_sync_check(torch, spec16, text)
    del spec16
    torch.cuda.empty_cache()

    # (d) the 0.1B drafting for itself at f32 accepts every draft
    eng01 = TTSEngine(EngineConfig(
        model_path=paths["llm"], codec_path=paths["codec"], device="cuda",
        llm_dtype="float32", temperature=0.0, max_tokens=MAX_TOKENS,
        draft_model_path=paths["llm"], spec_tokens=SPEC_SELF_K,
        qdot_route=qmat.QdotRoute()))
    plain01 = timed_tokens(eng01.with_draft(""), text, Options, MAX_TOKENS)[0]
    toks, prof = timed_tokens(eng01, text, Options, MAX_TOKENS)
    num = spec_numbers(eng01, toks, prof)
    res["self_draft"] = dict(num, identical=toks == plain01,
                             near_tie=near_tie(torch, eng01, text, plain01,
                                               toks, "spec[self f32 k=4]"))
    log(f"spec[self-draft f32 k={SPEC_SELF_K}]: {len(toks)} tokens, "
        f"accepted {num['accepted']} of {num['drafted']}, identical to plain "
        f"{toks == plain01}")
    if num["accepted"] != num["drafted"] and toks == plain01:
        raise AssertionError("spec[self-draft]: a draft was rejected but the "
                             "tokens are plain greedy's")
    del eng01

    # (h) the CLI in process: a 0.1B target drafting for itself
    model = ["-m", paths["llm"], "-c", paths["codec"], "-v", paths["voice"],
             "-p", text, "-t", "0", "--max-tokens", str(SPEC_STREAM_TOKENS),
             "--draft-model", paths["llm"], "--spec-tokens", str(SPEC_K)]
    wav = os.path.join(d, "spec.wav")
    if cli.main(["synth"] + model + ["-o", wav]) != 0 or not os.path.exists(wav):
        raise AssertionError("spec: cli synth --draft-model failed")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench"] + model)
    lines = dict(line.split("=", 1) for line in buf.getvalue().splitlines()
                 if "=" in line)
    res["cli_bench"] = {k: v for k, v in lines.items() if "spec" in k}
    log(f"spec: cli bench --draft-model: {res['cli_bench']}  [{card}]")
    if rc != 0 or set(res["cli_bench"]) != {"stream_bench.spec_rounds",
                                            "stream_bench.spec_accept_rate"}:
        raise AssertionError(f"spec: cli bench exited {rc}, spec lines "
                             f"{res['cli_bench']}")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phases 22-23: the fused batch step and the codec options (0.1B serving);
# the single-stream int8 KV cache (0.1B, LFM2)
# ---------------------------------------------------------------------------

def same_requests(label: str, got: dict, want: dict, tol: float) -> float:
    """Per request: the same codes and token count, the same sample count,
    PCM within `tol` (0: bit for bit), and a last callback that was
    is_last with samples.  Returns the largest |diff|."""
    import numpy as np
    worst = 0.0
    for i, w in want.items():
        g = got[i]
        if g["codes"] != w["codes"] or g["n_tokens"] != w["n_tokens"]:
            raise AssertionError(f"{label}: request {i} kept other tokens "
                                 f"({g['n_tokens']} against {w['n_tokens']})")
        if g["pcm"].shape != w["pcm"].shape:
            raise AssertionError(f"{label}: request {i} emitted "
                                 f"{g['pcm'].size} samples against "
                                 f"{w['pcm'].size}")
        if not g["last_with_samples"]:
            raise AssertionError(f"{label}: request {i} did not end with "
                                 f"is_last on its last sample")
        if g["pcm"].size:
            worst = max(worst, float(np.abs(g["pcm"] - w["pcm"]).max()))
    if worst > tol:
        raise AssertionError(f"{label}: PCM max |diff| {worst} > {tol}")
    return worst


def serving_line(res: dict) -> str:
    return (f"aggregate x_realtime {res['aggregate_x_realtime']:.4f}, TTFA "
            f"p50 {res['ttfa_p50_s']:.4f} s, wall {res['wall_s']:.4f} s, "
            f"stage " + json.dumps({k: (round(v, 4) if isinstance(v, float)
                                        else v)
                                    for k, v in res["stage"].items()}))


def phase_fused_serving(torch, eng, voice, card: str, phase7: dict,
                        phase7_requests: dict) -> dict:
    """Phase 7's engine and mix: (a) the fused batch step (64 slots, 20-step
    chunks) against the unfused batcher at depth 1 (the same schedule, so
    every chunk sees the same slots and attention length) with float
    slices, bf16 cache; (b) the same on an int8 cache; (c) codec_fast on
    the unfused batcher; (d) the codec on a CUDA stream of its own against
    phase 7's run."""
    import numpy as np
    from miotts_tpu_torch.runtime.batching import ContinuousBatcher
    from miotts_tpu_torch.runtime.engine import Options
    out: dict = {}
    flt = engine_variant(eng, i16_transfer=False)

    def serve(e, keep=True, **kw):
        b = ContinuousBatcher(e, n_slots=SLOTS, chunk_steps=CHUNK, **kw)
        b.warmup(prompt_len=16)
        n_req = N_REQ_INT8 if kw.get("quantized_kv") else N_REQ
        return serve_requests(torch, b, voice, n_req, Options, keep=keep)

    # (a), (b): fused against unfused, the same tokens and samples
    for tag, quant in (("bf16", False), ("int8", True)):
        ref = serve(flt, quantized_kv=quant, pipeline_depth=1)
        fused = serve(flt, quantized_kv=quant, fused=True)
        err = same_requests(f"fused serving[{tag}]", fused.pop("per_request"),
                            ref.pop("per_request"), STREAM_TOL)
        out[tag] = dict(fused=fused, unfused_depth1=ref, max_abs=err)
        log(f"fused serving[{tag}]: {fused['n_req']} requests, tokens and "
            f"samples equal to the unfused batcher's (depth 1, f32 slices), "
            f"PCM max |diff| {err:.3e} (tol {STREAM_TOL}); {fused['codes']} "
            f"codes; K6 {fused['attn_launches']}, K1 "
            f"{fused['qdot_launches']} over {fused['stage']['device_steps']}"
            f" steps + {fused['stage']['prefills']} prefills  [{card}]")
        log(f"fused serving[{tag}]: fused {serving_line(fused)}")
        log(f"fused serving[{tag}]: unfused depth 1 {serving_line(ref)}")
    base = phase7["bf16"]
    log(f"fused serving: phase 7's unfused run (depth 2, int16 slices) "
        f"{serving_line(base)}")

    # (c) codec_fast: the same codes through an exact and a fast decode,
    # then bench_batch.py's setting on the unfused batcher
    fast = codec_variant(torch, eng, fast=True)
    spt = eng.samples_per_token
    codes = [r["codes"] for r in list(phase7_requests.values())[:16]]
    args = ([voice] * len(codes), [0] * len(codes), [len(c) * spt
                                                     for c in codes])

    def decode(e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = e.decode_codes_batch_sliced(codes, *args, i16=False)
        return np.concatenate(a), time.perf_counter() - t0

    decode(eng), decode(fast)                   # cuDNN's plans, both modes
    exact1, t_exact = decode(eng)
    got, t_fast = decode(fast)
    exact2, _ = decode(eng)
    rms = float(np.sqrt(np.mean((got.astype(np.float64) - exact1) ** 2))
                / np.sqrt(np.mean(exact1.astype(np.float64) ** 2)))
    same = bool(np.array_equal(exact1, exact2))
    served = serve(fast, keep=False)
    out["codec_fast"] = dict(rel_rms=rms, exact_after_fast_same_bits=same,
                             decode_s=t_fast, exact_decode_s=t_exact,
                             serving=served)
    log(f"codec_fast: {len(codes)} requests' codes ({sum(map(len, codes))}) decoded "
        f"exact and fast: relative RMS {rms:.3e} (tol {FAST_RMS_TOL}), "
        f"decode {t_fast:.4f} s against {t_exact:.4f} s; an exact decode "
        f"after the fast one {'the same bits' if same else 'DIFFERS'}  "
        f"[{card}]")
    log(f"codec_fast serving: {serving_line(served)}")
    if rms > FAST_RMS_TOL or not same:
        raise AssertionError("codec_fast: the fast decode is off or the exact "
                             "decode after it changed")

    # (d) the codec's own CUDA stream against phase 7's same-stream run
    side = codec_variant(torch, eng, stream=True)
    served = serve(side)
    err = same_requests("codec stream", served.pop("per_request"),
                        phase7_requests, 0.0)
    out["codec_stream"] = dict(serving=served, max_abs=err)
    log(f"codec stream: {served['n_req']} requests sample-exact against "
        f"phase 7's run; {serving_line(served)}  [{card}]")
    return out


def int8_offline(torch, eng, voice, out_dir: str, card: str, label: str,
                 per_step: int, k5_per_step: int, plain: dict) -> dict:
    """`eng` with quantized_kv (its weights shared): synthesize_to_file at
    temperature 0, MAX_TOKENS tokens; checks the WAV, the int8 cache, qdot
    per_step x (1 + steps), K5 k5_per_step per decode step, every launch
    on an int8 cache, and none in the prefill; tok/s beside `plain`'s."""
    import numpy as np
    from miotts_tpu_torch.audio.wav import wav_read
    from miotts_tpu_torch.ops import decode_attn, qmat
    from miotts_tpu_torch.runtime.engine import Options
    from miotts_tpu_torch.runtime.profile import StreamProfile
    e8 = engine_variant(eng, quantized_kv=True)
    text = "The quick brown fox jumps over the lazy dog."
    e8.synthesize(voice, text, Options(temperature=0.0, max_tokens=8))
    if e8._cache["k"].dtype != torch.int8:
        raise AssertionError(f"{label}: quantized_kv built a "
                             f"{e8._cache['k'].dtype} cache")
    single = decode_attn._decode_attention_single_cuda
    int8_calls = [0]

    def counted(q, k_cache, *a, **k):
        int8_calls[0] += k_cache.dtype == torch.int8
        return single(q, k_cache, *a, **k)

    counters = (qmat.qdot, decode_attn.decode_attention,
                decode_attn.decode_attention_batched)
    for c in counters:
        c.kernel_launches = 0
    wav = os.path.join(out_dir, f"{label}.wav")
    prof = StreamProfile()
    decode_attn._decode_attention_single_cuda = counted
    try:
        t0 = time.perf_counter()
        e8.synthesize_to_file(voice, text, wav, Options(
            temperature=0.0, max_tokens=MAX_TOKENS), profile=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        decode_attn._decode_attention_single_cuda = single
    qd, k5, k6 = (c.kernel_launches for c in counters)
    audio, sr = wav_read(wav)
    if not (np.isfinite(audio).all() and sr == e8.sample_rate
            and audio.size == prof.decoded_codes * e8.samples_per_token
            and abs(float(np.max(np.abs(audio))) - 0.95) < 1e-3):
        raise AssertionError(f"{label}: bad WAV, {audio.size} samples")
    steps = prof.decode_steps
    if (qd != per_step * (1 + steps) or k5 != k5_per_step * steps
            or int8_calls[0] != k5 or k6):
        raise AssertionError(
            f"{label}: launches qdot {qd} (want {per_step} x (1 + {steps})),"
            f" K5 {k5} ({int8_calls[0]} on an int8 cache; want "
            f"{k5_per_step} x {steps}), K6 {k6}")
    res = dict(decode_tok_s=steps / prof.llm_sec, decode_steps=steps,
               prefill_ms=prof.prefill_sec * 1e3, llm_tokens=prof.llm_tokens,
               x_realtime=audio.size / sr / wall, qdot_launches=qd,
               k5_launches=k5, k5_int8_launches=int8_calls[0],
               tokens=list(prof.token_ids),
               bf16_cache_tok_s=plain["decode_tok_s"],
               tokens_agreeing_with_bf16_cache=sum(
                   a == b for a, b in zip(prof.token_ids, plain["tokens"])))
    log(f"{label}: int8 cache, {prof.llm_tokens} tokens of {steps} steps at "
        f"{res['decode_tok_s']:.4f} tok/s (bf16 cache "
        f"{plain['decode_tok_s']:.4f}), prefill {res['prefill_ms']:.4f} ms, "
        f"x_realtime {res['x_realtime']:.4f}; launches qdot {qd}, K5 {k5} "
        f"(int8 {int8_calls[0]}); {res['tokens_agreeing_with_bf16_cache']} "
        f"tokens agree with the bf16 cache's  [{card}]")
    return res


def phase_int8_gpu_vs_cpu(torch, paths: dict) -> dict:
    """The int8 KV cache on the card and on the CPU plain path, f32, a
    prefill + 20 greedy steps: LFM2 layers 0-5 (as phase 13: K5's int8
    form on the card) and the 0.1B at full depth (the dense decode's
    attention over the int8 cache, K1)."""
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.llm import (LLMConfig, init_kv_cache,
                                             llm_generate_chunk, llm_prefill,
                                             load_llm_params)
    from miotts_tpu_torch.ops import decode_attn
    n_vocab = 256 + 3 + N_SPEECH
    toks = torch.zeros((1, 48), dtype=torch.int64)
    toks[0, :40] = (torch.arange(40) * 37 + 11) % n_vocab
    out = {}
    for name, path, layers in (("lfm2", paths["lfm2"], LFM2_REF_LAYERS),
                               ("0.1b", paths["llm"], None)):
        res = {}
        with GGUFReader(path) as r:
            cfg = LLMConfig.from_gguf(r)
            if layers:
                cfg = dataclasses.replace(
                    cfg, n_layers=layers, layer_types=cfg.layer_types[:layers])
            for dev in ("cuda", "cpu"):
                params, _ = load_llm_params(r, cfg, dtype=torch.float32,
                                            device=dev)
                cache = init_kv_cache(cfg, 1, 128, dtype=torch.float32,
                                      device=dev, quantized=True)
                decode_attn.decode_attention.kernel_launches = 0
                last, cache = llm_prefill(params, toks.to(dev),
                                          torch.tensor([40]), cache, cfg)
                first = last.cpu()
                buf, _, _, last, cache = llm_generate_chunk(
                    params, last, cache, 0.0, torch.tensor([-1], device=dev),
                    cfg, 20)
                res[dev] = (first, buf.cpu(), last.cpu(),
                            decode_attn.decode_attention.kernel_launches)
                del params, cache
        n_k5 = (sum(t == "attn" for t in cfg.layer_types) * 20
                if cfg.layer_types else 0)
        e_first = rel_err(res["cuda"][0], res["cpu"][0])
        e_last = rel_err(res["cuda"][2], res["cpu"][2])
        same = bool(torch.equal(res["cuda"][1], res["cpu"][1]))
        log(f"int8 gpu-vs-cpu[{name}]: f32, int8 cache, prefill + 20 greedy "
            f"steps: tokens {'identical' if same else 'DIFFER'}, prefill "
            f"logits rel err {e_first:.2e}, last-step {e_last:.2e} (tol "
            f"{INT8_KV_REF_TOL}); K5 {res['cuda'][3]} (want {n_k5})")
        if res["cuda"][3] != n_k5:
            raise AssertionError(f"int8 gpu-vs-cpu[{name}]: K5 launches "
                                 f"{res['cuda'][3]} != {n_k5}")
        if not (same and e_first < INT8_KV_REF_TOL
                and e_last < INT8_KV_REF_TOL):
            raise AssertionError(f"int8 gpu-vs-cpu[{name}]: the card "
                                 f"disagrees with the CPU plain path")
        out[name] = dict(tokens_identical=same, first_logits_rel_err=e_first,
                         last_logits_rel_err=e_last, k5_launches=res["cuda"][3])
    return out


# ---------------------------------------------------------------------------
# Phase 24: the JAX package's remaining switches and the codec's debug
# surface, on engines already loaded (phase 3's 0.1B, phase 15's 2.6B)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def env_set(**kw):
    """The environment switches `kw` set inside, their old values back
    after."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def switch_counters(qmat):
    """route_counters and `qdot_xla`'s calls (no kernel)."""
    return dict(route_counters(qmat), xla=(qmat.qdot_xla, "calls"))


def unpacked_tree(torch, tree):
    """A params tree whose packed QTensors are unpacked on their device
    (int8 values, the same scales and mins): the storage a file loaded
    under MIOTTS_NO_PACK4 gets, without reading the file again."""
    from miotts_tpu_torch.ops.qmat import QTensor
    if isinstance(tree, QTensor):
        return tree if not tree.packed else dataclasses.replace(
            tree, values=tree.unpacked_values().to(torch.int8), packed=False)
    if isinstance(tree, dict):
        return {k: unpacked_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [unpacked_tree(torch, v) for v in tree]
    return tree


def step_logits(torch, eng, text: str, toks: list) -> list:
    """The last prefill logits of `text`'s prompt and those of one decode
    step for each token of `toks`, teacher-forced, on the card (f32 on the
    host)."""
    from miotts_tpu_torch.models.llm import llm_decode_step
    ids = prompt_ids(eng, text)
    last, cache = prefilled(torch, eng, ids, len(ids) + len(toks))
    out = [last.float().cpu()]
    for t in toks:
        last, cache = llm_decode_step(eng.llm_params,
                                      torch.tensor([t], device="cuda"),
                                      cache, eng.llm_cfg)
        out.append(last.float().cpu())
    return out


def logits_err(a: list, b: list) -> float:
    """The largest of each step's max |a - b| over b's logit scale."""
    return max(rel_err(x, y) for x, y in zip(a, b))


def run_counted(torch, eng, counters, text, Options, n: int,
                voice=None, wav: str | None = None) -> dict:
    """One greedy run of n tokens with the launch counts at 0 before it:
    synthesize_to_file when `wav` is given (the WAV checked), else
    generate_tokens.  Returns tokens, decode steps, tok/s and counts."""
    import numpy as np
    from miotts_tpu_torch.audio.wav import wav_read
    from miotts_tpu_torch.runtime.profile import StreamProfile
    prof = StreamProfile()
    opts = Options(temperature=0.0, max_tokens=n)
    reset_counts(counters)
    if wav is None:
        eng.generate_tokens(text, opts, profile=prof)
    else:
        eng.synthesize_to_file(voice, text, wav, opts, profile=prof)
    torch.cuda.synchronize()
    out = dict(tokens=list(prof.token_ids), steps=prof.decode_steps,
               tok_s=prof.decode_steps / prof.llm_sec,
               counts=read_counts(counters))
    if wav is not None:
        audio, sr = wav_read(wav)
        if not (np.isfinite(audio).all() and sr == eng.sample_rate
                and audio.size == prof.decoded_codes * eng.samples_per_token
                and abs(float(np.max(np.abs(audio))) - 0.95) < 1e-3):
            raise AssertionError(f"bad WAV {wav}: {audio.size} samples for "
                                 f"{prof.decoded_codes} codes")
        out["n_codes"] = prof.decoded_codes
    return out


def rates_in_turns(torch, runs, text: str, Options, n: int) -> dict:
    """tok/s of greedy generate_tokens runs of n tokens taken in the order
    of `runs` ((label, engine, environment switches) each, e.g. a b b a):
    each label's rates and their mean."""
    out: dict = {}
    for label, eng, env in runs:
        with env_set(**env):
            prof = timed_tokens(eng, text, Options, n)[1]
        out.setdefault(label, []).append(prof.decode_steps / prof.llm_sec)
    return {k: dict(runs=v, mean=sum(v) / len(v)) for k, v in out.items()}


def check_counts(label: str, got: dict, want: dict) -> None:
    want = dict(dict.fromkeys(got, 0), **want)
    if got != want:
        raise AssertionError(f"{label}: launches {got} != {want}")


def agreement(toks: list, ref: list) -> dict:
    n = min(len(toks), len(ref))
    return dict(agreeing=sum(a == b for a, b in zip(toks, ref)), compared=n,
                first_disagreement=next((i for i in range(n)
                                         if toks[i] != ref[i]), None))


def phase_switches(torch, qmat, paths: dict, d: str, card: str, main_eng,
                   main_voice, main_res: dict, q4km_eng,
                   q4km_res: dict) -> dict:
    """The JAX package's switches on loaded engines, and the codec's debug
    surface.  (a) MIOTTS_NO_PACK4 on phase 15's 2.6B-Q4_K_M engine (its
    QTensors unpacked on the card): one Q4_K tensor read under the switch
    has the unpacked bits; text -> WAV on the default route (K1 129 a step
    and prefill, K2 / K4b none; tokens against phase 15's, a near tie where
    they part), w8a8 (K4a 129 a step) and split (K2 none); f32 tokens and
    logits against the packed weights.  (b) MIOTTS_FORCE_XLA_QDOT on phase
    3's 0.1B engine: no kernel, qdot_xla 49 a step and prefill; f32 tokens
    and logits against the kernel route.  (c) MIOTTS_ATTN_NOCAT on the same
    engines: f32 tokens and logits against the cat path, qdot 49 a step.
    (d) MIOTTS_WARMUP_VERBOSE: warmup's stage lines.  (e) the debug surface
    on phase 3's codec: codec_decode_stages on the card against the CPU,
    codec_decoder_layer_substeps at the first and last layer,
    codec_decode_audio against the engine's decode, `synth
    --dump-tensors`."""
    import io
    import re
    import numpy as np
    from miotts_tpu_torch import cli
    from miotts_tpu_torch.gguf import GGML_Q4_K, GGUFReader
    from miotts_tpu_torch.runtime.engine import Options, _bucket_len
    res: dict = {}
    text = "The quick brown fox jumps over the lazy dog."
    counters = switch_counters(qmat)
    n_q4km = Q4KM_QDOT_PER_STEP

    # (a) MIOTTS_NO_PACK4 at 2.6B
    t0 = time.perf_counter()
    un = engine_variant(q4km_eng)
    un.llm_params = unpacked_tree(torch, q4km_eng.llm_params)
    name = "blk.0.attn_output.weight"
    with GGUFReader(paths["q4km"]) as r:
        info = r.tensors[name]
        rows, cols = info.shape
        raw = np.array(r.tensor_raw(name))    # a copy: the file closes
    with env_set(MIOTTS_NO_PACK4="1"):
        read = qmat.qtensor_from_raw(raw, info.ggml_type, rows, cols,
                                     device="cuda")
    dev = un.llm_params["blocks"][0]["wo"]
    same_bits = (info.ggml_type == GGML_Q4_K and not read.packed
                 and torch.equal(read.values, dev.values)
                 and torch.equal(read.scales, dev.scales)
                 and torch.equal(read.mins, dev.mins))
    log(f"no_pack4: {name} read under MIOTTS_NO_PACK4 ({tuple(read.values.shape)}"
        f" {read.values.dtype}) the same bits as its unpacked copy on the "
        f"card: {same_bits}; unpacked in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB on the card")
    log(un.route_line())
    if not same_bits:
        raise AssertionError("no_pack4: the tensor read under the switch "
                             "differs from its unpacked copy")
    packed_ref = q4km_res["default"]
    run = run_counted(torch, un, counters, text, Options, SWITCH_TOKENS,
                      main_voice, os.path.join(d, "no_pack4.wav"))
    check_counts("no_pack4[default]", run["counts"],
                 expected_counts("default", run["steps"], n_q4km, 0))
    agree = agreement(run["tokens"], packed_ref["token_ids"])
    tie = near_tie(torch, q4km_eng, text, packed_ref["token_ids"][
        :len(run["tokens"])], run["tokens"], "no_pack4[bf16]")
    routes = {}
    for route_name in ("w8a8", "split"):
        eng = un.with_qdot_route(qmat.QdotRoute.from_env(
            Q4KM_ROUTES[route_name]))
        r_run = run_counted(torch, eng, counters, text, Options,
                            SWITCH_ROUTE_TOKENS)
        check_counts(f"no_pack4[{route_name}]", r_run["counts"],
                     expected_counts(route_name, r_run["steps"], n_q4km, 0))
        routes[route_name] = dict(steps=r_run["steps"], tok_s=r_run["tok_s"],
                                  launches=r_run["counts"])
        log(f"no_pack4[{route_name}]: {r_run['steps']} steps at "
            f"{r_run['tok_s']:.4f} tok/s, launches {r_run['counts']}  [{card}]")
    turns = rates_in_turns(torch, [("packed", q4km_eng, {}), ("unpacked", un, {}),
                                   ("unpacked", un, {}), ("packed", q4km_eng, {})],
                           text, Options, SWITCH_ROUTE_TOKENS)
    p32 = f32_engine(torch, q4km_eng, paths["q4km"])
    u32 = f32_engine(torch, un, paths["q4km"])
    want32 = timed_tokens(p32, text, Options, SWITCH_TOKENS)[0]
    got32 = timed_tokens(u32, text, Options, SWITCH_TOKENS)[0]
    err32 = logits_err(step_logits(torch, u32, text, want32[:SWITCH_STEPS]),
                       step_logits(torch, p32, text, want32[:SWITCH_STEPS]))
    res["no_pack4"] = dict(
        same_bits=same_bits, tok_s=run["tok_s"],
        packed_tok_s=packed_ref["decode_tok_s"], turns=turns,
        steps=run["steps"],
        n_codes=run["n_codes"], launches=run["counts"],
        tokens_vs_packed=agree, near_tie=tie, routes=routes,
        f32_identical=got32 == want32, f32_logits_err=err32,
        seconds=time.perf_counter() - t0)
    log(f"no_pack4[default]: {run['steps']} steps at {run['tok_s']:.4f} "
        f"tok/s (phase 15 packed: {packed_ref['decode_tok_s']:.4f}); in "
        f"turns of {SWITCH_ROUTE_TOKENS} tokens packed "
        f"{turns['packed']['runs']}, "
        f"unpacked {turns['unpacked']['runs']}; "
        f"launches {run['counts']}; tokens agreeing with the packed route "
        f"{agree['agreeing']} of {agree['compared']}; f32 tokens identical "
        f"{got32 == want32}, logits {err32:.3e} of their scale (tol "
        f"{REF_TOL})  [{card}]")
    if got32 != want32 or not err32 <= REF_TOL:
        raise AssertionError("no_pack4: the unpacked f32 engine parts from "
                             "the packed one")
    del un, p32, u32, eng
    torch.cuda.empty_cache()

    # (b) MIOTTS_FORCE_XLA_QDOT at 0.1B
    t0 = time.perf_counter()
    xla = main_eng.with_qdot_route(qmat.QdotRoute(xla=True))
    log(xla.route_line())
    run = run_counted(torch, xla, counters, text, Options, SWITCH_BF16_TOKENS)
    check_counts("xla[bf16]", run["counts"],
                 dict(xla=QDOT_PER_STEP * (1 + run["steps"])))
    k32 = f32_engine(torch, main_eng, paths["llm"])
    x32 = k32.with_qdot_route(qmat.QdotRoute(xla=True))
    cat32 = timed_tokens(k32, text, Options, SWITCH_TOKENS)[0]
    got32 = timed_tokens(x32, text, Options, SWITCH_TOKENS)[0]
    cat_logits = step_logits(torch, k32, text, cat32)
    err32 = logits_err(step_logits(torch, x32, text, cat32), cat_logits)
    res["force_xla"] = dict(
        tok_s=run["tok_s"], kernel_tok_s=main_res["decode_tok_s"],
        steps=run["steps"], launches=run["counts"],
        tokens_vs_kernels=agreement(run["tokens"], main_res["tokens"]),
        f32_identical=got32 == cat32, f32_logits_err=err32,
        seconds=time.perf_counter() - t0)
    log(f"xla[bf16]: {run['steps']} steps at {run['tok_s']:.4f} tok/s "
        f"(phase 3's kernels: {main_res['decode_tok_s']:.4f}), launches "
        f"{run['counts']}; tokens agreeing with phase 3's "
        f"{res['force_xla']['tokens_vs_kernels']}; f32 tokens identical "
        f"{got32 == cat32}, logits {err32:.3e} of their scale (tol "
        f"{REF_TOL})  [{card}]")
    if got32 != cat32 or not err32 <= REF_TOL:
        raise AssertionError("xla: the f32 xla route parts from the kernels")

    # (c) MIOTTS_ATTN_NOCAT at 0.1B
    t0 = time.perf_counter()
    with env_set(MIOTTS_ATTN_NOCAT="1"):
        log(main_eng.route_line())
        nocat32 = timed_tokens(k32, text, Options, SWITCH_TOKENS)[0]
        err_nc = logits_err(step_logits(torch, k32, text, cat32), cat_logits)
        run = run_counted(torch, main_eng, counters, text, Options,
                          SWITCH_BF16_TOKENS)
    check_counts("nocat[bf16]", run["counts"],
                 dict(K1=QDOT_PER_STEP * (1 + run["steps"])))
    res["attn_nocat"] = dict(
        tok_s=run["tok_s"], cat_tok_s=main_res["decode_tok_s"],
        steps=run["steps"], launches=run["counts"],
        tokens_vs_cat=agreement(run["tokens"], main_res["tokens"]),
        f32_identical=nocat32 == cat32, f32_logits_err=err_nc,
        seconds=time.perf_counter() - t0)
    log(f"nocat[bf16]: {run['steps']} steps at {run['tok_s']:.4f} tok/s "
        f"(phase 3, cat: {main_res['decode_tok_s']:.4f}), launches "
        f"{run['counts']}; tokens agreeing with phase 3's "
        f"{res['attn_nocat']['tokens_vs_cat']}; f32 tokens identical "
        f"{nocat32 == cat32}, logits {err_nc:.3e} of their scale (tol "
        f"{NOCAT_TOL})  [{card}]")
    if nocat32 != cat32 or not err_nc <= NOCAT_TOL:
        raise AssertionError("nocat: the f32 merge parts from the cat path")
    nocat = {"MIOTTS_ATTN_NOCAT": "1"}
    turns = rates_in_turns(torch, [
        ("kernels", main_eng, {}), ("xla", xla, {}), ("nocat", main_eng, nocat),
        ("nocat", main_eng, nocat), ("xla", xla, {}), ("kernels", main_eng, {})],
        text, Options, SWITCH_TOKENS)
    res["force_xla"]["turns"] = res["attn_nocat"]["turns"] = turns
    log(f"0.1B bf16 in turns of {SWITCH_TOKENS} tokens, tok/s: kernels "
        f"{turns['kernels']['runs']}, xla {turns['xla']['runs']}, nocat "
        f"{turns['nocat']['runs']}  [{card}]")
    del xla, k32, x32

    # (d) MIOTTS_WARMUP_VERBOSE
    t0 = time.perf_counter()
    cfgE = main_eng.config
    chunk = cfgE.stream_check_interval
    want_labels = (
        [f"codec bucket T={T}" for T in main_eng._code_buckets(
            WARMUP_CODES, 1)]
        + [f"llm prefill bucket={cfgE.prompt_bucket}"]
        + [f"llm chunk={n} + codec interleave" for n in sorted({chunk, 64})]
        + [f"fused stream step bucket={b}" for b in main_eng._code_buckets(
            WARMUP_CODES, chunk)])
    errs = {}
    for verbose in (False, True):
        buf = io.StringIO()
        with env_set(**({"MIOTTS_WARMUP_VERBOSE": "1"} if verbose else {})), \
                contextlib.redirect_stderr(buf):
            main_eng.warmup(max_codes=WARMUP_CODES,
                            prompt_len=cfgE.prompt_bucket)
        errs[verbose] = buf.getvalue()
    line = re.compile(r"^warmup: (.+): (\d+\.\d)s$")
    lines = [s for s in errs[True].splitlines() if s.startswith("warmup:")]
    got_labels = [line.match(s).group(1) if line.match(s) else s
                  for s in lines]
    res["warmup_verbose"] = dict(lines=lines, quiet="warmup:" not in errs[False],
                                 seconds=time.perf_counter() - t0)
    for s in lines:
        log(f"warmup_verbose: {s}  [{card}]")
    if got_labels != want_labels or "warmup:" in errs[False]:
        raise AssertionError(f"warmup_verbose: labels {got_labels} != "
                             f"{want_labels}, or lines without the switch")

    # (e) the codec's debug surface
    t0 = time.perf_counter()
    from miotts_tpu_torch.models.codec import (codec_decode_audio,
                                               codec_decode_stages,
                                               codec_decoder_layer_substeps)
    cfgc, cparams = main_eng.codec_cfg, main_eng.codec_params
    codes = (np.arange(DEBUG_CODES) * 397 + 5) % N_SPEECH
    emb = main_voice.embedding
    gpu, _ = codec_decode_stages(cparams, codes, emb, cfgc)
    cpu, _ = codec_decode_stages(_to_cpu(cparams), codes, emb, cfgc)
    stage_err = {k: rel_err(torch.from_numpy(gpu[k]), torch.from_numpy(cpu[k]))
                 for k in gpu}
    subs = {}
    n_layers = len(cparams["decoder_blocks"])
    for li in (0, n_layers - 1):
        sub, diff = codec_decoder_layer_substeps(cparams, codes, emb, cfgc, li)
        scale = float(np.max(np.abs(sub["layer_out"])))
        subs[str(li)] = dict(max_abs_diff=diff, layer_out_scale=scale,
                             ok=diff <= REF_TOL * scale)
        if li == 0:
            subs["0"]["layer_in_is_prior"] = bool(np.array_equal(
                sub["layer_in"], gpu["prior"]))
        else:
            subs[str(li)]["layer_out_vs_decoder"] = rel_err(
                torch.from_numpy(sub["layer_out"]),
                torch.from_numpy(gpu["decoder"]))
    bucket = _bucket_len(DEBUG_CODES, main_eng.config.code_bucket)
    padded = np.zeros(bucket, np.int64)
    padded[:DEBUG_CODES] = codes
    audio = codec_decode_audio(
        cparams, torch.from_numpy(padded).cuda(),
        main_voice.device_embedding("cuda"), cfgc, DEBUG_CODES)
    spt = main_eng.samples_per_token
    audio = audio[: DEBUG_CODES * spt].cpu()
    engine_audio = torch.from_numpy(main_eng.decode_codes(
        list(codes), main_voice, apply_peak_normalization=False))
    audio_err = rel_err(audio, engine_audio)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["synth", "-c", paths["codec"], "--dump-tensors"])
    dump = out.getvalue().splitlines()
    with GGUFReader(paths["codec"]) as r:
        n_tensors = len(r.tensors)
    dump_ok = (rc == 0 and dump[0] == f"Tensors in {paths['codec']}: "
               f"{n_tensors}" and len(dump) == n_tensors + 1)
    res["debug"] = dict(stage_err=stage_err, substeps=subs,
                        audio_err=audio_err, dump_tensors=dict(
                            rc=rc, tensors=n_tensors, lines=len(dump) - 1),
                        seconds=time.perf_counter() - t0)
    log(f"debug: codec_decode_stages card vs CPU, worst "
        f"{max(stage_err.values()):.3e} of a stage's scale (tol {REF_TOL}; "
        f"{len(stage_err)} stages); layer substeps {subs}; "
        f"codec_decode_audio vs the engine's decode {audio_err:.3e} (tol "
        f"{AUDIO_TOL}); --dump-tensors rc {rc}, {len(dump) - 1} of "
        f"{n_tensors} tensors  [{card}]")
    last = subs[str(n_layers - 1)]
    if not (max(stage_err.values()) <= REF_TOL
            and all(v["ok"] for v in subs.values())
            and subs["0"]["layer_in_is_prior"]
            and last["layer_out_vs_decoder"] <= AUDIO_TOL
            and audio_err <= AUDIO_TOL and dump_ok):
        raise AssertionError("debug: the codec's debug surface is off")
    return res


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
ALL_PHASES = (2, 3, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
              21, 22, 23, 24)
PHASE_NEEDS = {9: {7}, 12: {11}, 20: {11}, 21: {15}, 22: {7}, 23: {3, 11},
               24: {3, 15}}
MODEL_PHASES = {3, 7, 8, 9, 11, 12, 13, 15, 16, 19, 20, 21, 22,
                23, 24}                      # the 0.1B files, codec


def parse_phases(argv) -> set:
    """The phases to run: all of them, or those of --phases (for dev runs;
    the summary and the last line are printed only when all ran)."""
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke test of the port.")
    ap.add_argument("--phases", default="",
                    help="comma-separated phase numbers to run (3 runs 3-5; "
                         "9 and 22 bring 7, 12 and 20 bring 11, 21 brings "
                         "15, 23 brings 3 and 11, 24 brings 3 and 15); "
                         "default: all")
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

    # each phase's seconds: since the previous phase ended (the build is in
    # phase 2's, a model file's write or wait in the phase that reads it)
    res: dict = {"phase_seconds": {}}
    mark = [t_start]

    def done(label: str) -> None:
        now = time.perf_counter()
        res["phase_seconds"][label] = round(now - mark[0], 1)
        mark[0] = now
        log(f"phase {label} done at {now - t_start:.1f} s "
            f"({res['phase_seconds'][label]} s)")

    rows = []
    if 2 in run:
        rows = res["qdot_per_shape"] = phase_kernels(torch, qmat, card)
        done("2")

    writers_for = {"lfm2": {11, 12, 13}, "q4km": {15, 16, 21, 24}}
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
            main_eng = res["main_path"].pop("engine")
            main_voice = res["main_path"].pop("voice")
            if 23 in run:
                res["int8_kv"] = {"0.1b": int8_offline(
                    torch, main_eng, main_voice, d, card, "int8 0.1b",
                    QDOT_PER_STEP, 0, res["main_path"])}
                done("23 (a)")
            if 24 not in run:
                del main_eng, main_voice
        if 19 in run:
            res["stream"] = phase_stream_0p1b(
                torch, qmat, paths, d, card,
                res.get("main_path", {}).get("tokens"))
            done("19")
            torch.cuda.empty_cache()
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
            phase7_requests = res["serving"].pop("bf16_requests")
            if 9 in run:
                res["http"] = phase_http(torch, eng, voice)
                done("9")
            if 22 in run:
                res["fused_serving"] = phase_fused_serving(
                    torch, eng, voice, card, res["serving"], phase7_requests)
                done("22")
            del eng, voice, phase7_requests
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
            if 20 in run:
                res["lfm2_stream"] = phase_stream_lfm2(
                    torch, lfm2_eng, lfm2_voice, card,
                    res["lfm2_offline"]["tokens"])
                done("20")
            if 23 in run:
                res["int8_kv"]["lfm2"] = int8_offline(
                    torch, lfm2_eng, lfm2_voice, d, card, "int8 lfm2",
                    LFM2_QDOT_PER_STEP, len(LFM2_ATTN_IDX),
                    res["lfm2_offline"])
                done("23 (b)")
            del lfm2_eng
            torch.cuda.empty_cache()
        if 13 in run:
            res["lfm2_gpu_vs_cpu"] = phase_lfm2_gpu_vs_cpu(torch, paths["lfm2"])
            done("13 (c)")
        if 23 in run:
            res["int8_kv"]["gpu_vs_cpu"] = phase_int8_gpu_vs_cpu(torch, paths)
            done("23 (c)")
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
            res["q4km_offline"] = phase_q4km_offline(
                torch, qmat, paths, d, card, bool(run & {21, 24}))
            done("15")
        if 16 in run:
            res["q4km_gpu_vs_cpu"] = phase_q4km_gpu_vs_cpu(torch, qmat,
                                                           paths["q4km"])
            done("16")
        if 21 in run:
            res["spec"] = phase_spec(torch, qmat, paths, d, card,
                                     res["q4km_offline"]["engine"])
            done("21")
            torch.cuda.empty_cache()
        if 24 in run:
            res["switches"] = phase_switches(
                torch, qmat, paths, d, card, main_eng, main_voice,
                res["main_path"], res["q4km_offline"]["engine"],
                res["q4km_offline"])
            done("24")
            del main_eng, main_voice
        if 15 in run:
            res["q4km_offline"].pop("engine", None)
        torch.cuda.empty_cache()

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
    stream_res, lfm2_stream = res["stream"], res["lfm2_stream"]
    spec_res = res["spec"]
    spec_rows = spec_res["kernel_rows"]
    fused_res, int8_res = res["fused_serving"], res["int8_kv"]
    steps = single_stream_steps(res)
    qdot_entry = dict(
        name="qdot", route="cuda", source="miotts_tpu_torch/ops/csrc/qdot.cu",
        sources=["miotts_tpu_torch/ops/csrc/qdot.cu", GEMV_HEADER, TILE_HEADER],
        replaces="miotts_tpu/ops/qmat.py:191",
        launches=serve_res["bf16"]["qdot_launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows + spec_rows),
        rel_err=max(max(r["rel_err_bf16"], r["rel_err_f32"])
                    for r in rows + spec_rows),
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
        # one speculative verify's K1 work (phase 21's rows): the 2.6B's
        # 129 linears at M = k + 1, bf16 x
        q4km_spec_verify_step={str(m): {k: q4km_k1_step(spec_rows, k, m)
                                        for k in ("ms", "plain_ms",
                                                  "bound_ms", "library_ms")}
                               for m in SPEC_MS},
        launches_by_path={"serving_bf16": serve_res["bf16"]["qdot_launches"],
                          "serving_int8": serve_res["int8"]["qdot_launches"],
                          "offline": main_res["qdot_launches"],
                          "stream": stream_res["runs"]["fused_depth2"][
                              "qdot_launches"],
                          "lfm2_offline": lfm2_res["qdot_launches"],
                          "lfm2_stream": lfm2_stream["runs"]["fused_depth2"][
                              "qdot_launches"],
                          "lfm2_serving": lfm2_serve["qdot_launches"],
                          "lfm2_serving_after": lfm2_serve["after"][
                              "qdot_launches"],
                          **{f"q4km_{name}_offline": r["launches"]["K1"]
                             for name, r in q4km_res.items()},
                          "q4km_spec_bf16": spec_res["bf16"]["launches"]["K1"],
                          "serving_fused": fused_res["bf16"]["fused"][
                              "qdot_launches"],
                          "serving_fused_int8": fused_res["int8"]["fused"][
                              "qdot_launches"],
                          "int8_offline": int8_res["0.1b"]["qdot_launches"],
                          "lfm2_int8_offline": int8_res["lfm2"][
                              "qdot_launches"],
                          "q4km_no_pack4_offline": res["switches"][
                              "no_pack4"]["launches"]["K1"],
                          "offline_attn_nocat": res["switches"][
                              "attn_nocat"]["launches"]["K1"]})
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
                          "lfm2_serving": lfm2_serve["attn_launches"],
                          "serving_fused": fused_res["bf16"]["fused"][
                              "attn_launches"],
                          "serving_fused_int8": fused_res["int8"]["fused"][
                              "attn_launches"]})
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
                          "stream": lfm2_stream["runs"]["fused_depth2"][
                              "k5_launches"],
                          "lfm2_serving": lfm2_serve["k5_launches"],
                          "lfm2_gpu_vs_cpu": lfm2_ref["k5_launches"],
                          "offline": main_res["k5_launches"],
                          "serving_bf16": serve_res["bf16"]["k5_launches"],
                          "lfm2_int8_offline": int8_res["lfm2"]["k5_launches"],
                          "lfm2_int8_gpu_vs_cpu": int8_res["gpu_vs_cpu"][
                              "lfm2"]["k5_launches"]})
    variant_entries = [variant_entry(var_rows, q4km_res, q4km_ref, kernel)
                       for kernel in VARIANTS]
    # K4a on every 2.6B linear when the 4-bit weights are unpacked
    variant_entries[list(VARIANTS).index("K4a")]["launches_by_path"][
        "q4km_no_pack4_w8a8"] = res["switches"]["no_pack4"]["routes"][
            "w8a8"]["launches"]["K4a"]
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
        sources=["miotts_tpu_torch/ops/csrc/dma_floor.cu", ATTN_HEADER],
        replaces="miotts_tpu/ops/decode_attn.py:391",
        launches=probes["launches"]["K7"],
        launches_by_path={"probes": probes["launches"]["K7"]},
        max_abs_err=0.0, rel_err=0.0,
        ms=n_attn * k7_step["ms"], plain_ms=n_attn * k7_step["plain_ms"],
        bound_ms=n_attn * k7_step["bound_ms"], bound_by="bytes",
        library_ms=None, gb_s=k7_step["gb_s"], ranks=k7_step["ranks"],
        one_rank_ms=n_attn * k7_step["one_ms"],
        unit="one LFM2-1.2B offline decode step of K5's k/v streams (6 "
             "layers) at B=1, H_kv=8, D=64, S=256 (all rows), bf16 cache; "
             "no single PyTorch call computes it")
    k8_bench = [r for r in probes["k8"] if "bench_qmat" in r["shape"]]
    k8_entry = dict(
        name="qdot_dma_floor", route="cuda",
        source="miotts_tpu_torch/ops/csrc/dma_floor.cu",
        sources=["miotts_tpu_torch/ops/csrc/dma_floor.cu", ATTN_HEADER],
        replaces="benchmarks/bench_qmat.py:57",
        splits=[r["splits"] for r in k8_bench],
        one_rank_ms=Q4KM_LAYERS * sum(r["one_ms"] for r in k8_bench),
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
