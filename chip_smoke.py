"""Chip smoke test of the PyTorch/CUDA port (miotts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. device: the card's name and power limit (nvidia-smi), kernel build;
  2. kernel vs plain: the `qdot` CUDA kernel against `qdot_plain` on the
     card at the main path's shapes (0.1B-Q8_0 at M = 1 and 64) and at the
     2.6B-Q4_K_M formats (fused Q4_K + Q6_K, packed Q4_K, Q6_K, packed
     Q4_0 at M = 1, 7 and 64), with kernel / plain / library times;
  3. main path: synthetic full-width 0.1B-Q8_0 LLM + full-size MioCodec
     written with the port's own writer, then
     TTSEngine.synthesize_to_file on the card at temperature 0, 128 tokens;
     checks the WAV and that every quantized linear went through the kernel
     (49 launches per decode step and 49 for the prefill), and holds the
     GPU's prefill logits and codec output against the CPU reference path;
  4. --skip-llm: a fixed `<|s_N|>` string through the same engine;
  5. profile: torch.profiler over a prefill + one 64-step decode chunk
     (device time by kernel, device-busy share, launches per step).

Kernel times are device times: the calls are captured in a CUDA graph and
replayed between CUDA events, cycling over weight copies larger than the
50 MB L2 (a decode step streams every layer's weights cold); the eager
per-call time, Python wrapper included, is printed beside them.

The second-to-last line is the nvidia-smi name / power-limit line; before
it, one JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = 989e12            # H100 SXM dense bf16 tensor core (data sheet)
L2_FLUSH_BYTES = 160 << 20     # weight copies cycled per timing loop (> 50 MB L2)
KERNEL_TOL_BF16 = 1e-2         # bf16 output: one 2^-8 rounding on either side
KERNEL_TOL_F32 = 1e-5          # f32 output: summation order only
REF_TOL = 1e-4                 # GPU vs CPU reference, f32 LLM prefill / codec

# 0.1B-Q8_0 (the main path's model, bench.py's "0.1b-q8_0" at full width)
DIM, LAYERS, HEADS, KV_HEADS, HEAD_DIM, FF = 768, 12, 12, 4, 64, 2048
N_SPEECH = 12800
MAX_TOKENS = 128
QDOT_PER_STEP = LAYERS * 4 + 1   # fused QKV, wo, fused gate/up, down; output


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
    cases += [
        ("2.6b wqkv q4_k+q6_k", wqkv, (1, 7, 64)),
        ("2.6b w_gateup q4_k packed", gateup, (1, 7, 64)),
        ("2.6b w_down q6_k", q(8192, 2560, "q6_k"), (1, 7, 64)),
        ("2.6b q4_0 packed", q(2560, 2560, "q4_0"), (1, 7, 64)),
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
                       rel_err_f32=err[str(torch.float32)])
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

    wav = os.path.join(out_dir, "main.wav")
    prof: dict = {}
    qmat.qdot.kernel_launches = 0
    t0 = time.perf_counter()
    eng.synthesize_to_file(voice, text, wav, opts, profile=prof)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = qmat.qdot.kernel_launches

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
               qdot_launches=launches)
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


def profile_decode(torch, eng, text, Options, card: str) -> dict:
    """Where one generate_tokens call (prefill + one 64-step chunk) spends
    its time: torch.profiler device time by kernel, the device-busy share of
    the wall time and host kernel launches per decode step."""
    from torch.profiler import ProfilerActivity, profile
    eng.generate_tokens(text, Options(temperature=0.0, max_tokens=16))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate_tokens(text, Options(temperature=0.0, max_tokens=16))
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
    # the 12 largest by device time, and every qdot kernel
    shown = kernels[:12] + [e for e in kernels[12:] if "qdot" in e.key]
    out = dict(wall_s=wall, device_busy_s=busy_s,
               busy_share=busy_s / wall if busy_s else None,
               host_launches_per_step=launches / 65,
               top=[dict(name=e.key[:80], count=e.count, ms=dev_us(e) * 1e-3)
                    for e in shown])
    if not busy_s:
        log("profile: the profiler reported no device time (not measured)")
        return out
    log(f"profile: prefill + 64 decode steps: wall {wall:.4f} s, device busy "
        f"{busy_s:.4f} s ({100 * busy_s / wall:.1f}%), "
        f"{out['host_launches_per_step']:.0f} kernel launches per step  [{card}]")
    for t in out["top"]:
        log(f"profile:   {t['ms']:9.3f} ms  x{t['count']:<6d} {t['name']}")
    return out


def _to_cpu(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def step_summary(rows: list[dict], key: str) -> float:
    """One 0.1B decode step's worth of qdot work at M = 1: every layer's
    four linears plus the output head."""
    by = {r["shape"]: r[key] for r in rows if r["M"] == 1
          and r["shape"].startswith("0.1b")}
    layer = sum(v for s, v in by.items() if not s.startswith("0.1b output"))
    return LAYERS * layer + by["0.1b output q8_0"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
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

    rows = phase_kernels(torch, qmat, card)
    log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths = write_models(d)
        log(f"models written in {time.perf_counter() - t0:.1f} s")
        main_res = phase_main_path(torch, qmat, paths, d, card)
    log(f"phase 3/4 done at {time.perf_counter() - t_start:.1f} s")

    entry = dict(
        name="qdot", route="cuda", source="miotts_tpu_torch/ops/csrc/qdot.cu",
        replaces="miotts_tpu/ops/qmat.py:191",
        launches=main_res["qdot_launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=step_summary(rows, "ms"), plain_ms=step_summary(rows, "plain_ms"),
        bound_ms=step_summary(rows, "bound_ms"),
        bound_by=("bytes" if step_summary(rows, "bytes") / HBM_BYTES_PER_S
                  >= step_summary(rows, "flops") / PEAK_FLOPS
                  else "operations"),
        library_ms=step_summary(rows, "library_ms"),
        unit="one 0.1B-Q8_0 decode step of qdot work (12 x 4 linears + "
             "output) at M=1, bf16 x",
        per_shape=rows, main_path=main_res)
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
