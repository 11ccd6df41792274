"""Streaming paths of the port side by side on one GPU, in turns.

    python3 scripts/torch_stream_ab.py [--rounds 5] [--out FILE.json]

Writes chip_smoke.py's 0.1B-Q8_0 files (full width, random weights from a
seed), warms the engine up, then runs the same 128-token greedy stream
through the unfused path, the fused path at stream_pipeline_depth 1 and
the fused path at depth 2, in that order, `--rounds` times (alternating,
because the host's speed drifts within a run).  Prints each stream's wall
time, time to first audio and device steps, and the median of each path.
Before that, decodes the same codes six times with cuDNN's deterministic
algorithms on (as the engine runs the codec, `models/codec.exact_f32`) and
off, and prints the largest difference between the six.  Needs a GPU;
imports nothing of JAX."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = (("unfused", dict(fused_streaming=False)),
         ("fused_depth1", dict(stream_pipeline_depth=1)),
         ("fused_depth2", dict(stream_pipeline_depth=2)))


def codec_spread(torch, eng, voice, codes) -> dict:
    """The largest difference between six decodes of the same codes, with
    cuDNN's deterministic algorithms forced on and off around the codec."""
    import contextlib

    import numpy as np
    from miotts_tpu_torch.models import codec
    out = {}
    real = codec.exact_f32
    for det in (True, False):
        @contextlib.contextmanager
        def patched(det=det):
            with real():
                torch.backends.cudnn.deterministic = det
                yield
        codec.exact_f32 = patched
        try:
            pcm = [eng.decode_codes(codes, voice, False) for _ in range(6)]
        finally:
            codec.exact_f32 = real
        out["deterministic" if det else "default"] = max(
            float(np.max(np.abs(p - pcm[0]))) for p in pcm)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_stream_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from miotts_tpu_torch.ops import _build
    from miotts_tpu_torch.runtime.engine import (EngineConfig, Options,
                                                 TTSEngine, VoiceModel)
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    _build.load_kernels()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    res = {"card": card, "rounds": []}
    with tempfile.TemporaryDirectory() as d:
        paths = cs.write_models(d)
        eng = TTSEngine(EngineConfig(model_path=paths["llm"],
                                     codec_path=paths["codec"], device="cuda",
                                     max_tokens=cs.MAX_TOKENS,
                                     temperature=0.0))
        voice = VoiceModel(paths["voice"])
        text = "The quick brown fox jumps over the lazy dog."
        opts = Options(temperature=0.0, max_tokens=cs.MAX_TOKENS)
        eng.warmup(max_codes=cs.MAX_TOKENS, prompt_len=32)
        codes = eng.tokens_to_codes(eng.generate_tokens(text, opts))
        res["codec_max_diff_over_6"] = codec_spread(torch, eng, voice, codes)
        print(f"codec: the same {len(codes)} codes decoded 6 times, max "
              f"|diff| {res['codec_max_diff_over_6']}", flush=True)
        for rnd in range(args.rounds):
            row = {}
            for name, cfg in PATHS:
                r = cs.stream_run(torch, eng, voice, text, opts, **cfg)
                p = r["profile"]
                row[name] = dict(wall_s=r["wall"],
                                 first_audio_sec=p.first_audio_sec,
                                 steps=p.decode_steps,
                                 decode_calls=p.decode_calls)
                print(f"round {rnd} {name}: wall {r['wall']:.4f} s, first "
                      f"audio {p.first_audio_sec:.4f} s, {p.decode_steps} "
                      f"steps, {p.decode_calls} decodes  [{card}]",
                      flush=True)
            res["rounds"].append(row)
    res["median"] = {name: {k: statistics.median(r[name][k]
                                                 for r in res["rounds"])
                            for k in ("wall_s", "first_audio_sec")}
                     for name, _ in PATHS}
    for name, m in res["median"].items():
        print(f"median {name}: wall {m['wall_s']:.4f} s, first audio "
              f"{m['first_audio_sec']:.4f} s over {args.rounds} rounds  "
              f"[{card}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
