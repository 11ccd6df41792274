"""Build the port's six kernel libraries under two nvcc flag sets, each into
a directory of its own, and time them on one GPU: the build's seconds, then
phase 25 (a)'s rows (every quantized-linear kernel and K8 at bf16 and at
f32 scales; chip_smoke.scale_bf16_kernel_rows) and the K6 / K5 rows of
phases 6 and 10, summed to one decode step each, on each flag set's
libraries in turns (a b b a).  The flag sets are the build's own flags with
and without `--split-compile=0`; each compiler log (registers and spills
per kernel) is written beside the output.

    python3 scripts/torch_build_flags.py --out chiprun_out/build_flags.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPLIT = "--split-compile=0"


def steps(torch, cs, qmat, card: str) -> dict:
    """One decode step of each kernel's work on the loaded libraries."""
    rows = cs.scale_bf16_kernel_rows(torch, qmat, card)["rows"]
    pair = ("ms", "f32_ms")
    k1 = [r for r in rows if r["kernel"] == "K1"]
    k1v = [r for r in rows if r["kernel"] == "K1v"]
    out = {k: {x: cs.scale_step(rows, k, x) for x in pair}
           for k in ("K1", "K1v", "K2", "K3", "K4a", "K4b", "K8")}
    out["K1_2.6b_64_slot"] = {x: cs.scale_step(rows, "K1", x, 64)
                              for x in pair}
    out["K1v_lfm2_16_slot"] = {x: cs.lfm2_step_summary(k1v, x, cs.LFM2_SLOTS)
                               for x in pair}
    out["K1_0.1b_64_slot"] = {x: cs.step_summary(k1, x, cs.SLOTS)
                              for x in pair}
    attn = cs.phase_attn_kernels(torch, card)
    out["K6_0.1b_step"] = cs.attn_step_summary(attn, "ms")
    k5 = next(r for r in cs.phase_k5(torch, card) if r["mode"] == "bf16" and (
        r["shape"], r["B"], r["H"], r["H_kv"], r["D"],
        r["S"]) == cs.K5_STEP_SHAPE)
    out["K5_lfm2_step"] = len(cs.LFM2_ATTN_IDX) * k5["ms"]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_build_flags: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import chip_smoke as cs
    from miotts_tpu_torch.ops import _build, qmat
    card = cs.nvidia_smi_line()
    base = [f for f in _build.NVCC_FLAGS if f != SPLIT]
    logs_dir = Path(args.out).with_suffix("") if args.out else None
    res: dict = {"card": card, "build_s": {}, "runs": {}}
    libs = {}
    for tag, flags in (("plain", base), ("split", base + [SPLIT])):
        _build.BUILD_DIR = Path(ROOT) / "build" / "build_flags" / tag
        _build.NVCC_FLAGS = flags
        _build._loaded.clear()
        t0 = time.perf_counter()
        logs = _build.build_all()
        res["build_s"][tag] = time.perf_counter() - t0
        if logs_dir:
            logs_dir.mkdir(parents=True, exist_ok=True)
            for name, text in logs.items():
                (logs_dir / f"{tag}_{name}.log").write_text(text)
        _build.load_kernels()
        libs[tag] = dict(_build._loaded)
        print(f"build {tag}: {res['build_s'][tag]:.1f} s  [{card}]",
              flush=True)
    for tag in ("plain", "split", "split", "plain"):
        _build._loaded.clear()
        _build._loaded.update(libs[tag])
        st = steps(torch, cs, qmat, card)
        res["runs"].setdefault(tag, []).append(st)
        print(f"steps {tag} " + json.dumps(st), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
