"""What the port's tracer costs when it is on: untraced windows of a
benchmark cell with the tracer started and not, in turns, in one process.

    python3 scripts/torch_tracer_cost.py [--workload CELL] [--pairs 2]
        [--seconds 51] [--seed N] [--out FILE.json]

Each round runs `portbench.harness.run(CELL, ..., trace=False)` twice,
once as it is and once with `miotts_tpu_torch.runtime.profile.tracer`
started before it (spans kept in memory, no profiler), alternating which
goes first; the seed goes up by one a round.  Prints each run's
`audio_x_realtime`, `ttfa_p50_s` and spans kept, and the medians.  The
tracer off is the program as every untraced run has it.  A run with the
tracer on also gives the LLM step's host time with no profiler running:
the mean `llm.step` span and each span's self time per step (ms).  Needs
a GPU; imports nothing of JAX."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def step_split(tracer) -> dict:
    """Mean `llm.step` duration and each span name's self time per step,
    in ms, over the spans kept (warm-up, lead-in, window and drain)."""
    rows, own = tracer.spans, tracer.self_ns()
    steps = [r[2] - r[1] for r in rows if r[0] == "llm.step"]
    if not steps:
        return {}
    by: dict = {}
    for r, ns in zip(rows, own):
        if r[4] < 0:
            by[r[0]] = by.get(r[0], 0) + ns
    return {"step_host_ms": 1e-6 * sum(steps) / len(steps),
            "self_ms_per_step": {k: 1e-6 * v / len(steps)
                                 for k, v in sorted(by.items())}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="lfm2-1.2b.serve64-closed")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seed", type=int, default=3_900_000_001)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from miotts_tpu_torch.runtime.profile import tracer
    from portbench import harness

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    runs = []
    for i in range(args.pairs):
        order = ("off", "on") if i % 2 == 0 else ("on", "off")
        for mode in order:
            if mode == "on":
                tracer.start()
            try:
                r = harness.run(args.workload, args.seed + i, args.seconds,
                                False)
            finally:
                kept = len(tracer.spans) if tracer.on else 0
                split = step_split(tracer) if tracer.on else {}
                tracer.stop()
                tracer.spans = []
            m = {k: v["value"] for k, v in r["metrics"].items()}
            row = {"round": i, "tracer": mode, "seed": args.seed + i,
                   "correct": r["correct"], "spans": kept,
                   "audio_x_realtime": m["audio_x_realtime"],
                   "ttfa_p50_s": m["ttfa_p50_s"], **split}
            runs.append(row)
            print(json.dumps(row), flush=True)
    med = {mode: {k: statistics.median(r[k] for r in runs
                                       if r["tracer"] == mode)
                  for k in ("audio_x_realtime", "ttfa_p50_s")}
           for mode in ("off", "on")}
    out = {"card": card.strip(), "workload": args.workload, "runs": runs,
           "medians": med}
    print(json.dumps({"medians": med, "card": card.strip()}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
