"""The readings that the limits of `correct` are set from: for each seed,
one run of a cell at its own size and load, judged against the reference
(the lower reading), with the control (the reference one precision lower
put in the program's place) read over the same prompts and tokens (the
upper reading).  All seeds run in one process, one line of JSON each.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 40 [--out chiprun_out/control.jsonl]

The control is held to the cell's limits as the program is: the script
exits 1 if the control comes out correct on any seed, or the program
not correct.  The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    ok = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.run(args.workload, seed, args.seconds, False,
                        control=True)
        line = json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": r["correct"], "attempted": r["attempted"],
            "program": {k: c["value"] for k, c in r["compared"].items()},
            "control": r["control"],
            "control_correct": r["control_correct"],
            "metrics": {k: m["value"] for k, m in r["metrics"].items()},
            "seconds": time.perf_counter() - t})
        print(line, flush=True)
        ok = ok and r["correct"] and not r["control_correct"]
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
