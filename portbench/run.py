"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>
    python3 portbench/run.py --list

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device[, breakdown], compared); the numbers compared
with their limits are also the last lines of standard error.  Exits
non-zero, printing no result, without a CUDA device, or when JAX or the
JAX package has been loaded by the time the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true",
                    help="print the cells, architectures and per-layer "
                    "metrics found")
    args = ap.parse_args()
    # build and kernel caches stay inside the checkout, at fixed paths
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / "build" / "portbench" / "nv_cache"))
    sys.path.insert(0, str(ROOT))
    from portbench import harness, weights

    if args.list:
        print(json.dumps({"workloads": harness.workloads(),
                          "archs": weights.archs(),
                          "per_layer": sorted(harness.metric_modules())}))
        return 0
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA device; no result", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad} in the measuring process; no result",
              file=sys.stderr)
        return 3
    for key, c in result["compared"].items():
        print(f"compared {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
