"""Time the M > 1 tile of K1 and K1v (miotts_tpu_torch/ops/csrc/qdot_tile.cuh)
under other tile heights and split-K counts than ops/qmat.py:_tile_plan
picks, on one GPU.

    python3 scripts/torch_qdot_tile_sweep.py [--out build/tile_sweep.json]

At the serving shapes (LFM2-1.2B-Q8_0 at M = 16, 0.1B-Q8_0 and 2.6B-Q4_K_M
at M = 64; bf16 x) it runs K1 under the plan, under the plan of the other
tile height (16 or 64 rows, at M = 64) and under forced split counts, and
K1v (mode after) under both tile heights: CUDA-graph replay over weight
copies larger than the L2, as chip_smoke.py's phase 2.  Each configuration
is first held against its plain version (1e-2) and for two bit-identical
calls.  It also times the host's share of a tile launch: the plan, the
workspace and the tickets.  Prints one line per configuration with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (label, K, N, format, M)
SHAPES = [("lfm2 out_proj/wo", 2048, 2048, "q8_0", 16),
          ("lfm2 in_proj", 2048, 6144, "q8_0", 16),
          ("lfm2 w_gateup", 2048, 16384, "q8_0", 16),
          ("lfm2 w_down", 8192, 2048, "q8_0", 16),
          ("lfm2 output", 2048, 13059, "q8_0", 16),
          ("0.1b wqkv", 768, 1280, "q8_0", 64),
          ("0.1b wo", 768, 768, "q8_0", 64),
          ("0.1b w_gateup", 768, 4096, "q8_0", 64),
          ("0.1b w_down", 2048, 768, "q8_0", 64),
          ("0.1b output", 768, 13059, "q8_0", 64),
          ("2.6b wqkv (q6_k)", 2560, 3840, "q6_k", 64),
          ("2.6b wo", 2560, 2560, "q4_k", 64),
          ("2.6b w_gateup", 2560, 16384, "q4_k", 64),
          ("2.6b w_down", 8192, 2560, "q6_k", 64)]
FORCED_SPLITS = (1, 2, 4, 8, 16, 32)


def forced(plan, K: int, splits: int):
    """`plan` with K cut into `splits` whole-stage parts (fewer when the
    stages do not fill them)."""
    from miotts_tpu_torch.ops import qmat
    steps = -(-K // qmat.TILE_BK)
    per = -(-steps // splits)
    return dataclasses.replace(plan, splits=-(-steps // per),
                               k_split=per * qmat.TILE_BK)


def host_us(torch, qmat, x, qt) -> float:
    """Microseconds of the host's work before a tile launch (plan,
    workspace, tickets), the mean over 2000 calls."""
    N = qt.values.shape[1]
    for _ in range(100):
        qmat._tile_args("qdot", x, qt, N, None)
    t0 = time.perf_counter()
    for _ in range(2000):
        qmat._tile_args("qdot", x, qt, N, None)
    return (time.perf_counter() - t0) / 2000 * 1e6


def sweep(torch, cs, qmat, card: str) -> list[dict]:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for label, K, N, fmt, M in SHAPES:
        qt = cs.rand_qtensor(torch, qmat, K, N, fmt, gen)
        n_copies = max(2, min(256, -(-cs.L2_FLUSH_BYTES // cs.qt_bytes(qt))))
        qts = cs.copies_of(torch, qmat, qt, n_copies)
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        sms = qmat._sm_count(x.device)
        default = qmat._tile_plan(M, K, N, qt.group, sms)
        configs = [("K1", "plan", default)]
        for bm in ((16, 64) if M > 16 else (16,)):
            own = qmat._plan_for(bm, M, K, N, qt.group, sms)
            if bm != default.bm:
                configs.append(("K1", "other bm", own))
            configs += [("K1", "forced", p) for p in sorted(
                {forced(own, K, s) for s in FORCED_SPLITS} - {own},
                key=lambda p: p.splits)]
            if M > 16:
                configs.append(("K1v", "plan" if bm == default.bm
                                else "other bm", own))
        for kernel, kind, p in configs:
            if kernel == "K1":
                run = lambda q, p=p: qmat._qdot_cuda(x, q, p)
                want = qmat.qdot_plain(x, qt)
            else:
                run = lambda q, p=p: qmat._qdot_bf16_cuda(x, q, "after", p)
                want = qmat.qdot_bf16_plain(x, qt, "after")
            got = run(qt)
            e = cs.rel_err(got.float(), want.float())
            same = torch.equal(got, run(qt))
            if not (e < cs.KERNEL_TOL_BF16 and same):
                raise AssertionError(f"{kernel} {label} {p}: rel err {e}, "
                                     f"bit-identical {same}")
            ms = cs.graph_ms(torch, lambda i: run(qts[i % n_copies]),
                             max(20, min(256, n_copies)))
            nbytes = cs.qt_bytes(qt) + 2 * M * K + 2 * M * N
            rows.append(dict(kernel=kernel, shape=label, M=M, K=K, N=N,
                             bm=p.bm, splits=p.splits, kind=kind, ms=ms,
                             bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3))
            print(f"{kernel:3s} {label:18s} M={M:<3d} bm={p.bm:<2d} "
                  f"splits={p.splits:<3d} {kind:8s} {ms:.4f} ms  [{card}]",
                  flush=True)
        us = host_us(torch, qmat, x, qt)
        rows.append(dict(kernel="host", shape=label, M=M, K=K, N=N,
                         splits=default.splits, host_us=us))
        print(f"host {label:18s} M={M:<3d} plan + workspace + tickets "
              f"{us:.2f} us a launch", flush=True)
        del qts
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "tile_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tile sweep: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from miotts_tpu_torch.ops import _build, qmat
    card = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    rows = sweep(torch, cs, qmat, card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, rows=rows), f)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
