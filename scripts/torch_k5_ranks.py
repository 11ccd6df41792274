"""Time K5, the single-query decode-attention kernel
(miotts_tpu_torch/ops/csrc/decode_attn_single.cu), under forced cluster
sizes, on one GPU: the numbers its plan (`ops/decode_attn.py:_single_plan`)
is read against.

    python3 scripts/torch_k5_ranks.py [--out OUT.json] [--ranks 1,2,4,8]
        [--modes bf16,f32,int8] [--no-sweep] [--no-timeline]

At each of chip_smoke.py's phase 10 shapes (its inputs: B = 1 rows of 3/4
of S less 2 valid keys, staggered rows with an idle one at B > 1), every
forced rank count is checked against the plain version (1e-5) and timed as
phase 10 times the kernel (CUDA-graph replay over cache copies larger than
the L2), the rank counts in order and then in reverse order; each row
prints both passes' times, the plan's ranks and the fastest count.

Then the timeline: the source built again with -DK5_CLOCKS into
build/k5_clocks/ and swapped in for the port's library records each
block's SM clock at the marks of its first chunk (copies issued, k landed,
scores, p and v landed, PV, key groups summed, the cluster's start barrier
waited, the cluster barrier passed, exit); printed as the mean and the
largest microseconds from entry over the blocks of one launch, at the
card's maximum SM clock, for the LFM2 B = 1 rows on the plan's ranks and
on one rank, with the spread of the global timer at entry over each
cluster's blocks (mean and largest over the clusters)."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


MARK_NAMES = ("issued", "k", "scores", "p_v", "pv", "groups", "start_wait",
              "cluster_sync", "exit")
MARKS = 12


def timeline_lib(build_mod):
    """The committed source built with -DK5_CLOCKS (its header from the
    sources), loaded with the port's argtypes and the clocks reader."""
    d = os.path.join(ROOT, "build", "k5_clocks")
    os.makedirs(d, exist_ok=True)
    out = os.path.join(d, "libdecode_attn_single_clocks.so")
    src = str(build_mod.CSRC / build_mod.KERNELS["decode_attn_single"][0])
    done = subprocess.run([build_mod._nvcc(), *build_mod.NVCC_FLAGS,
                           "-DK5_CLOCKS", "-o", out, src],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for the timeline build:\n"
                           f"{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(out)
    for fn, argtypes in build_mod.KERNELS["decode_attn_single"][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.decode_attn_single_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.decode_attn_single_clocks.restype = ctypes.c_int
    return lib


def max_sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def timeline(torch, cs, da, build_mod, sms, card) -> list[dict]:
    """Each block's marks of one launch, at the LFM2 B = 1 rows (bf16, f32,
    int8), on the plan's ranks and on one rank."""
    import numpy as np
    lib = timeline_lib(build_mod)
    build_mod.load_kernels()
    committed = build_mod._loaded["decode_attn_single"]
    build_mod._loaded["decode_attn_single"] = lib
    mhz = max_sm_mhz()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows = []
    try:
        for label, B, H, H_kv, D, S in cs.K5_SHAPES:
            if label != "lfm2-1.2b" or B != 1:
                continue
            plan = da._single_plan(B, H_kv, S, sms).ranks
            for mode in ("bf16", "f32", "int8"):
                inp = cs.k5_inputs(torch, B, H, H_kv, D, S, mode, gen)
                want = da.decode_attention_plain(*inp)
                for r in sorted({plan, 1}, reverse=True):
                    p = da.AttnPlan(ranks=r)
                    for _ in range(3):
                        da.decode_attention(*inp, plan=p)
                    torch.cuda.synchronize()
                    blocks = r * B * H_kv
                    host = np.zeros((blocks, MARKS), np.int64)
                    lib.decode_attn_single_clocks(host.ctypes.data, blocks)
                    got = da.decode_attention(*inp, plan=p)
                    torch.cuda.synchronize()
                    if not cs.rel_err(got, want) < cs.K5_TOL:
                        raise AssertionError(f"timeline build {label} S={S} "
                                             f"{mode} ranks={r}: wrong")
                    err = lib.decode_attn_single_clocks(host.ctypes.data,
                                                        blocks)
                    if err:
                        raise RuntimeError(f"clocks read: CUDA error {err}")
                    us = (host[:, 1:10] - host[:, :1]) / mhz
                    # one rank takes no cluster barrier: no marks 7, 8
                    names = [n for n in MARK_NAMES if r > 1 or n not in (
                        "start_wait", "cluster_sync")]
                    cols = [MARK_NAMES.index(n) for n in names]
                    # blocks of a cluster are consecutive: blockIdx.x is
                    # the rank
                    entry = host[:, 11].reshape(-1, r) / 1e3
                    spread = entry.max(1) - entry.min(1)
                    row = dict(S=S, mode=mode, ranks=r,
                               keys_max=int(host[:, 10].max()), mhz=mhz,
                               entry_spread_us=[float(spread.mean()),
                                                float(spread.max())],
                               mean_us=dict(zip(names, us[:, cols].mean(
                                   0).round(3).tolist())),
                               max_us=dict(zip(names, us[:, cols].max(
                                   0).round(3).tolist())))
                    rows.append(row)
                    marks = "  ".join(
                        f"{n} {row['mean_us'][n]:.2f}/{row['max_us'][n]:.2f}"
                        for n in names)
                    cs.log(f"k5 timeline S={S:<4d} {mode:4s} ranks {r} keys "
                           f"{row['keys_max']:<4d} us from entry (mean/max): "
                           f"{marks}  entry spread in a cluster "
                           f"{spread.mean():.2f}/{spread.max():.2f}  [{card}, "
                           f"{mhz:.0f} MHz]")
    finally:
        build_mod._loaded["decode_attn_single"] = committed
    return rows


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--ranks", default="1,2,3,4,6,8")
    ap.add_argument("--modes", default="bf16,f32,int8")
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--no-timeline", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k5_ranks: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from miotts_tpu_torch.ops import _build, decode_attn as da, qmat
    card = cs.nvidia_smi_line()
    cs.log(f"device: {card}")
    for name, text in _build.build_all().items():
        for line in text.splitlines():
            if name.startswith("decode_attn") and ("Used" in line
                                                   or "spill" in line):
                cs.log(f"build {name}: {line.strip()}")
    sms = qmat._sm_count(torch.device("cuda"))
    ranks = [int(t) for t in args.ranks.split(",")]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rows = []
    for label, B, H, H_kv, D, S in ([] if args.no_sweep else cs.K5_SHAPES):
        plan = da._single_plan(B, H_kv, S, sms).ranks
        for mode in args.modes.split(","):
            inp = cs.k5_inputs(torch, B, H, H_kv, D, S, mode, gen)
            q, k, v, fill, q_pos, ks, vs = inp
            want = da.decode_attention_plain(*inp)
            for r in ranks:
                got = da.decode_attention(*inp, plan=da.AttnPlan(ranks=r))
                torch.cuda.synchronize()
                e = cs.rel_err(got, want)
                if not e < cs.K5_TOL:
                    raise AssertionError(f"k5 {label} S={S} {mode} ranks={r}"
                                         f": rel err {e}")
            cache_bytes = 2 * k.numel() * k.element_size() + (
                0 if ks is None else 2 * ks.numel() * 4)
            n_copies = max(2, min(512, -(-cs.L2_FLUSH_BYTES // cache_bytes)))
            copies = [(k, v, ks, vs)] + [
                (k.clone(), v.clone(), None if ks is None else ks.clone(),
                 None if vs is None else vs.clone())
                for _ in range(n_copies - 1)]

            def timed(r):
                p = da.AttnPlan(ranks=r)

                def kern(i):
                    c = copies[i % n_copies]
                    return da.decode_attention(q, c[0], c[1], fill, q_pos,
                                               c[2], c[3], plan=p)
                return cs.graph_ms(torch, kern, n_copies)
            fwd = {r: timed(r) for r in ranks}
            back = {r: timed(r) for r in reversed(ranks)}
            best = min(ranks, key=lambda r: fwd[r] + back[r])
            limit = torch.minimum(fill, q_pos + 1).clamp(0, S)
            row = dict(shape=label, B=B, H=H, H_kv=H_kv, D=D, S=S, mode=mode,
                       valid_keys=int(limit.sum()), plan_ranks=plan,
                       best_ranks=best, us={r: [1e3 * fwd[r], 1e3 * back[r]]
                                            for r in ranks})
            rows.append(row)
            times = "  ".join(f"{r}: {1e3 * fwd[r]:.2f}/{1e3 * back[r]:.2f}"
                              for r in ranks)
            cs.log(f"k5 ranks {label} B={B} D={D} S={S:<4d} {mode:4s} "
                   f"keys {row['valid_keys']:<4d} plan {plan} best {best}  "
                   f"us {times}  [{card}]")
            del copies
            torch.cuda.empty_cache()
    marks = ([] if args.no_timeline
             else timeline(torch, cs, da, _build, sms, card))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=rows, timeline=marks), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
