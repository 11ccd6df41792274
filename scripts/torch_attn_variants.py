"""Time K6, the batched decode-attention kernel
(miotts_tpu_torch/ops/csrc/decode_attn.cu), against variants of its ring,
and read each block's timeline, on one GPU.

    python3 scripts/torch_attn_variants.py [--out OUT.json]
        [--variants committed,sub64,...] [--no-timeline] [--timeline-only]

Each variant is a copy of the committed source with one choice of its
`Layout` rewritten (sub64: 64 keys a ring slot, where the committed one
takes 128 where that is <= 24 KB; tpk1, sub64tpk2: 1 or 2 score lanes a
key, where it takes 256 / the slot's keys, one pass a slot; ring48,
ring64: the ring's budget, which sets its depth, 2-4 slots; unpadded: rows
without padding where a score lane's chunks are odd, which fits 4 bf16 D =
80 blocks an SM), built by nvcc into build/attn_variants/<name>/ and
swapped in for the port's library.  Every variant is checked against the plain version (bf16
1e-2, int8 1e-2 of the row scale) and timed as chip_smoke.py's phase 6
times the kernel (CUDA-graph replay over cache copies larger than the L2),
on the plan's cluster split and on one rank, at phase 6's shapes, in order
and then in reverse order.  The timeline build (K6_CLOCKS) records each
block's SM clock at the marks of its first tile (entry, ring's first
copies issued, q loaded, first k slot landed, scores, the cluster's row
maxima, softmax done, PV done, the cluster's partials, the last cluster
barrier, exit) and the global timer at entry; printed as the mean and the
largest microseconds from entry over the blocks of one launch, at the
card's maximum SM clock."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_SUB = ("static constexpr int SUB = 128 * (CPR | 1) * 16 <= 24 * 1024 ? 128 "
        ": 64;")
_TPK = "static constexpr int TPK = THREADS / SUB;"
_RING = "constexpr int RING_BYTES = 32 * 1024;"
# each variant: (old, new) replacements of the committed source's text
VARIANTS = {
    "committed": [],
    "sub64": [(_SUB, "static constexpr int SUB = 64;")],
    "sub64tpk2": [(_SUB, "static constexpr int SUB = 64;"),
                  (_TPK, "static constexpr int TPK = 2;")],
    "tpk1": [(_TPK, "static constexpr int TPK = 1;")],
    "ring48": [(_RING, "constexpr int RING_BYTES = 48 * 1024;")],
    "ring64": [(_RING, "constexpr int RING_BYTES = 64 * 1024;")],
    "unpadded": [("static constexpr int RS = CPR | 1;",
                  "static constexpr int RS = CPL % 2 ? TPK * CPL : CPR | 1;")],
}
MARK_NAMES = ("issued", "q", "k_slot", "scores", "maxima", "softmax",
              "v_slot", "pv", "partials", "last_sync", "exit")
MARKS = 14


def variant_source(name: str, src: str) -> str:
    """The committed source `src` with variant `name`'s replacements."""
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    return src


def build_all(names, out_dir: str, build_mod) -> dict:
    """nvcc every variant (and the timeline build: the committed source
    with -DK6_CLOCKS) at once, each from its own copy of the source in
    out_dir/name/ (attn_common.cuh from the sources)."""
    src = (build_mod.CSRC / "decode_attn.cu").read_text()
    procs = {}
    for name in names:
        clocks = name == "clocks"
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "decode_attn.cu")
        with open(path, "w") as f:
            f.write(src if clocks else variant_source(name, src))
        out = os.path.join(d, "libdecode_attn.so")
        cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS,
               *(["-DK6_CLOCKS"] if clocks else []), "-I",
               str(build_mod.CSRC), "-o", out, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [int(w) for line in log.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = [int(line.split()[4]) for line in log.splitlines()
                  if "bytes spill stores" in line]
        print(f"build {name}: registers {min(regs)}-{max(regs)}, spill "
              f"stores up to {max(spills)} bytes")
        lib = ctypes.CDLL(out)
        for fn, argtypes in build_mod.KERNELS["decode_attn"][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def max_sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def check(torch, da, inp, label: str) -> None:
    got = da.decode_attention_batched(*inp)
    want = da.decode_attention_batched_plain(*inp)
    torch.cuda.synchronize()
    scale = want.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    e = float(((got - want).abs() / scale).max())
    if not e < 1e-2:
        raise AssertionError(f"{label}: kernel vs plain err {e}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_attn_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from miotts_tpu_torch.ops import _build, qmat
    from miotts_tpu_torch.ops import decode_attn as da
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--no-timeline", action="store_true")
    ap.add_argument("--timeline-only", action="store_true")
    args = ap.parse_args()
    names = [n for n in args.variants.split(",") if n]
    card = cs.nvidia_smi_line()
    _build.load_kernels()
    libs = build_all(names + ([] if args.no_timeline else ["clocks"]),
                     os.path.join(ROOT, "build", "attn_variants"), _build)
    sms = qmat._sm_count(torch.device("cuda"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cases = []
    for label, B, H, H_kv, D, S in cs.ATTN_SHAPES:
        for mode in ("bf16", "int8"):
            inp = cs.attn_inputs(torch, B, H, H_kv, D, S, mode, gen)
            k = inp[1]
            n_copies = max(2, min(64, -(-cs.L2_FLUSH_BYTES
                                        // (2 * k.numel() * k.element_size()))))
            copies = [inp[1:3] + inp[5:7]] + [
                tuple(None if t is None else t.clone()
                      for t in inp[1:3] + inp[5:7])
                for _ in range(n_copies - 1)]
            cases.append((f"{label} B={B} S={S} {mode}", inp, copies,
                          da._attn_plan(B, H_kv, S, sms)))
    res = {"card": card, "times": {}, "timeline": {}}

    def timed(name: str) -> None:
        _build._loaded["decode_attn"] = libs[name]
        out = res["times"].setdefault(name, {})
        for label, inp, copies, plan in cases:
            check(torch, da, inp, f"{name} {label}")
            q, fill, q_pos = inp[0], inp[3], inp[4]
            n = len(copies)
            row = out.setdefault(label, {"ranks": plan.ranks, "ms": [],
                                         "one_rank_ms": []})
            for key, p in (("ms", plan), ("one_rank_ms", da.AttnPlan(1))):
                row[key].append(cs.graph_ms(
                    torch, lambda i, p=p: da.decode_attention_batched(
                        q, copies[i % n][0], copies[i % n][1], fill, q_pos,
                        copies[i % n][2], copies[i % n][3], plan=p),
                    max(20, n)))
            torch.cuda.empty_cache()

    for order in ((names, names[::-1]) if not args.timeline_only else ()):
        for name in order:
            timed(name)
    for name, rows in res["times"].items():
        for label, row in rows.items():
            print(f"{name:10s} {label:28s} {row['ranks']} ranks "
                  f"{' / '.join(f'{t * 1e3:.2f}' for t in row['ms'])} us, "
                  f"one rank {' / '.join(f'{t * 1e3:.2f}' for t in row['one_rank_ms'])}"
                  f" us  [{card}]")

    if not args.no_timeline:
        _build._loaded["decode_attn"] = libs["clocks"]
        mhz = max_sm_mhz()
        res["timeline_sm_mhz"] = mhz
        for label, inp, _, plan in cases:
            for ranks in sorted({plan.ranks, 1}):
                B, H_kv = inp[1].shape[0], inp[1].shape[1]
                blocks = ranks * B * H_kv
                host = (ctypes.c_longlong * (MARKS * blocks))()
                libs["clocks"].decode_attn_clocks(host, blocks)   # zeros
                da.decode_attention_batched(*inp, plan=da.AttnPlan(ranks))
                torch.cuda.synchronize()
                err = libs["clocks"].decode_attn_clocks(host, blocks)
                if err:
                    raise RuntimeError(f"decode_attn_clocks: CUDA error {err}")
                t = torch.tensor(list(host), dtype=torch.float64).reshape(
                    blocks, MARKS)
                # blocks with a first tile (an idle row's marks stay 0)
                busy = (t[:, 1:12] > 0).all(dim=1)
                cyc = (t[busy, 1:12] - t[busy, :1]) / mhz      # us from entry
                start = (t[:, 12] - t[:, 12].min()) * 1e-3
                keys = t[busy, 13]
                tl = {"mean_us": dict(zip(MARK_NAMES, cyc.mean(0).tolist())),
                      "max_us": dict(zip(MARK_NAMES, cyc.amax(0).tolist())),
                      "start_spread_us": float(start.max()),
                      "blocks": blocks, "busy_blocks": int(busy.sum()),
                      "mean_keys": float(keys.mean()),
                      "max_keys": float(keys.max())}
                res["timeline"][f"{label} ranks={ranks}"] = tl
                print(f"timeline {label:28s} ranks={ranks} blocks={blocks} "
                      f"keys {tl['mean_keys']:.0f} (max {tl['max_keys']:.0f}) "
                      f"starts over {tl['start_spread_us']:.2f} us; mean us "
                      + " ".join(f"{k} {v:.2f}" for k, v in
                                 tl["mean_us"].items())
                      + f"; max exit {tl['max_us']['exit']:.2f}  [{card}]")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
