"""Time the split-K GEMV of K2 (M = 1) and K3 (miotts_tpu_torch/ops/csrc/
qdot_gemv.cu) against variants of its design, on one GPU.

    python3 scripts/torch_gemv_variants.py [--out chiprun_out/gemv_variants.json]

Each variant is the committed source with one constant changed (rows of a
chunk, warps of a block, lanes of a team) or the plan's blocks per SM
changed; each is built by nvcc into build/gemv_variants/ and swapped in for
the port's qdot_gemv library.  Every variant is checked against the plain
version (bf16, 1e-2) and timed as chip_smoke.py times a kernel: CUDA-graph
replay over weight copies larger than the L2.  The variants run in order,
then in reverse order.  Prints, per run, the µs of each shape and one
2.6B-Q4_K_M decode step of K2 and of K3 work (bf16 x)."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name: (substitutions in qdot_gemv.cu, GEMV_BLOCKS_PER_SM, GEMV_COLS)
VARIANTS = {
    "committed": ([], 2, 32),
    "rows16": ([("constexpr int R = RPG < 8 ? RPG : 8;",
                 "constexpr int R = RPG < 16 ? RPG : 16;")], 2, 32),
    "warps8": ([("constexpr int GEMV_WARPS = 4;",
                 "constexpr int GEMV_WARPS = 8;")], 2, 32),
    "team4": ([("constexpr int GEMV_TEAM = 2;",
                "constexpr int GEMV_TEAM = 4;")], 2, 64),
    "team8": ([("constexpr int GEMV_TEAM = 2;",
                "constexpr int GEMV_TEAM = 8;")], 2, 128),
    "blocks4": ([], 4, 32),
}


def build(name: str, subs, out_dir: str, build_mod):
    src = (build_mod.CSRC / "qdot_gemv.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-I", str(build_mod.CSRC),
           "-o", path[:-3] + ".so", path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_gemv_variants: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import chip_smoke as cs
    from miotts_tpu_torch.ops import _build, qmat

    out_dir = os.path.join(ROOT, "build", "gemv_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {name: build(name, subs, out_dir, _build)
             for name, (subs, _, _) in VARIANTS.items() if subs or
             name == "committed"}
    _build.load_kernels()
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn, argtypes in _build.KERNELS["qdot_gemv"][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    libs["blocks4"] = libs["committed"]

    card = cs.nvidia_smi_line()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q = lambda k, n, f: cs.rand_qtensor(torch, qmat, k, n, f, gen)
    cases = {
        "wqkv": qmat.concat_qtensors([q(2560, 2560, "q4_k"),
                                      q(2560, 640, "q4_k"),
                                      q(2560, 640, "q6_k")]),
        "wo": q(2560, 2560, "q4_k"),
        "w_gateup": qmat.concat_qtensors([q(2560, 8192, "q4_k"),
                                          q(2560, 8192, "q4_k")]),
        "w_down": q(8192, 2560, "q6_k"),
        "output": q(2560, 13059, "q4_k"),
        "0.1b output q8_0": q(768, 13059, "q8_0"),
        "lfm2 output q8_0": q(2048, 13059, "q8_0"),
    }
    runs = []
    order = list(VARIANTS) + list(reversed(VARIANTS))
    default_bps, default_cols = qmat.GEMV_BLOCKS_PER_SM, qmat.GEMV_COLS
    try:
        for name in order:
            _, bps, cols = VARIANTS[name]
            qmat.GEMV_BLOCKS_PER_SM, qmat.GEMV_COLS = bps, cols
            qmat._gemv_plan.cache_clear()
            _build._loaded["qdot_gemv"] = libs[name]
            us = {}
            for label, qt in cases.items():
                n_copies = max(2, min(256, -(-cs.L2_FLUSH_BYTES
                                             // cs.qt_bytes(qt))))
                qts = cs.copies_of(torch, qmat, qt, n_copies)
                x = torch.randn((1, qt.k), generator=gen,
                                device="cuda").to(torch.bfloat16)
                fns = [("K3", qmat.qdot_group, qmat.qdot_group_plain)]
                if qt.packed:
                    fns.append(("K2", qmat.qdot_split, qmat.qdot_split_plain))
                for kernel, fn, plain in fns:
                    e = cs.rel_err(fn(x, qt).float(), plain(x, qt).float())
                    if not e < cs.KERNEL_TOL_BF16:
                        raise AssertionError(f"{name} {kernel} {label}: rel "
                                             f"err {e}")
                    us[f"{kernel} {label}"] = 1e3 * cs.graph_ms(
                        torch, lambda i: fn(x, qts[i % n_copies]),
                        max(20, min(256, n_copies)))
                del qts
            k2 = (cs.Q4KM_LAYERS * (us["K2 wo"] + us["K2 w_gateup"])
                  + us["K2 output"]) / 1e3
            k3 = (cs.Q4KM_LAYERS * sum(us[f"K3 {n}"] for n in (
                "wqkv", "wo", "w_gateup", "w_down")) + us["K3 output"]) / 1e3
            run = dict(variant=name, us=us, k2_step_ms=k2, k3_step_ms=k3)
            runs.append(run)
            print(f"{name:10s} K2 step {k2:.4f} ms  K3 step {k3:.4f} ms  "
                  + json.dumps({k: round(v, 2) for k, v in us.items()})
                  + f"  [{card}]", flush=True)
    finally:
        qmat.GEMV_BLOCKS_PER_SM, qmat.GEMV_COLS = default_bps, default_cols
        qmat._gemv_plan.cache_clear()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
