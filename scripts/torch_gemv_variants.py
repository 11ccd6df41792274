"""Time the split-K GEMV shared by K1, K1v, K2 (M = 1), K3, K4a and K4b
(miotts_tpu_torch/ops/csrc/qdot_gemv.cuh) against variants of its design,
on one GPU.

    python3 scripts/torch_gemv_variants.py [--out chiprun_out/gemv_variants.json]
        [--variants committed,team4,...]

Each variant is the committed header with one design choice changed (rows
of a chunk, warps of a block, lanes of a team where rows are or are not
16-byte aligned, the blocks an SM the registers must allow, how unaligned
rows and their x are read, when their scales are loaded; for K4's
integer-partial form: f32 products on xq in place of __dp4a; x quantized
once a block into shared memory, or in each chunk, on every row layout) or the plan's blocks per SM changed.  Each is built by nvcc into build/gemv_variants/
(the K2 / K3 library, qdot_gemv.cu, and the K1v library, qdot_bf16.cu,
against the changed header) and swapped in for the port's libraries.  K3 at bf16 x is K1's instantiation at bf16 x, so its
rows are K1's decode rows.  Every variant is checked against the plain
versions (bf16, 1e-2) and timed as chip_smoke.py times a kernel: CUDA-graph
replay over weight copies larger than the L2.  The variants run in order,
then in reverse order, each on the same x.  K4 is also timed on an x
with an all-zero quant group (as chip_smoke.py's phase 14 has: an exactly
zero x takes IEEE division's slow path).  K4's variants that keep its
integer partials (SAME_BITS) must give the committed header's bits.
Prints, per run, the µs of each shape and one 2.6B-Q4_K_M decode step of
K2, K3 (= K1), K1v (mode after), K4a and K4b work, bf16 x."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LIBS = ("qdot_gemv", "qdot_bf16")     # the libraries rebuilt per variant

# unaligned rows read as two aligned 16-byte blocks and a select of their
# words (the earlier reading), not as five 4-byte words
_BLOCKS16 = ("""  const size_t base = a & ~(size_t)3;
  const unsigned sh = 8 * (unsigned)(a & 3);
  uint32_t sel[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    sel[i] = base + 4 * i < end
        ? __ldg(reinterpret_cast<const uint32_t*>(v + base) + i) : 0u;
""", """  const size_t base = a & ~(size_t)15;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const uint4 b0 = base < end ? __ldg(reinterpret_cast<const uint4*>(v + base)) : z;
  const uint4 b1 = base + 16 < end
      ? __ldg(reinterpret_cast<const uint4*>(v + base + 16)) : z;
  const uint32_t w[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const unsigned off = (unsigned)(a & 15), wi = off >> 2, sh = 8 * (off & 3);
  uint32_t sel[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    sel[i] = wi == 0 ? w[i] : wi == 1 ? w[i + 1] : wi == 2 ? w[i + 2] : w[i + 3];
""")


def _const(name: str, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


def _replace_fn(marker: str, new: str):
    """Replace the whole function whose signature line holds `marker`
    (from its `template` line to its closing brace) by `new`."""
    def sub(hdr: str) -> str:
        at = hdr.index(marker)
        start = hdr.rindex("template <", 0, at)
        end = hdr.index("\n}\n", at) + 3
        return hdr[:start] + new + hdr[end:]
    return sub


# K4 with K3's f32 products on xq in place of __dp4a: P exact (integers
# below 2^24), so the same bits
_K4_F32 = [("    int d[16];\n", "    float d[16];\n"),
           _replace_fn("void int_products(", """template <bool PACKED, int R>
__device__ __forceinline__ void int_products(float (&d)[16], const uint4 (&w)[R],
                                             const uint32_t (&ql)[R / 4],
                                             const uint32_t (&qh)[R / 4]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float xa = (float)(int8_t)(ql[r / 4] >> (8 * (r % 4)));
    const float xb = (float)(int8_t)(qh[r / 4] >> (8 * (r % 4)));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t wd = word_of(w[r], q);
      if constexpr (PACKED) {
        const uint32_t lo = wd & 0x0F0F0F0Fu, hi = (wd >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[4 * q + j] = fmaf(xa, qtile::i8_f32(lo, j), d[4 * q + j]);
          d[4 * q + j] = fmaf(xb, qtile::i8_f32(hi, j), d[4 * q + j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          d[4 * q + j] = fmaf(xa, qtile::i8_f32(wd, j), d[4 * q + j]);
      }
    }
  }
}
""")]

# K4's xq from the block's K slice in shared memory on aligned rows too, or
# quantized in each chunk on unaligned rows too: the same bits
_XQ = "return form == INT_PARTIAL && !aligned;"


def _uteam(n: int):
    """Unaligned rows (the output heads) in teams of n lanes."""
    return ([_const("GEMV_TEAM_UNALIGNED", 8, n)], {"GEMV_TEAM_UNALIGNED": n})


# name: (substitutions in qdot_gemv.cuh, the plan's constants in ops/qmat.py)
VARIANTS = {
    "committed": ([], {}),
    "rows16": ([("constexpr int R = RPG < 8 ? RPG : 8;",
                 "constexpr int R = RPG < 16 ? RPG : 16;")], {}),
    "warps8": ([_const("GEMV_WARPS", 4, 8)], {}),
    "team4": ([_const("GEMV_TEAM", 2, 4)], {"GEMV_COLS": 64}),
    "blocks4": ([], {"GEMV_BLOCKS_PER_SM": 4}),
    "minblocks1": ([_const("GEMV_MIN_BLOCKS", 4, 1),
                    _const("GEMV_MIN_BLOCKS_UNALIGNED", 3, 1)], {}),
    "uteam2": _uteam(2),
    "uteam4": _uteam(4),
    "uteam16": _uteam(16),
    "ublocks16": ([_BLOCKS16], {}),
    "ulate": ([("constexpr bool EARLY = !ALIGNED && !SCALED;",
                "constexpr bool EARLY = false;")], {}),
    "uminblocks4": ([_const("GEMV_MIN_BLOCKS_UNALIGNED", 3, 4)], {}),
    "uminblocks2": ([_const("GEMV_MIN_BLOCKS_UNALIGNED", 3, 2)], {}),
    # x by 16-byte loads where rows are unaligned (x is aligned here)
    "uxvec": ([("load_x<T, R, ALIGNED>(x, k_lo, xl);",
                "load_x<T, R, true>(x, k_lo, xl);"),
               ("load_x<T, R, ALIGNED>(x, k_lo + G / 2, xh);",
                "load_x<T, R, true>(x, k_lo + G / 2, xh);")], {}),
    "k4f32": (_K4_F32, {}),
    "k4slice": ([(_XQ, "return form == INT_PARTIAL;")], {}),
    "k4chunk": ([(_XQ, "return false;")], {}),
    # a zero x divides 1 in its place (no slow path), its xq set to 0
    "k4zsel": ([("""    const int q = max(-127, min(127, __float2int_rn(__fdiv_rn(v[e], sx))));""",
                 """    const bool z = v[e] == 0.f;
    const float qf = __fdiv_rn(z ? 1.f : v[e], sx);
    const int q = z ? 0 : max(-127, min(127, __float2int_rn(qf)));""")], {}),
}
# variants whose K4 must give the committed header's bits
SAME_BITS = ("k4f32", "k4slice", "k4chunk", "k4zsel")


def build(name: str, subs, out_dir: str, build_mod) -> list:
    """Start nvcc on each of LIBS beside the variant's header in
    out_dir/name/ (a quoted include finds that header first; qdot_tile.cuh
    comes from the sources).  Returns the processes."""
    hdr = (build_mod.CSRC / "qdot_gemv.cuh").read_text()
    for sub in subs:
        if callable(sub):
            hdr = sub(hdr)
            continue
        old, new = sub
        if old not in hdr:
            raise RuntimeError(f"variant {name}: {old!r} not in the header")
        hdr = hdr.replace(old, new)
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "qdot_gemv.cuh"), "w") as f:
        f.write(hdr)
    procs = []
    for lib in LIBS:
        src = build_mod.KERNELS[lib][0]
        path = os.path.join(d, src)
        with open(path, "w") as f:
            f.write((build_mod.CSRC / src).read_text())
        cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-I",
               str(build_mod.CSRC), "-o", os.path.join(d, f"{lib}.so"), path]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def load(name: str, out_dir: str, build_mod) -> dict:
    """The variant's libraries, their C functions typed as _build types
    them."""
    libs = {}
    for lib in LIBS:
        cdll = ctypes.CDLL(os.path.join(out_dir, name, f"{lib}.so"))
        for fn, argtypes in build_mod.KERNELS[lib][1].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs[lib] = cdll
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_gemv_variants: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names (default: all)")
    args = ap.parse_args()
    names = [v for v in args.variants.split(",") if v]
    if set(names) - set(VARIANTS):
        ap.error(f"unknown variants {sorted(set(names) - set(VARIANTS))}")
    import chip_smoke as cs
    from miotts_tpu_torch.ops import _build, qmat

    out_dir = os.path.join(ROOT, "build", "gemv_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {name: build(name, VARIANTS[name][0], out_dir, _build)
             for name in names}
    _build.load_kernels()
    libs, regs = {}, {}
    for name, ps in procs.items():
        logs = []
        for proc in ps:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            logs.append(log)
        libs[name] = load(name, out_dir, _build)
        regs[name] = sorted({line.split("Used")[1].split(",")[0].strip()
                             for log in logs for line in log.splitlines()
                             if "Used" in line})

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
        "lfm2 w_down q8_0": q(8192, 2048, "q8_0"),
    }
    # one x a shape, the same in every run (K4's bits are compared), and
    # the same x with quant group 32..63 all zero
    xs = {label: torch.randn((1, qt.k), generator=gen, device="cuda").to(
        torch.bfloat16) for label, qt in cases.items()}
    x0s = {label: x.clone() for label, x in xs.items()}
    for x in x0s.values():
        x[:, 32:64] = 0
    k1v = lambda x, qt: qmat.qdot_bf16(x, qt, "after")
    k1v_plain = lambda x, qt: qmat.qdot_bf16_plain(x, qt, "after")

    def k4_steps(us: dict, z: str) -> tuple[float, float]:
        """One 2.6B step of K4a and of K4b work (ms) from the µs rows of x
        (z "") or of the x with a zero group (z " x0")."""
        k4a = cs.Q4KM_LAYERS * (us["K4a wqkv" + z] + us["K4a w_down" + z])
        k4b = (cs.Q4KM_LAYERS * (us["K4b wo" + z] + us["K4b w_gateup" + z])
               + us["K4b output" + z])
        return k4a / 1e3, k4b / 1e3

    runs, k4_bits = [], {}
    order = names + names[::-1]
    plan_keys = ("GEMV_BLOCKS_PER_SM", "GEMV_COLS", "GEMV_TEAM_UNALIGNED")
    defaults = {k: getattr(qmat, k) for k in plan_keys}
    try:
        for name in order:
            for k, v in dict(defaults, **VARIANTS[name][1]).items():
                setattr(qmat, k, v)
            qmat._gemv_plan.cache_clear()
            _build._loaded.update(libs[name])
            us = {}
            for label, qt in cases.items():
                n_copies = max(2, min(256, -(-cs.L2_FLUSH_BYTES
                                             // cs.qt_bytes(qt))))
                qts = cs.copies_of(torch, qmat, qt, n_copies)
                x = xs[label]
                fns = [("K3", qmat.qdot_group, qmat.qdot_group_plain),
                       ("K1v", k1v, k1v_plain),
                       ("K4b" if qt.packed else "K4a", qmat.qdot_w8a8,
                        qmat.qdot_w8a8_plain)]
                if qt.packed:
                    fns.append(("K2", qmat.qdot_split, qmat.qdot_split_plain))
                for kernel, fn, plain in fns:
                    got = fn(x, qt)
                    e = cs.rel_err(got.float(), plain(x, qt).float())
                    if not e < cs.KERNEL_TOL_BF16:
                        raise AssertionError(f"{name} {kernel} {label}: rel "
                                             f"err {e}")
                    if kernel.startswith("K4"):
                        k4_bits.setdefault(name, {})[label] = got
                        x0 = x0s[label]
                        got0 = fn(x0, qt)
                        e0 = cs.rel_err(got0.float(), plain(x0, qt).float())
                        if not e0 < cs.KERNEL_TOL_BF16:
                            raise AssertionError(f"{name} {kernel} {label}, "
                                                 f"a zero group: rel err {e0}")
                        k4_bits[name][label + " x0"] = got0
                        us[f"{kernel} {label} x0"] = 1e3 * cs.graph_ms(
                            torch, lambda i: fn(x0, qts[i % n_copies]),
                            max(20, min(256, n_copies)))
                    us[f"{kernel} {label}"] = 1e3 * cs.graph_ms(
                        torch, lambda i: fn(x, qts[i % n_copies]),
                        max(20, min(256, n_copies)))
                del qts
            layer = ("wqkv", "wo", "w_gateup", "w_down")
            k2 = (cs.Q4KM_LAYERS * (us["K2 wo"] + us["K2 w_gateup"])
                  + us["K2 output"]) / 1e3
            k3, k1v_step = ((cs.Q4KM_LAYERS * sum(us[f"{k} {n}"] for n in layer)
                             + us[f"{k} output"]) / 1e3 for k in ("K3", "K1v"))
            k4a, k4b = k4_steps(us, "")
            k4a0, k4b0 = k4_steps(us, " x0")
            same = None
            if name in SAME_BITS and "committed" in k4_bits:
                same = all(torch.equal(k4_bits["committed"][k], v)
                           for k, v in k4_bits[name].items())
                if not same:
                    raise AssertionError(f"{name}: K4 differs from the "
                                         f"committed header's bits")
            run = dict(variant=name, us=us, k2_step_ms=k2, k3_step_ms=k3,
                       k1v_step_ms=k1v_step, k4a_step_ms=k4a,
                       k4b_step_ms=k4b, k4a_step_ms_x0=k4a0,
                       k4b_step_ms_x0=k4b0, k4_same_bits=same,
                       registers=regs[name])
            runs.append(run)
            print(f"{name:20s} K2 step {k2:.4f} ms  K3 step {k3:.4f} ms  K1v "
                  f"step {k1v_step:.4f} ms  K4a step {k4a:.4f} ms  K4b step "
                  f"{k4b:.4f} ms (a zero group: {k4a0:.4f} / {k4b0:.4f})  K4 "
                  f"bits {same}  registers {regs[name]}  "
                  + json.dumps({k: round(v, 2) for k, v in us.items()})
                  + f"  [{card}]", flush=True)
    finally:
        for k, v in defaults.items():
            setattr(qmat, k, v)
        qmat._gemv_plan.cache_clear()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
