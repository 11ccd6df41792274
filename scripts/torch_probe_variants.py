"""Time the bandwidth-floor probes (miotts_tpu_torch/ops/csrc/dma_floor.cu)
against variants of their design, on one GPU.

    python3 scripts/torch_probe_variants.py [--out OUT.json]
        [--variants committed,regload,...] [--no-k7]

K8 (the floor of K1's M = 1 split-K GEMV): each variant is the committed
source with one choice changed (chunks in flight, quant groups a chunk,
K1's own loads in place of the cp.async ring, wider blocks of columns than
K1's, the same bytes streamed contiguously), built by nvcc into build/probe_variants/<name>/ and swapped in for
the port's library.  `regload` streams aligned rows as K1 does: a team of
two lanes reads a 32-byte sector of 8 rows of a quant group by 16-byte
register loads, all issued before any is used, then the group's scales as
float4, every word folded into a XOR that is stored only if it equals a
magic value (so no load can be dropped).  `cols128` covers 128 columns a
block on aligned rows too (not K1's layout: the price of its 32-byte
rows); `flat` streams the same bytes in the same grid and ring as
contiguous 16-byte pieces, block b the b-th share of each tensor (the floor
of the bytes in any layout; the output still comes from the column's
rows).
Every variant is checked against the plain version (1e-6) and timed as
chip_smoke.py's phase 18 times a probe: CUDA-graph replay over copies
larger than the L2, at bench_qmat.py's 2.6B shapes and the two Q8_0
output heads, on the variant's plan; K1 at M = 1 (bf16 x) on the same
copies beside it.  The variants run in order, then in reverse order.

K7 (the floor of K5's cluster split): the committed kernel under forced
cluster sizes 1-8 at chip_smoke.py's phase 10 shapes (bf16 cache), bit for
bit the plain version, in order and in reverse order, beside K5 on its
plan (`_single_plan`) at the same shape.

Prints per run the µs of each shape and the 2.6B step (32 x the 4
bench_qmat shapes) of K8 and K1 with their GB/s."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_RING_PROLOGUE = """#pragma unroll
  for (int j = 0; j < K8_STAGES; ++j) issue(j);

  // the output rows of the slice"""
_RING_LOOP = """  for (int j = 0; j < n_chunks; ++j) {
    cp_wait<K8_STAGES - 1>();
    issue(j + K8_STAGES);
  }
  cp_wait<0>();

  // the cluster's partial sums"""
_KERNEL = "template <bool ALIGNED, typename S>\n__global__"

# K1's loads on aligned rows (qdot_gemv.cuh: a team of two lanes, 16
# columns a lane, a chunk of 8 rows of one quant group, chunk ci to team
# ci % 64 of the block), no products; unaligned rows keep the ring
_REGLOAD = [
    (_KERNEL, "__device__ uint32_t k8_sink;\n\n" + _KERNEL),
    (_RING_PROLOGUE, """  if constexpr (!ALIGNED) {
#pragma unroll
    for (int j = 0; j < K8_STAGES; ++j) issue(j);
  }

  // the output rows of the slice"""),
    (_RING_LOOP, """  if constexpr (ALIGNED) {
    const int lane = tid & 31, warp = tid >> 5;
    const int c0 = n0 + 16 * (lane % 2);
    uint32_t chk = 0;
    if (c0 < N) {
      const int n_ch = (k1 - k0) / 8;
      for (int ci = 16 * warp + lane / 2; ci < n_ch; ci += 64) {
        const int row0 = k0 + ci * 8;
        uint4 w[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          w[r] = __ldg(reinterpret_cast<const uint4*>(v + (size_t)(row0 + r) * N + c0));
        // 16 columns of scales: four 16-byte loads of f32, two of bf16
        const uint4* sp = reinterpret_cast<const uint4*>(s + (size_t)(row0 / G) * N + c0);
        uint4 sv[sizeof(S)];
#pragma unroll
        for (int i = 0; i < (int)sizeof(S); ++i) sv[i] = __ldg(sp + i);
#pragma unroll
        for (int r = 0; r < 8; ++r) chk ^= w[r].x ^ w[r].y ^ w[r].z ^ w[r].w;
#pragma unroll
        for (int i = 0; i < (int)sizeof(S); ++i) chk ^= sv[i].x ^ sv[i].y ^ sv[i].z ^ sv[i].w;
      }
    }
    if (chk == 0x7FBADCAFu) k8_sink = chk;
  } else {
    for (int j = 0; j < n_chunks; ++j) {
      cp_wait<K8_STAGES - 1>();
      issue(j + K8_STAGES);
    }
    cp_wait<0>();
  }

  // the cluster's partial sums"""),
]


# the same bytes streamed as contiguous 16-byte pieces (block b of the
# grid takes the b-th share of v's pieces and of s's), in the same grid,
# ring and chunk bytes: the floor of the bytes in any layout
_FLAT_START = "  const int n_chunks = (k1 - k0 + L::ROWS - 1) / L::ROWS;\n"
_FLAT = """  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);
  const unsigned char* sb = reinterpret_cast<const unsigned char*>(s);
  const size_t v_end = (size_t)K * N, s_end = (size_t)(K / G) * N * SB;
  const long long nb = (long long)gridDim.x * gridDim.y;
  const long long bid = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const long long pv = (long long)((v_end + 15) / 16), ps = (long long)((s_end + 15) / 16);
  const long long v_lo = min(pv, bid * ((pv + nb - 1) / nb));
  const long long v_hi = min(pv, v_lo + (pv + nb - 1) / nb);
  const long long s_lo = min(ps, bid * ((ps + nb - 1) / nb));
  const long long s_hi = min(ps, s_lo + (ps + nb - 1) / nb);
  const long long n_v = v_hi - v_lo, n_all = n_v + (s_hi - s_lo);
  constexpr int CP = L::SLOT / 16;
  const int n_chunks = (int)((n_all + CP - 1) / CP);
  auto issue = [&](int j) {
    unsigned char* slot = ring + (size_t)(j % K8_STAGES) * L::SLOT;
    const long long i0 = (long long)j * CP;
    const int n = j < n_chunks ? (int)min((long long)CP, n_all - i0) : 0;
    for (int i = tid; i < n; i += K8_THREADS) {
      const long long q = i0 + i;
      if (q < n_v) copy_piece(slot + 16 * i, vb, 16 * (v_lo + q), v_end, 0, v_end);
      else copy_piece(slot + 16 * i, sb, 16 * (s_lo + q - n_v), s_end, 0, s_end);
    }
    cp_commit();
  };
"""


def _flat(src: str) -> str:
    """K8's slice streaming (from its n_chunks line to the end of its issue
    lambda) replaced by _FLAT."""
    start = src.index(_FLAT_START)
    end = src.index("    cp_commit();\n  };\n", start) + len("    cp_commit();\n  };\n")
    return src[:start] + _FLAT + src[end:]


def _const(name: str, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


# name: (substitutions in dma_floor.cu, the GEMV plan's constants in
# ops/qmat.py)
VARIANTS = {
    "committed": ([], {}),
    "stages2": ([_const("K8_STAGES", 4, 2)], {}),
    "stages8": ([_const("K8_STAGES", 4, 8)], {}),
    "groups4": ([_const("K8_CHUNK_GROUPS", 8, 4)], {}),
    "groups16": ([_const("K8_CHUNK_GROUPS", 8, 16)], {}),
    "regload": (_REGLOAD, {}),
    "cols128": ([("static constexpr int COLS = ALIGNED ? 32 : 128;",
                  "static constexpr int COLS = 128;")], {"GEMV_COLS": 128}),
    # 128 columns and a quarter of the chunk rows: the same slot bytes
    "cols128g2": ([("static constexpr int COLS = ALIGNED ? 32 : 128;",
                    "static constexpr int COLS = 128;"),
                   _const("K8_CHUNK_GROUPS", 8, 2)], {"GEMV_COLS": 128}),
    "flat": ([_flat], {}),
}


def build(name: str, subs, out_dir: str, build_mod) -> subprocess.Popen:
    """Start nvcc on the variant's copy of dma_floor.cu in out_dir/name/
    (attn_common.cuh from the sources)."""
    src = (build_mod.CSRC / "dma_floor.cu").read_text()
    for sub in subs:
        if callable(sub):
            src = sub(src)
            continue
        old, new = sub
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "dma_floor.cu")
    with open(path, "w") as f:
        f.write(src)
    cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-I", str(build_mod.CSRC),
           "-o", os.path.join(d, "dma_floor.so"), path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def load(name: str, out_dir: str, build_mod) -> ctypes.CDLL:
    lib = ctypes.CDLL(os.path.join(out_dir, name, "dma_floor.so"))
    for fn, argtypes in build_mod.KERNELS["dma_floor"][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def k8_runs(torch, cs, qmat, build_mod, names, libs, card) -> list:
    """Every variant at the K8 shapes, in order then in reverse order."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    cases = [(label, qt) for label, qt in cs.probe_qtensors(torch, qmat, gen)
             if "bench_qmat" in label or "output" in label]
    copies = {}
    for label, qt in cases:
        streamed = qt.values.numel() + qt.scales.numel() * 4
        n = max(2, min(256, -(-cs.L2_FLUSH_BYTES // streamed)))
        copies[label] = (cs.copies_of(torch, qmat, qt, n), streamed + 4 * qt.shape[0])
    xs = {label: torch.randn((1, qt.k), generator=gen, device="cuda").bfloat16()
          for label, qt in cases}
    k1_us = {}
    for label, qt in cases:
        qts, _ = copies[label]
        k1_us[label] = 1e3 * cs.graph_ms(torch, lambda i: qmat._qdot_cuda(
            xs[label], qts[i % len(qts)]), max(20, min(256, len(qts))))
    defaults = {"GEMV_COLS": qmat.GEMV_COLS}
    bench = [label for label, _ in cases if "bench_qmat" in label]
    step_bytes = cs.Q4KM_LAYERS * sum(copies[label][1] for label in bench)
    runs = []
    try:
        for name in names + names[::-1]:
            for k, v in dict(defaults, **VARIANTS[name][1]).items():
                setattr(qmat, k, v)
            qmat._gemv_plan.cache_clear()
            build_mod._loaded["dma_floor"] = libs[name]
            us = {}
            for label, qt in cases:
                qts, _ = copies[label]
                got = qmat.qdot_dma_floor(qt)
                e = cs.rel_err(got, qmat.qdot_dma_floor_plain(qt))
                if not e < cs.PROBE_TOL:
                    raise AssertionError(f"{name} K8 {label}: rel err {e}")
                us[label] = 1e3 * cs.graph_ms(torch, lambda i: qmat.qdot_dma_floor(
                    qts[i % len(qts)]), max(20, min(256, len(qts))))
            step = cs.Q4KM_LAYERS * sum(us[label] for label in bench) / 1e3
            runs.append(dict(variant=name, us=us, step_ms=step,
                             step_tb_s=step_bytes / (step * 1e-3) / 1e12))
            print(f"K8 {name:10s} 2.6B step {step:.4f} ms "
                  f"({runs[-1]['step_tb_s']:.3f} TB/s)  "
                  + json.dumps({k: round(v, 3) for k, v in us.items()})
                  + f"  [{card}]", flush=True)
    finally:
        for k, v in defaults.items():
            setattr(qmat, k, v)
        qmat._gemv_plan.cache_clear()
        build_mod._loaded["dma_floor"] = libs["committed"]
    k1_step = cs.Q4KM_LAYERS * sum(k1_us[label] for label in bench) / 1e3
    print(f"K1 (M=1, bf16 x) 2.6B step {k1_step:.4f} ms on the same copies  "
          + json.dumps({k: round(v, 3) for k, v in k1_us.items()}), flush=True)
    return [dict(runs=runs, k1_us=k1_us, k1_step_ms=k1_step,
                 step_bytes=step_bytes)]


def k7_runs(torch, cs, card) -> list:
    """K7 under forced cluster sizes at phase 10's shapes, beside K5."""
    from miotts_tpu_torch.ops import decode_attn as da
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for label, B, H, H_kv, D, S in cs.K5_SHAPES:
        k, v = (torch.randn((B, H_kv, S, D), generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        streamed = 2 * k.numel() * k.element_size()
        n = max(2, min(512, -(-cs.L2_FLUSH_BYTES // streamed)))
        copies = [(k, v)] + [(k.clone(), v.clone()) for _ in range(n - 1)]
        want = da.dma_floor_plain(k, v)
        us = {}
        for ranks in list(range(1, 9)) + list(range(8, 0, -1)):
            plan = da.AttnPlan(ranks=ranks)
            if not torch.equal(da.dma_floor(k, v, plan), want):
                raise AssertionError(f"K7 {label} S={S} ranks {ranks}: differs")
            t = 1e3 * cs.graph_ms(torch, lambda i: da.dma_floor(
                *copies[i % n], plan), max(20, n))
            us.setdefault(ranks, []).append(t)
        # K5 on its plan at the same shape: phase 10's B = 1 fill (3/4 S - 2)
        q, _, _, fill, q_pos, _, _ = cs.k5_inputs(torch, B, H, H_kv, D, S,
                                                  "bf16", gen)
        k5_us = 1e3 * cs.graph_ms(torch, lambda i: da.decode_attention(
            q, *copies[i % n], fill, q_pos), max(20, n))
        plan = da._single_plan(B, H_kv, S, sms).ranks
        best = min(us, key=lambda r: min(us[r]))
        rows.append(dict(shape=label, B=B, H_kv=H_kv, D=D, S=S, us=us,
                         plan=plan, best=best, k5_plan_us=k5_us))
        print(f"K7 {label} B={B} H_kv={H_kv} D={D} S={S}: plan {plan} ranks, "
              f"fastest {best}; K5 on its plan {k5_us:.3f} us  "
              + "  ".join(f"{r}:{a:.3f}/{b:.3f}" for r, (a, b) in us.items())
              + f"  [{card}]", flush=True)
        del copies
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_probe_variants: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated K8 variants (default: all)")
    ap.add_argument("--no-k7", action="store_true")
    args = ap.parse_args()
    names = [v for v in args.variants.split(",") if v]
    if set(names) - set(VARIANTS) or "committed" not in names:
        ap.error(f"choose from {sorted(VARIANTS)}, committed among them")
    import chip_smoke as cs
    from miotts_tpu_torch.ops import _build, qmat

    out_dir = os.path.join(ROOT, "build", "probe_variants")
    procs = {name: build(name, VARIANTS[name][0], out_dir, _build)
             for name in names}
    _build.load_kernels()
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = load(name, out_dir, _build)
        regs[name] = sorted({line.split("Used")[1].split(",")[0].strip()
                             for line in log.splitlines() if "Used" in line})
    card = cs.nvidia_smi_line()
    print(f"registers {json.dumps(regs)}  [{card}]", flush=True)
    res = {"card": card, "registers": regs,
           "k8": k8_runs(torch, cs, qmat, _build, names, libs, card)}
    if not args.no_k7:
        res["k7"] = k7_runs(torch, cs, card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
