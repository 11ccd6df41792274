// The M = 1 GEMV shared by K1 (qdot.cu), K1v (qdot_bf16.cu), K2 and K3
// (qdot_gemv.cu), for Hopper (sm_90a).  It replaces the M = 1 bodies of
// miotts_tpu/ops/qmat.py:_qdot_kernel (bf16_dot=False and True / "after"),
// _qdot_split_kernel and _qdot_group_kernel: every decode step of a single
// stream on the default, split, groupdot and bf16-dot routes.
//
// Two forms of the chunk's products, by the template's SCALED:
//
//   group-partial (K1, K2, K3)
//       y[n] = sum_c ( s[b, n] * P[c, n] - mins[b, n] * X[c] )
//   bf16-weight (K1v)
//       y[n] = sum_c ( Q[c, n] - mins[b, n] * X[c] )
//
// P[c, n] = sum over a chunk c of quant group b of x_k * q[k, n] (f32; every
// product exact for a bf16 x), Q the same with w = bf16(q * s') in place of
// q and bf16(x) in place of x (s' = bf16(s) in mode 1, s in mode after:
// the runtime flag `after`), X[c] the f32 sum of the unrounded x over the
// chunk.  For K3 the group-partial form is its own definition; for K1 and
// K2 it is the same function as their dequantize-first forms in another
// order of f32 sums.  K1v's weight is rounded after it is scaled, so s
// cannot leave its chunk's sum: the chunk loads s' before its products and
// rounds each q * s' (no FMA contraction) to bf16; the products bf16 x bf16
// are exact in f32, as in the plain version.  On one plan, K1 with bf16 x
// is K3's instantiation and K1 with f32 x on packed values is K2's: the
// same bits.
//
// Inputs: the planar layout of qdot.cu (K1):
//   x     bf16 or f32 [1, K]
//   v     int8 [K, N], or uint8 [K/2, N] nibble-packed PER GROUP: byte row r
//         of group b holds w[b*g + r] in its low nibble and w[b*g + g/2 + r]
//         in its high one
//   s     f32 [K/g, N], g in {16, 32};  mins f32 [K/g, N] or null
//   y     [1, N] in x's type, rounded once from the f32 sum
//
// What bounds it on the H100: every weight byte is read once for two
// operations per value, so the bytes of v + s + mins over the 3.35 TB/s of
// HBM; the CUDA cores' issue rate comes within ~2x of it for nibbles (two
// values a byte, ~3.3 instructions a value in the group-partial form: a byte
// permute, an add, an FMA; ~5.5 in the bf16-weight form: the scale's
// multiply, a rounding and its unpacking besides).  What bounds this design
// is latency: a lane's chunk is loads, then ~800 dependent-free
// instructions, then the fold, and an SM holds too few of them to cover
// HBM's latency with work (PERF.md: on aligned rows taller chunks,
// bigger blocks, prefetching the next chunk or the scales, and more splits
// were each slower).  The design:
//
// * Wide loads: a lane owns 16 neighbouring columns and reads 16 bytes of a
//   row of v per load (16 int8 columns, or 16 packed bytes = 16 columns x
//   2 k), s and mins as float4, x as 16-byte vectors; a team of two lanes
//   reads one whole 32-byte sector of a row.  A chunk is 8 byte rows of one
//   quant group, all issued before any is used.
// * Rows that are not 16-byte aligned (N % 16 != 0: the output heads'
//   13059) are read as the five aligned 4-byte words that cover a lane's 16
//   bytes, funnel-shifted by the row's own offset; s, mins and x go by
//   scalar loads (x by 16-byte vectors there was slower, PERF.md).  Such a
//   lane issues ~2x the instructions of an aligned one, and a head's K =
//   768 or 2048 gives each team only a few chunks, so the time is in each
//   chunk's memory latency: teams of 8 lanes (128 columns a block, 3 splits
//   at the heads), s and mins loaded with the rows (EARLY: the fold waits
//   on no load), and registers for 3 blocks an SM (PERF.md: 2-lane teams
//   and two aligned 16-byte blocks and a select of their words ran the
//   int8 heads 22-32 % slower than the one-column-a-thread layout they
//   replace).
// * Exact conversions without I2F: qtile::i8_f32 (one byte permute against
//   2^23, one subtraction) on the int8 bytes and on the nibble planes
//   (w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F).  X rides the chunk's fold: the
//   thread that multiplies a chunk also sums its x, in its own K slice.
// * Enough blocks, deterministically, in one launch: a block of 128 threads
//   covers 32 columns (128 for unaligned rows); its teams take the chunks of
//   the block's K slice in turn (chunk i to team i % T of warp (i / T) % 4,
//   T teams a warp, so a warp's lanes are all busy but in its last round).
//   K is split over a thread-block cluster of `splits` <= 8 blocks (the
//   plan: ops/qmat.py:_gemv_plan, about two blocks an SM).  The teams' sums
//   meet by a fixed shuffle tree, the warps' in shared memory in warp
//   order, and the cluster's in rank 0's threads, which read each rank's
//   shared memory (distributed shared memory) in rank order and round y
//   once.  No workspace, no tickets, no atomics: two calls give the same
//   bits.
// * Registers for 4 blocks an SM, 3 for unaligned rows in the
//   group-partial form (__launch_bounds__' second argument): without it
//   ptxas gave aligned rows 64 a thread and a spill, and the K1 2.6B step
//   ran 1.797 ms against 1.606 with it; allowing 1 block an SM instead
//   slowed K1v's step to 2.54 ms and the int8 heads by 43-47 % (PERF.md).
//
// Registers per thread (-Xptxas -v, CUDA 12.8, sm_90a): group-partial form
// 96 for aligned int8 rows, 108 (f32 x) and 120 (bf16 x) for aligned packed
// rows, 163-168 for unaligned rows; bf16-weight form 128, with a 64-68 byte
// spill for unaligned packed rows (K1v's 2.6B head).
//
// Everything here has internal linkage (an anonymous namespace): each
// shared library that includes the header has its own kernels and
// launchers, and no object is shared between libraries in one process.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdot_tile.cuh"

namespace qgemv {
namespace {

namespace cg = cooperative_groups;

using qtile::bf16_round;
using qtile::from_f32;
using qtile::to_f32;

constexpr int GEMV_TEAM = 2;                   // lanes of a team, 16 columns each
constexpr int GEMV_TEAM_UNALIGNED = 8;         // the same where rows are not aligned
constexpr int GEMV_COLS = 16 * GEMV_TEAM;      // columns of a block
constexpr int GEMV_WARPS = 4;
constexpr int GEMV_THREADS = 32 * GEMV_WARPS;
constexpr int GEMV_MAX_SPLITS = 8;             // the portable cluster size
// blocks an SM that the registers must allow (ptxas otherwise picks 64 a
// thread for aligned rows, too few to keep a chunk's loads in flight);
// unaligned rows in the group-partial form hold s and mins through the
// products (EARLY) and get more registers
constexpr int GEMV_MIN_BLOCKS = 4;
constexpr int GEMV_MIN_BLOCKS_UNALIGNED = 3;

// lanes of a team: a team covers the block's columns
__host__ __device__ constexpr int gemv_team(bool aligned) {
  return aligned ? GEMV_TEAM : GEMV_TEAM_UNALIGNED;
}

// R consecutive x values from x + k, as f32 (VEC: 16-byte loads)
template <typename T, int R, bool VEC>
__device__ __forceinline__ void load_x(const T* __restrict__ x, int k,
                                       float (&o)[R]) {
  if constexpr (VEC && sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(x + k) + i);
      o[4 * i] = f.x; o[4 * i + 1] = f.y; o[4 * i + 2] = f.z; o[4 * i + 3] = f.w;
    }
  } else if constexpr (VEC) {
    static_assert(R % 8 == 0, "bf16 x is read 16 bytes at a time");
    uint32_t w[R / 2];
#pragma unroll
    for (int i = 0; i < R / 8; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + k) + i);
      w[4 * i] = u.x; w[4 * i + 1] = u.y; w[4 * i + 2] = u.z; w[4 * i + 3] = u.w;
    }
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {    // bf16 -> f32: the bits, shifted
      o[2 * j] = __uint_as_float(w[j] << 16);
      o[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) o[i] = to_f32(x[k + i]);
  }
}

// the 16 bytes of v at byte offset `a` (any alignment) from the five
// aligned 4-byte words that cover them, funnel-shifted; a word past `end`
// is not read (an aligned word never crosses a page, so none can fault)
__device__ __forceinline__ uint4 load_row16(const uint8_t* v, size_t a,
                                            size_t end) {
  const size_t base = a & ~(size_t)3;
  const unsigned sh = 8 * (unsigned)(a & 3);
  uint32_t sel[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    sel[i] = base + 4 * i < end
        ? __ldg(reinterpret_cast<const uint32_t*>(v + base) + i) : 0u;
  return make_uint4(__funnelshift_r(sel[0], sel[1], sh),
                    __funnelshift_r(sel[1], sel[2], sh),
                    __funnelshift_r(sel[2], sel[3], sh),
                    __funnelshift_r(sel[3], sel[4], sh));
}

// 16 f32 of a row of s or mins from column c0: float4 loads
// (ALIGNED), else scalar loads with the columns past N clamped to N - 1
template <bool ALIGNED>
__device__ __forceinline__ void load_cols16(const float* __restrict__ row,
                                            int c0, int N, float (&o)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (ALIGNED) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(row + c0) + i);
      o[4 * i] = f.x; o[4 * i + 1] = f.y; o[4 * i + 2] = f.z; o[4 * i + 3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * i + e] = __ldg(row + min(c0 + 4 * i + e, N - 1));
    }
  }
}

// the four products of word wd's bytes j = 0..3 (q = qtile::i8_f32, exact)
// with xv into P[c..c+3]: xv * q (group-partial), or xv * bf16(q * sp[c + j])
// (SCALED: xv is bf16(x); the weights rounded two at a time)
template <bool SCALED>
__device__ __forceinline__ void products4(float (&P)[16], int c, float xv,
                                          uint32_t wd, const float (&sp)[16]) {
  if constexpr (SCALED) {
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const uint32_t h = qtile::pack_bf16(__fmul_rn(qtile::i8_f32(wd, j), sp[c + j]),
                                          __fmul_rn(qtile::i8_f32(wd, j + 1),
                                                    sp[c + j + 1]));
      P[c + j] = fmaf(xv, __uint_as_float(h << 16), P[c + j]);
      P[c + j + 1] = fmaf(xv, __uint_as_float(h & 0xFFFF0000u), P[c + j + 1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) P[c + j] = fmaf(xv, qtile::i8_f32(wd, j), P[c + j]);
  }
}

// y[1, N] = x[1, K] . (v * s - mins), K split over the cluster's blocks
// (gridDim.y = cluster size; block y takes K [y * k_split, (y+1) * k_split)).
// ALIGNED: N % 16 == 0 and x, v, s, mins 16-byte aligned.  SCALED: the
// bf16-weight form of K1v (mode after if `after`, else mode 1).
template <typename T, bool PACKED, int G, bool ALIGNED, bool SCALED>
__global__ void __launch_bounds__(
    GEMV_THREADS, ALIGNED || SCALED ? GEMV_MIN_BLOCKS : GEMV_MIN_BLOCKS_UNALIGNED)
qdot_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ v,
                 const float* __restrict__ s, const float* __restrict__ mins,
                 T* __restrict__ y, int K, int N, int k_split, bool after) {
  constexpr int RPG = PACKED ? G / 2 : G;       // byte rows of a group
  constexpr int R = RPG < 8 ? RPG : 8;          // byte rows of a chunk
  constexpr int TEAM = gemv_team(ALIGNED);      // lanes of a team
  constexpr int COLS = 16 * TEAM;               // columns of the block
  constexpr int TEAMS = GEMV_THREADS / TEAM;    // teams of the block
  __shared__ float red[GEMV_WARPS][COLS];
  __shared__ float part[COLS];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * COLS + 16 * (lane % TEAM);  // its columns
  const bool live = c0 < N;
  const bool has_mins = mins != nullptr;
  const int rows_total = PACKED ? K / 2 : K;
  const int r_begin = blockIdx.y * (PACKED ? k_split / 2 : k_split);
  const int r_end = min(rows_total, r_begin + (PACKED ? k_split / 2 : k_split));
  const int n_chunks = live ? (r_end - r_begin) / R : 0;
  const size_t v_end = (size_t)rows_total * N;

  float acc[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = 0.f;

  constexpr int TPW = 32 / TEAM;                // teams of a warp
  for (int ci = TPW * warp + lane / TEAM; ci < n_chunks; ci += TEAMS) {
    const int row0 = r_begin + ci * R;
    const int b = row0 / RPG;
    uint4 w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t a = (size_t)(row0 + r) * N + c0;
      w[r] = ALIGNED ? __ldg(reinterpret_cast<const uint4*>(v + a))
                     : load_row16(v, a, v_end);
    }
    // x of the chunk: rows k = row0 + r (int8), or k = b*G + rr and its
    // partner b*G + G/2 + rr (packed)
    const int k_lo = PACKED ? b * G + row0 % RPG : row0;
    float xl[R], xh[PACKED ? R : 1];
    load_x<T, R, ALIGNED>(x, k_lo, xl);
    if constexpr (PACKED) load_x<T, R, ALIGNED>(x, k_lo + G / 2, xh);
    // the group's scales and mins: SCALED multiplies every value by s', so
    // it loads s before the products; EARLY loads both with the rows, so
    // the fold waits on no load (unaligned rows: a few chunks a team, each
    // a memory latency)
    constexpr bool EARLY = !ALIGNED && !SCALED;
    const float* s_row = s + (size_t)b * N;
    const float* m_row = mins + (size_t)b * N;
    float sv[16], mv[16];
    if constexpr (SCALED || EARLY) load_cols16<ALIGNED>(s_row, c0, N, sv);
    if (EARLY && has_mins) load_cols16<ALIGNED>(m_row, c0, N, mv);
    if constexpr (SCALED) {
#pragma unroll
      for (int c = 0; c < 16; ++c) sv[c] = after ? sv[c] : bf16_round(sv[c]);
    }
    float P[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) P[c] = 0.f;
    float X = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t wd[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
      X += xl[r];
      const float xa = SCALED ? bf16_round(xl[r]) : xl[r];
      if constexpr (PACKED) {
        X += xh[r];
        const float xb = SCALED ? bf16_round(xh[r]) : xh[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t lo = wd[q] & 0x0F0F0F0Fu, hi = (wd[q] >> 4) & 0x0F0F0F0Fu;
          if constexpr (SCALED) {
            products4<true>(P, 4 * q, xa, lo, sv);
            products4<true>(P, 4 * q, xb, hi, sv);
          } else {
            // low then high nibble of each byte, as one FMA chain per column
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              P[4 * q + j] = fmaf(xa, qtile::i8_f32(lo, j), P[4 * q + j]);
              P[4 * q + j] = fmaf(xb, qtile::i8_f32(hi, j), P[4 * q + j]);
            }
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) products4<SCALED>(P, 4 * q, xa, wd[q], sv);
      }
    }
    // the fold: s * P (or Q as it is), then - mins * X, IEEE f32
    if constexpr (!SCALED && !EARLY) load_cols16<ALIGNED>(s_row, c0, N, sv);
    if (!EARLY && has_mins) load_cols16<ALIGNED>(m_row, c0, N, mv);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      acc[c] = SCALED ? acc[c] + P[c] : fmaf(sv[c], P[c], acc[c]);
      if (has_mins) acc[c] = fmaf(-mv[c], X, acc[c]);
    }
  }

  // the teams of a warp (the lane bits above a team's), by a fixed tree
#pragma unroll
  for (int m = TEAM; m < 32; m <<= 1)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] += __shfl_xor_sync(0xFFFFFFFFu, acc[c], m);
  if (lane < TEAM) {
#pragma unroll
    for (int c = 0; c < 16; ++c) red[warp][16 * lane + c] = acc[c];
  }
  __syncthreads();
  // the warps in order, then the cluster's blocks in rank order
  for (int c = tid; c < COLS; c += GEMV_THREADS) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < GEMV_WARPS; ++w) t += red[w][c];
    part[c] = t;
  }
  cluster.sync();
  for (int c = tid; cluster.block_rank() == 0 && c < COLS; c += GEMV_THREADS) {
    float t = 0.f;
    const int n_ranks = (int)cluster.num_blocks();
    for (int r = 0; r < n_ranks; ++r) t += cluster.map_shared_rank(&part[0], r)[c];
    const int n = blockIdx.x * COLS + c;
    if (n < N) y[n] = from_f32<T>(t);
  }
  cluster.sync();   // the other blocks' shared memory lives until it is read
}

// One GEMV launch: a cluster of `splits` blocks along K per block of columns.
template <typename T, bool PACKED, int G, bool ALIGNED, bool SCALED>
cudaError_t launch_gemv(const void* x, const uint8_t* v, const float* s,
                        const float* mins, void* y, int K, int N, int splits,
                        int k_split, bool after, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  constexpr int cols = 16 * gemv_team(ALIGNED);
  cfg.gridDim = dim3((N + cols - 1) / cols, splits, 1);
  cfg.blockDim = dim3(GEMV_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, qdot_gemv_kernel<T, PACKED, G, ALIGNED, SCALED>,
      static_cast<const T*>(x), v, s, mins, static_cast<T*>(y), K, N, k_split,
      after);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T, bool PACKED, int G, bool SCALED>
cudaError_t gemv_by_alignment(const void* x, const uint8_t* v, const float* s,
                              const float* mins, void* y, int K, int N,
                              int splits, int k_split, bool after,
                              cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(v)
                         | reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(mins);
  if (N % 16 == 0 && addr % 16 == 0) {
    return launch_gemv<T, PACKED, G, true, SCALED>(x, v, s, mins, y, K, N, splits,
                                                   k_split, after, stream);
  }
  return launch_gemv<T, PACKED, G, false, SCALED>(x, v, s, mins, y, K, N, splits,
                                                  k_split, after, stream);
}

// The GEMV of x [1, K] (T: bf16 or f32) against the values v (PACKED:
// nibbles) under a plan that gemv_plan_ok accepts; SCALED: K1v's
// bf16-weight form (`after`: its mode).
template <typename T, bool PACKED, bool SCALED = false>
cudaError_t gemv(const void* x, const void* v, const float* s,
                 const float* mins, void* y, int K, int N, int group, int splits,
                 int k_split, cudaStream_t stream, bool after = false) {
  const uint8_t* vb = static_cast<const uint8_t*>(v);
  if (group == 16) {
    return gemv_by_alignment<T, PACKED, 16, SCALED>(x, vb, s, mins, y, K, N, splits,
                                                    k_split, after, stream);
  }
  return gemv_by_alignment<T, PACKED, 32, SCALED>(x, vb, s, mins, y, K, N, splits,
                                                  k_split, after, stream);
}

// the checks of a GEMV plan that the kernel relies on: whole quant groups
// per split, the splits covering K exactly, a portable cluster
bool gemv_plan_ok(int K, int group, int splits, int k_split) {
  if (splits < 1 || splits > GEMV_MAX_SPLITS || k_split < group || k_split % group) {
    return false;
  }
  return (long long)splits * k_split >= K && (long long)(splits - 1) * k_split < K;
}

}  // namespace
}  // namespace qgemv
