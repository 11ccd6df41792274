// The M = 1 GEMV shared by K1 (qdot.cu), K1v (qdot_bf16.cu), K2, K3, K4a and
// K4b (qdot_gemv.cu), for Hopper (sm_90a).  It replaces the M = 1 bodies of
// miotts_tpu/ops/qmat.py:_qdot_kernel (bf16_dot=False and True / "after"),
// _qdot_split_kernel, _qdot_group_kernel, _qdot_w8a8_kernel and
// _qdot_w8a8_packed_kernel: every decode step of a single stream on the
// default, split, groupdot, bf16-dot and w8a8 routes.
//
// Three forms of the chunk's products, by the template's Form:
//
//   group-partial (K1, K2, K3)
//       y[n] = sum_c ( s[b, n] * P[c, n] - mins[b, n] * X[c] )
//   bf16-weight (K1v)
//       y[n] = sum_c ( Q[c, n] - mins[b, n] * X[c] )
//   integer-partial (K4a, K4b)
//       y[n] = sum_c ( (s[b, n] * sx[b]) * D[c, n] - mins[b, n] * (sx[b] * Xq[c]) )
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
// D[c, n] = sum over chunk c of xq_k * q[k, n] (int32, exact) and Xq[c] the
// sum of its xq, where x is quantized per quant group as the plain version
// does it: sx = amax / 127 (1 where amax is 0), xq = clip(rint(x / sx),
// -127, 127) by IEEE division.  Where rows are 16-byte aligned, each team
// quantizes its chunk's own values in registers (the group's amax from its
// G values by 16-byte loads); where they are not (the heads), each block
// quantizes its own K slice once into shared memory (int8, contiguous along
// k, and sx a group) and a team reads four xq as one broadcast word.  Four
// xq in a word are __dp4a's operand against a column's four int8 values:
// 4 x 4 bytes of four rows transposed by 8 byte permutes, nibbles split
// into their two planes after the transpose (values 0-15 are valid signed
// int8).  |D| <= 16 * 128 * 127 a chunk, so float(D) is exact, and f32
// products on xq give the same bits, slower (PERF.md measured both, and
// both places of the quantization on both row layouts).
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
// multiply, a rounding and its unpacking besides; ~0.75 an int8 value and
// ~0.9 a nibble in the integer-partial form: 8 byte permutes a 4 x 4 block
// of bytes, a dp4a for four products, the nibble planes' masks).  What
// bounds this design is latency: a lane's chunk is loads, then ~800
// dependent-free instructions, then the fold, and an SM holds too few of
// them to cover HBM's latency with work (PERF.md: on aligned rows taller
// chunks, bigger blocks, prefetching the next chunk or the scales, and more
// splits were each slower).  The design:
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
// 96 for aligned int8 rows, 108 (f32 x) and 118 (bf16 x) for aligned packed
// rows, 163-168 for unaligned rows; bf16-weight form 128, with a 64-68 byte
// spill for unaligned packed rows (K1v's 2.6B head); integer-partial form
// 96-124 for aligned rows (x quantized in the chunk), 154-157 for
// unaligned rows (the slice in shared memory), no spill.
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

// the forms of a chunk's products (the note above)
enum Form { GROUP_PARTIAL, BF16_WEIGHT, INT_PARTIAL };

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

// four values quantized by the scale sx as the plain version does it
// (IEEE division, round half to even, clipped to +-127), packed as int8
__device__ __forceinline__ uint32_t quantize4(const float (&v)[4], float sx) {
  uint32_t word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = max(-127, min(127, __float2int_rn(__fdiv_rn(v[e], sx))));
    word |= (uint32_t)(q & 0xFF) << (8 * e);
  }
  return word;
}

// The block's K slice x[k0, k0 + len) quantized per quant group into
// shared memory: xq [len / 4] words of four int8, sx [len / G].  A thread
// takes four neighbouring values (VEC: one 16- or 8-byte load), G / 4
// lanes a group meet for its amax by a shuffle tree; every lane of a warp
// takes part in each round.
template <typename T, int G, bool VEC>
__device__ __forceinline__ void quantize_slice(const T* __restrict__ x, int k0,
                                               int len, uint32_t* xq, float* sx) {
  constexpr int TPG = G / 4;                    // lanes of a group
  for (int i = threadIdx.x; i - (int)threadIdx.x < len / 4; i += GEMV_THREADS) {
    const bool ok = i < len / 4;
    const int k = k0 + 4 * i;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (ok) {
      if constexpr (VEC && sizeof(T) == 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(x + k));
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      } else if constexpr (VEC) {       // bf16 -> f32: the bits, shifted
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(x + k));
        v[0] = __uint_as_float(u.x << 16); v[1] = __uint_as_float(u.x & 0xFFFF0000u);
        v[2] = __uint_as_float(u.y << 16); v[3] = __uint_as_float(u.y & 0xFFFF0000u);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = to_f32(x[k + e]);
      }
    }
    float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
    for (int m = 1; m < TPG; m <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, m));
    const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    if (ok) {
      xq[i] = quantize4(v, scale);
      if (i % TPG == 0) sx[i / TPG] = scale;
    }
  }
}

// Where the integer-partial form takes xq from: unaligned rows (the heads:
// a few chunks a team) quantize the block's K slice once into shared
// memory; aligned rows quantize in each chunk, with no prologue and no
// barrier (PERF.md measured both on both)
__host__ __device__ constexpr bool xq_slice(Form form, bool aligned) {
  return form == INT_PARTIAL && !aligned;
}

// dynamic shared memory of a block that quantizes its slice: the xq of its
// K slice and a scale a group
__host__ __device__ constexpr size_t int_smem(int k_split, int G) {
  return (size_t)k_split + sizeof(float) * (size_t)(k_split / G);
}

__device__ __forceinline__ uint32_t word_of(const uint4& u, int q) {
  return q == 0 ? u.x : q == 1 ? u.y : q == 2 ? u.z : u.w;
}

// 4 x 4 bytes transposed: t[j] holds byte j of a, b, c and d
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t (&t)[4]) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
  t[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
  t[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  t[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  t[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// D[c] += the chunk's products xq_k * q[k, c] by __dp4a: rows r..r+3 of a
// column in one word (transpose4) against the word of their four xq (ql:
// the rows' k; qh: k + G/2, the high nibbles)
template <bool PACKED, int R>
__device__ __forceinline__ void int_products(int (&d)[16], const uint4 (&w)[R],
                                             const uint32_t (&ql)[R / 4],
                                             const uint32_t (&qh)[R / 4]) {
#pragma unroll
  for (int r = 0; r < R; r += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t t[4];
      transpose4(word_of(w[r], q), word_of(w[r + 1], q), word_of(w[r + 2], q),
                 word_of(w[r + 3], q), t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (PACKED) {
          d[4 * q + j] = __dp4a((int)(t[j] & 0x0F0F0F0Fu), (int)ql[r / 4], d[4 * q + j]);
          d[4 * q + j] = __dp4a((int)((t[j] >> 4) & 0x0F0F0F0Fu), (int)qh[r / 4],
                                d[4 * q + j]);
        } else {
          d[4 * q + j] = __dp4a((int)t[j], (int)ql[r / 4], d[4 * q + j]);
        }
      }
    }
  }
}

// y[1, N] = x[1, K] . (v * s - mins), K split over the cluster's blocks
// (gridDim.y = cluster size; block y takes K [y * k_split, (y+1) * k_split)).
// ALIGNED: N % 16 == 0 and x, v, s, mins 16-byte aligned.  FORM: the
// chunk's products (BF16_WEIGHT: K1v's, mode after if `after`, else mode
// 1; INT_PARTIAL where xq_slice: int_smem(k_split, G) bytes of dynamic
// shared memory).
template <typename T, bool PACKED, int G, bool ALIGNED, Form FORM>
__global__ void __launch_bounds__(
    GEMV_THREADS,
    ALIGNED || FORM == BF16_WEIGHT ? GEMV_MIN_BLOCKS : GEMV_MIN_BLOCKS_UNALIGNED)
qdot_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ v,
                 const float* __restrict__ s, const float* __restrict__ mins,
                 T* __restrict__ y, int K, int N, int k_split, bool after) {
  constexpr bool SCALED = FORM == BF16_WEIGHT;
  constexpr bool INT = FORM == INT_PARTIAL;
  constexpr bool XQ_SLICE = xq_slice(FORM, ALIGNED);
  constexpr int RPG = PACKED ? G / 2 : G;       // byte rows of a group
  constexpr int R = RPG < 8 ? RPG : 8;          // byte rows of a chunk
  constexpr int TEAM = gemv_team(ALIGNED);      // lanes of a team
  constexpr int COLS = 16 * TEAM;               // columns of the block
  constexpr int TEAMS = GEMV_THREADS / TEAM;    // teams of the block
  __shared__ float red[GEMV_WARPS][COLS];
  __shared__ float part[COLS];
  extern __shared__ uint32_t xq_s[];            // INT: the slice's xq, then sx
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * COLS + 16 * (lane % TEAM);  // its columns
  const bool live = c0 < N;
  const bool has_mins = mins != nullptr;
  const int k0 = blockIdx.y * k_split;          // the block's K slice
  const int rows_total = PACKED ? K / 2 : K;
  const int r_begin = PACKED ? k0 / 2 : k0;
  const int r_end = min(rows_total, r_begin + (PACKED ? k_split / 2 : k_split));
  const int n_chunks = live ? (r_end - r_begin) / R : 0;
  const size_t v_end = (size_t)rows_total * N;
  float* sx_s = reinterpret_cast<float*>(xq_s + k_split / 4);

  float acc[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = 0.f;

  if constexpr (XQ_SLICE) {
    quantize_slice<T, G, ALIGNED>(x, k0, min(k_split, K - k0), xq_s, sx_s);
    __syncthreads();
  }
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
    // partner b*G + G/2 + rr (packed); INT: their xq, four a word, and sx
    const int k_lo = PACKED ? b * G + row0 % RPG : row0;
    float xl[R], xh[PACKED ? R : 1];
    uint32_t ql[R / 4], qh[R / 4];
    float sxb = 1.f;
    if constexpr (XQ_SLICE) {
      const uint32_t* xw = xq_s + (k_lo - k0) / 4;
#pragma unroll
      for (int i = 0; i < R / 4; ++i) {
        ql[i] = xw[i];
        qh[i] = PACKED ? xw[G / 8 + i] : 0u;
      }
      sxb = sx_s[(k_lo - k0) / G];
    } else {
      load_x<T, R, ALIGNED>(x, k_lo, xl);
      if constexpr (PACKED) load_x<T, R, ALIGNED>(x, k_lo + G / 2, xh);
    }
    if constexpr (INT && !XQ_SLICE) {
      // the group's sx from its G values (the same IEEE steps as the
      // slice's), then the chunk's xq
      float xg[G];
      load_x<T, G, ALIGNED>(x, b * G, xg);
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < G; ++e) amax = fmaxf(amax, fabsf(xg[e]));
      sxb = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
#pragma unroll
      for (int i = 0; i < R / 4; ++i) {
        const float a4[4] = {xl[4 * i], xl[4 * i + 1], xl[4 * i + 2], xl[4 * i + 3]};
        ql[i] = quantize4(a4, sxb);
        qh[i] = 0u;
        if constexpr (PACKED) {
          const float b4[4] = {xh[4 * i], xh[4 * i + 1], xh[4 * i + 2], xh[4 * i + 3]};
          qh[i] = quantize4(b4, sxb);
        }
      }
    }
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
    float X = 0.f;
    int d[16];
    int Xq = 0;
    if constexpr (INT) {
#pragma unroll
      for (int c = 0; c < 16; ++c) d[c] = 0;
      int_products<PACKED, R>(d, w, ql, qh);
#pragma unroll
      for (int i = 0; i < R / 4; ++i) {
        Xq = __dp4a((int)ql[i], 0x01010101, Xq);
        if (PACKED) Xq = __dp4a((int)qh[i], 0x01010101, Xq);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 16; ++c) P[c] = 0.f;
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
    }
    // the fold: s * P (or Q as it is), then - mins * X, IEEE f32; INT:
    // (s * sx) * D, then - mins * (sx * Xq), the scale formed first as in
    // the TPU kernel
    if constexpr (!SCALED && !EARLY) load_cols16<ALIGNED>(s_row, c0, N, sv);
    if (!EARLY && has_mins) load_cols16<ALIGNED>(m_row, c0, N, mv);
    if constexpr (INT) X = __fmul_rn(sxb, (float)Xq);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      if constexpr (INT) {
        acc[c] = fmaf(__fmul_rn(sv[c], sxb), (float)d[c], acc[c]);
      } else {
        acc[c] = SCALED ? acc[c] + P[c] : fmaf(sv[c], P[c], acc[c]);
      }
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
template <typename T, bool PACKED, int G, bool ALIGNED, Form FORM>
cudaError_t launch_gemv(const void* x, const uint8_t* v, const float* s,
                        const float* mins, void* y, int K, int N, int splits,
                        int k_split, bool after, cudaStream_t stream) {
  auto kernel = qdot_gemv_kernel<T, PACKED, G, ALIGNED, FORM>;
  cudaLaunchConfig_t cfg = {};
  constexpr int cols = 16 * gemv_team(ALIGNED);
  cfg.gridDim = dim3((N + cols - 1) / cols, splits, 1);
  cfg.blockDim = dim3(GEMV_THREADS, 1, 1);
  cfg.dynamicSmemBytes = xq_slice(FORM, ALIGNED) ? int_smem(k_split, G) : 0;
  if (cfg.dynamicSmemBytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)cfg.dynamicSmemBytes);
  }
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), v, s, mins, static_cast<T*>(y), K,
      N, k_split, after);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T, bool PACKED, int G, Form FORM>
cudaError_t gemv_by_alignment(const void* x, const uint8_t* v, const float* s,
                              const float* mins, void* y, int K, int N,
                              int splits, int k_split, bool after,
                              cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(v)
                         | reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(mins);
  if (N % 16 == 0 && addr % 16 == 0) {
    return launch_gemv<T, PACKED, G, true, FORM>(x, v, s, mins, y, K, N, splits,
                                                 k_split, after, stream);
  }
  return launch_gemv<T, PACKED, G, false, FORM>(x, v, s, mins, y, K, N, splits,
                                                k_split, after, stream);
}

// The GEMV of x [1, K] (T: bf16 or f32) against the values v (PACKED:
// nibbles) under a plan that gemv_plan_ok accepts, in the products' form
// FORM (BF16_WEIGHT: `after` is its mode).
template <typename T, bool PACKED, Form FORM = GROUP_PARTIAL>
cudaError_t gemv(const void* x, const void* v, const float* s,
                 const float* mins, void* y, int K, int N, int group, int splits,
                 int k_split, cudaStream_t stream, bool after = false) {
  const uint8_t* vb = static_cast<const uint8_t*>(v);
  if (group == 16) {
    return gemv_by_alignment<T, PACKED, 16, FORM>(x, vb, s, mins, y, K, N, splits,
                                                  k_split, after, stream);
  }
  return gemv_by_alignment<T, PACKED, 32, FORM>(x, vb, s, mins, y, K, N, splits,
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
