// The single-stream routes of the quantized matmul for Hopper (sm_90a): the
// kernels the JAX package's `qdot` (miotts_tpu/ops/qmat.py) picks under its
// opt-in switches, each a port of one Pallas kernel:
//
//   K2  qdot_split_launch  <- _qdot_split_kernel        (MIOTTS_PACK4_SPLIT=1)
//       M = 1: qdot_gemv_kernel; M > 1: the tile of qdot_tile.cuh
//   K3  qdot_group_launch  <- _qdot_group_kernel        (MIOTTS_QDOT_GEMV=groupdot)
//       qdot_gemv_kernel
//   K4a qdot_w8a8_kernel         <- _qdot_w8a8_kernel         (MIOTTS_QDOT_GEMV=w8a8)
//   K4b qdot_w8a8_packed_kernel  <- _qdot_w8a8_packed_kernel  (the same, packed)
//
// Inputs: the planar layout of qdot.cu (K1):
//   x     bf16 or f32 [M, K] row-major (K3 / K4: M = 1; K3: bf16 only)
//   v     int8 [K, N], or uint8 [K/2, N] nibble-packed PER GROUP: byte row r
//         of group b holds w[b*g + r] in its low nibble and w[b*g + g/2 + r]
//         in its high one
//   s     f32 [K/g, N], g in {16, 32};  mins f32 [K/g, N] or null
//   y     [M, N] in x's type, rounded once from the f32 sum
//
// What each computes:
//   K2  x as f32; each nibble plane dequantized in place (q * s) against its
//       half of the group's x; minus sum_b mn[b, n] * (f32 group sum of x).
//   K3  per-group partials d[b, n] = sum bf16(x) * q in f32 (the products are
//       exact), then sum_b d * s; minus the mins term from the exact group
//       sums of x.
//   K4  x quantized per group: sx = amax / 127 (1 where amax is 0), xq =
//       clip(round_half_even(x / sx), -127, 127) (IEEE division and
//       __float2int_rn, so xq is the plain version's bit for bit); integer
//       partials d[b, n] = sum xq * q; y = sum_b d * (s * sx) minus
//       sum_b mn * (sx * sum xq), the mins term of x^ = xq * sx.
//
// K2 at M > 1 is K1's function on K1's packed layout, so it runs K1's tile
// (qdot_tile.cuh, its note says what bounds it) under the same plan
// (ops/qmat.py:_tile_plan): K2 and K1 give the same bits there.
//
// K2 at M = 1 and K3 are one GEMV body in the group-partial form: P[c, n] =
// sum over a chunk c of a quant group of x_k * q[k, n] (f32, every product
// exact for a bf16 x), then y = sum_c (s[b, n] * P[c, n] - mins[b, n] * X[c])
// with X[c] the f32 sum of x over the chunk.  For K3 that is its own
// definition; for K2 the same function as its dequantize-first form in
// another order of f32 sums.
//
// What bounds them on the H100: at M = 1 every weight byte is read once for
// two operations per value, so they are bound by the bytes of v + s + mins
// over the 3.35 TB/s of HBM; the CUDA cores' issue rate comes within ~2x of
// it for nibbles (two values a byte, ~3.3 instructions a value: a byte
// permute, an add, an FMA).  What bounds this design is latency: a lane's
// chunk is loads, then ~800 dependent-free instructions, then the fold, and
// an SM holds too few of them to cover HBM's latency with work (PERF.md:
// taller chunks, bigger blocks, prefetching the next chunk or the scales,
// and more splits were each slower).  The design:
//
// * Wide loads: a lane owns 16 neighbouring columns and reads 16 bytes of a
//   row of v per load (16 int8 columns, or 16 packed bytes = 16 columns x
//   2 k), s and mins as float4, x as 16-byte vectors; a team of two lanes
//   reads one whole 32-byte sector of a row.  A chunk is 8 byte rows of one
//   quant group, all issued before any is used.  Rows that are not 16-byte
//   aligned (N % 16 != 0: the output head's 13059) are read as the two
//   aligned 16-byte blocks that cover them and funnel-shifted (a block is
//   read only where it holds a byte of v, so no load leaves the
//   allocation); s, mins and x then go by scalar loads.
// * Exact conversions without I2F: qtile::i8_f32 (one byte permute against
//   2^23, one subtraction) on the int8 bytes and on the nibble planes
//   (w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F).  X rides the chunk's fold: the
//   thread that multiplies a chunk also sums its x, in its own K slice.
// * Enough blocks, deterministically, in one launch: a block of 128 threads
//   covers 32 columns; its 64 teams take the chunks of the block's K slice
//   in turn (chunk i to team i % 16 of warp (i / 16) % 4, so a warp's lanes
//   are all busy but in its last round).  K is split over a thread-block
//   cluster of `splits` <= 8 blocks (the plan: ops/qmat.py:_gemv_plan,
//   about two blocks an SM).  The teams' sums meet by a fixed shuffle tree,
//   the warps' in shared memory in warp order, and the cluster's in rank
//   0's threads, which read each rank's shared memory (distributed shared
//   memory) in rank order and round y once.  No workspace, no tickets, no
//   atomics: two calls give the same bits.
//
// What is not carried over from the TPU: K4's block-diagonal [K/g, K]
// expansion of xq and its lane-replicated sx (Mosaic had no 8-bit
// elementwise arithmetic), and the separate launches that quantized x and
// computed the mins term: here each block quantizes the x row itself into
// shared memory and the mins ride the per-group scale, so one linear is one
// launch.  K2's split of x into lo / hi halves needs no copy either: the
// lanes read both halves of a group.  Blocks run in parallel and in no
// order, so the TPU kernels' K-grid accumulator becomes the K loop inside a
// block and the cluster's ordered sum.
//
// Registers per thread of the GEMV (-Xptxas -v, CUDA 12.8, sm_90a): 80 for
// aligned packed rows, 96 for int8 rows (aligned or not), 114 (f32 x) and
// 128 (bf16 x, with a 4-byte spill) for unaligned packed rows.
//
// Plain C interface for ctypes: each *_launch returns the launch's
// cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "qdot_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using qtile::from_f32;
using qtile::to_f32;

// ----------------------------------------------------- K2 (M = 1) and K3
constexpr int GEMV_TEAM = 2;                   // lanes of a team, 16 columns each
constexpr int GEMV_COLS = 16 * GEMV_TEAM;      // columns of a block
constexpr int GEMV_WARPS = 4;
constexpr int GEMV_THREADS = 32 * GEMV_WARPS;
constexpr int GEMV_TEAMS = GEMV_THREADS / GEMV_TEAM;
constexpr int GEMV_MAX_SPLITS = 8;             // the portable cluster size

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

// the 16 bytes of v at byte offset `a` (any alignment) from the two aligned
// 16-byte blocks that cover them; a block past `end` is not read
__device__ __forceinline__ uint4 load_row16(const uint8_t* v, size_t a,
                                            size_t end) {
  const size_t base = a & ~(size_t)15;
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
  return make_uint4(__funnelshift_r(sel[0], sel[1], sh),
                    __funnelshift_r(sel[1], sel[2], sh),
                    __funnelshift_r(sel[2], sel[3], sh),
                    __funnelshift_r(sel[3], sel[4], sh));
}

// y[1, N] = x[1, K] . (v * s - mins), K split over the cluster's blocks
// (gridDim.y = cluster size; block y takes K [y * k_split, (y+1) * k_split)).
// ALIGNED: N % 16 == 0 and x, v, s, mins 16-byte aligned.
template <typename T, bool PACKED, int G, bool ALIGNED>
__global__ void __launch_bounds__(GEMV_THREADS)
qdot_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ v,
                 const float* __restrict__ s, const float* __restrict__ mins,
                 T* __restrict__ y, int K, int N, int k_split) {
  constexpr int RPG = PACKED ? G / 2 : G;       // byte rows of a group
  constexpr int R = RPG < 8 ? RPG : 8;          // byte rows of a chunk
  __shared__ float red[GEMV_WARPS][GEMV_COLS];
  __shared__ float part[GEMV_COLS];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * GEMV_COLS + 16 * (lane % GEMV_TEAM);  // its columns
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

  constexpr int TPW = 32 / GEMV_TEAM;           // teams of a warp
  for (int ci = TPW * warp + lane / GEMV_TEAM; ci < n_chunks; ci += GEMV_TEAMS) {
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
    float P[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) P[c] = 0.f;
    float X = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t wd[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
      X += xl[r];
      if constexpr (PACKED) {
        X += xh[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t lo = wd[q] & 0x0F0F0F0Fu, hi = (wd[q] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            P[4 * q + j] = fmaf(xl[r], qtile::i8_f32(lo, j), P[4 * q + j]);
            P[4 * q + j] = fmaf(xh[r], qtile::i8_f32(hi, j), P[4 * q + j]);
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            P[4 * q + j] = fmaf(xl[r], qtile::i8_f32(wd[q], j), P[4 * q + j]);
      }
    }
    // the fold: s * P, then - mins * X, IEEE f32
    const size_t so = (size_t)b * N + c0;
    float sv[16], mv[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ALIGNED) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(s + so) + i);
        sv[4 * i] = f.x; sv[4 * i + 1] = f.y; sv[4 * i + 2] = f.z; sv[4 * i + 3] = f.w;
        if (has_mins) {
          const float4 m = __ldg(reinterpret_cast<const float4*>(mins + so) + i);
          mv[4 * i] = m.x; mv[4 * i + 1] = m.y; mv[4 * i + 2] = m.z; mv[4 * i + 3] = m.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const size_t o = (size_t)b * N + min(c0 + 4 * i + e, N - 1);
          sv[4 * i + e] = __ldg(s + o);
          if (has_mins) mv[4 * i + e] = __ldg(mins + o);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      acc[c] = fmaf(sv[c], P[c], acc[c]);
      if (has_mins) acc[c] = fmaf(-mv[c], X, acc[c]);
    }
  }

  // the teams of a warp (lane bits 1..4), by a fixed tree
#pragma unroll
  for (int m = GEMV_TEAM; m < 32; m <<= 1)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] += __shfl_xor_sync(0xFFFFFFFFu, acc[c], m);
  if (lane < GEMV_TEAM) {
#pragma unroll
    for (int c = 0; c < 16; ++c) red[warp][16 * lane + c] = acc[c];
  }
  __syncthreads();
  // the warps in order, then the cluster's blocks in rank order
  if (tid < GEMV_COLS) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < GEMV_WARPS; ++w) t += red[w][tid];
    part[tid] = t;
  }
  cluster.sync();
  if (cluster.block_rank() == 0 && tid < GEMV_COLS) {
    float t = 0.f;
    const int n_ranks = (int)cluster.num_blocks();
    for (int r = 0; r < n_ranks; ++r) t += cluster.map_shared_rank(&part[0], r)[tid];
    const int n = blockIdx.x * GEMV_COLS + tid;
    if (n < N) y[n] = from_f32<T>(t);
  }
  cluster.sync();   // the other blocks' shared memory lives until it is read
}

// One GEMV launch: a cluster of `splits` blocks along K per 32 columns.
template <typename T, bool PACKED, int G, bool ALIGNED>
cudaError_t launch_gemv(const void* x, const uint8_t* v, const float* s,
                        const float* mins, void* y, int K, int N, int splits,
                        int k_split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + GEMV_COLS - 1) / GEMV_COLS, splits, 1);
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
      &cfg, qdot_gemv_kernel<T, PACKED, G, ALIGNED>, static_cast<const T*>(x),
      v, s, mins, static_cast<T*>(y), K, N, k_split);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T, bool PACKED, int G>
cudaError_t gemv_by_alignment(const void* x, const uint8_t* v, const float* s,
                              const float* mins, void* y, int K, int N,
                              int splits, int k_split, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(v)
                         | reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(mins);
  if (N % 16 == 0 && addr % 16 == 0) {
    return launch_gemv<T, PACKED, G, true>(x, v, s, mins, y, K, N, splits, k_split,
                                           stream);
  }
  return launch_gemv<T, PACKED, G, false>(x, v, s, mins, y, K, N, splits, k_split,
                                          stream);
}

template <typename T, bool PACKED>
cudaError_t gemv(const void* x, const uint8_t* v, const float* s,
                 const float* mins, void* y, int K, int N, int group, int splits,
                 int k_split, cudaStream_t stream) {
  if (group == 16) {
    return gemv_by_alignment<T, PACKED, 16>(x, v, s, mins, y, K, N, splits, k_split,
                                            stream);
  }
  return gemv_by_alignment<T, PACKED, 32>(x, v, s, mins, y, K, N, splits, k_split,
                                          stream);
}

// the checks of a GEMV plan that the kernel relies on: whole quant groups
// per split, the splits covering K exactly, a portable cluster
bool gemv_plan_ok(int K, int group, int splits, int k_split) {
  if (splits < 1 || splits > GEMV_MAX_SPLITS || k_split < group || k_split % group) {
    return false;
  }
  return (long long)splits * k_split >= K && (long long)(splits - 1) * k_split < K;
}

// ------------------------------------------------------------------- K4
// K4 keeps its first layout: one thread per output column, so the 32 lanes of
// a warp read 32 neighbouring bytes of a row; the 16 warps of a block split
// K by quant group and meet in shared memory.
constexpr int COLS = 32;
constexpr int WARPS = 16;
constexpr int THREADS = COLS * WARPS;

// y[row_off + n] = the sum of the warps' partials red[w * COLS + lane].
template <typename T>
__device__ __forceinline__ void write_column(const float* red, T* y, int n,
                                             int N, size_t row_off) {
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w * COLS + threadIdx.x];
  if (n < N) y[row_off + n] = from_f32<T>(t);
}

// Shared memory of K4: sx [K/G], xg [K/G] (group sums of x^), red
// [WARPS * COLS], then xq int8 [K].
__host__ __device__ constexpr size_t w8a8_smem(int K, int G) {
  return (size_t)(2 * (K / G) + WARPS * COLS) * sizeof(float) + (size_t)K;
}

// Quantize the x row per group into shared memory: one thread per group.
template <typename T, int G>
__device__ __forceinline__ void quantize_row(const T* x, int n_groups,
                                             float* sx, float* xg,
                                             int8_t* xq) {
  const int tid = threadIdx.y * COLS + threadIdx.x;
  for (int b = tid; b < n_groups; b += THREADS) {
    float xv[G];
    float amax = 0.f;
#pragma unroll
    for (int r = 0; r < G; ++r) {
      xv[r] = to_f32(x[b * G + r]);
      amax = fmaxf(amax, fabsf(xv[r]));
    }
    const float scale = amax > 0.f ? amax / 127.0f : 1.0f;
    int qsum = 0;
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const int q = max(-127, min(127, __float2int_rn(xv[r] / scale)));
      xq[b * G + r] = (int8_t)q;
      qsum += q;
    }
    sx[b] = scale;
    xg[b] = scale * (float)qsum;
  }
}

template <typename T, bool PACKED, bool MINS, int G>
__device__ __forceinline__ void w8a8_body(const T* __restrict__ x,
                                          const uint8_t* __restrict__ v,
                                          const float* __restrict__ s,
                                          const float* __restrict__ mins,
                                          T* __restrict__ y, int K, int N) {
  extern __shared__ float smem[];
  const int n_groups = K / G;
  float* sx = smem;
  float* xg = sx + n_groups;
  float* red = xg + n_groups;
  int8_t* xq = reinterpret_cast<int8_t*>(red + WARPS * COLS);
  quantize_row<T, G>(x, n_groups, sx, xg, xq);
  __syncthreads();
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int n = blockIdx.x * COLS + lane;
  const int nc = min(n, N - 1);
  float acc = 0.f;
  for (int b = warp; b < n_groups; b += WARPS) {
    const int8_t* xb = xq + b * G;
    int d = 0;                         // exact integer partial
    if (PACKED) {
      constexpr int H = G / 2;
      const uint8_t* vp = v + (size_t)b * H * N + nc;
#pragma unroll 8
      for (int r = 0; r < H; ++r) {
        const int q = vp[(size_t)r * N];
        d += (int)xb[r] * (q & 0xF) + (int)xb[r + H] * (q >> 4);
      }
    } else {
      const int8_t* vp = reinterpret_cast<const int8_t*>(v) + (size_t)b * G * N + nc;
      int q[G];
#pragma unroll
      for (int r = 0; r < G; ++r) q[r] = vp[(size_t)r * N];
#pragma unroll
      for (int r = 0; r < G; ++r) d += (int)xb[r] * q[r];
    }
    acc = fmaf((float)d, s[(size_t)b * N + nc] * sx[b], acc);
    if (MINS) acc = fmaf(-mins[(size_t)b * N + nc], xg[b], acc);
  }
  red[warp * COLS + lane] = acc;
  __syncthreads();
  if (warp == 0) write_column<T>(red, y, n, N, 0);
}

// K4a: int8 values.  K4b: packed nibbles.  Two entries of one body.
template <typename T, bool MINS, int G>
__global__ void __launch_bounds__(THREADS)
qdot_w8a8_kernel(const T* __restrict__ x, const uint8_t* __restrict__ v,
                 const float* __restrict__ s, const float* __restrict__ mins,
                 T* __restrict__ y, int K, int N) {
  w8a8_body<T, false, MINS, G>(x, v, s, mins, y, K, N);
}

template <typename T, bool MINS, int G>
__global__ void __launch_bounds__(THREADS)
qdot_w8a8_packed_kernel(const T* __restrict__ x, const uint8_t* __restrict__ v,
                        const float* __restrict__ s,
                        const float* __restrict__ mins, T* __restrict__ y,
                        int K, int N) {
  w8a8_body<T, true, MINS, G>(x, v, s, mins, y, K, N);
}

// ------------------------------------------------------------ launchers
struct Args {
  const void* x;
  const uint8_t* v;
  const float* s;
  const float* mins;
  void* y;
  int M, K, N, group;
  cudaStream_t st;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Dynamic shared memory above 48 KB needs the attribute first.
template <typename F>
void allow_smem(F kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
}

template <bool PACKED>
struct W8A8Launch {
  template <typename T, bool MINS, int G>
  static void run(const Args& a) {
    auto kern = PACKED ? qdot_w8a8_packed_kernel<T, MINS, G>
                       : qdot_w8a8_kernel<T, MINS, G>;
    const size_t smem = w8a8_smem(a.K, G);
    allow_smem(kern, smem);
    kern<<<cdiv(a.N, COLS), dim3(COLS, WARPS), smem, a.st>>>(
        static_cast<const T*>(a.x), a.v, a.s, a.mins, static_cast<T*>(a.y),
        a.K, a.N);
  }
};

template <typename L, typename T, bool MINS>
void by_group(const Args& a) {
  if (a.group == 16) L::template run<T, MINS, 16>(a);
  else L::template run<T, MINS, 32>(a);
}

template <typename L, typename T>
void by_mins(const Args& a) {
  if (a.mins) by_group<L, T, true>(a);
  else by_group<L, T, false>(a);
}

template <typename L>
void by_dtype(const Args& a, int x_is_bf16) {
  if (x_is_bf16) by_mins<L, __nv_bfloat16>(a);
  else by_mins<L, float>(a);
}

bool bad_shape(int M, int K, int N, int group) {
  return M < 1 || K < 1 || N < 1 || (group != 16 && group != 32) || K % group;
}

Args make_args(const void* x, const void* v, const void* s, const void* mins,
               void* y, int M, int K, int N, int group, void* stream) {
  return Args{x, static_cast<const uint8_t*>(v), static_cast<const float*>(s),
              static_cast<const float*>(mins), y, M, K, N, group,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// K2: x [M, K] (bf16 or f32), packed values.  M = 1: the GEMV under the
// plan of ops/qmat.py:_gemv_plan (splits, k_split; bm, ws and tickets
// unused).  M > 1: K1's tile under the plan of ops/qmat.py:_tile_plan (bm,
// splits, k_split, the f32 workspace [splits][tiles][bm][128] and the
// per-tile tickets), as qdot_launch takes it.
extern "C" int qdot_split_launch(const void* x, const void* v, const void* s,
                                 const void* mins, void* y, void* ws,
                                 void* tickets, int x_is_bf16, int M, int K,
                                 int N, int group, int bm, int splits,
                                 int k_split, void* stream) {
  if (bad_shape(M, K, N, group)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* vb = static_cast<const uint8_t*>(v);
  const float* sf = static_cast<const float*>(s);
  const float* mf = static_cast<const float*>(mins);
  if (M > 1) {
    if (!qtile::plan_ok(M, K, N, bm, splits, k_split, ws, tickets)) {
      return (int)cudaErrorInvalidValue;
    }
    float* wsf = static_cast<float*>(ws);
    int* tk = static_cast<int*>(tickets);
    if (x_is_bf16) {
      if (group == 16)
        return (int)qtile::tile_by_bm<__nv_bfloat16, true, 16, false>(
            x, vb, sf, mf, y, wsf, tk, M, K, N, bm, splits, k_split, false, st);
      return (int)qtile::tile_by_bm<__nv_bfloat16, true, 32, false>(
          x, vb, sf, mf, y, wsf, tk, M, K, N, bm, splits, k_split, false, st);
    }
    if (group == 16)
      return (int)qtile::tile_by_bm<float, true, 16, false>(
          x, vb, sf, mf, y, wsf, tk, M, K, N, bm, splits, k_split, false, st);
    return (int)qtile::tile_by_bm<float, true, 32, false>(
        x, vb, sf, mf, y, wsf, tk, M, K, N, bm, splits, k_split, false, st);
  }
  if (!gemv_plan_ok(K, group, splits, k_split)) return (int)cudaErrorInvalidValue;
  if (x_is_bf16) {
    return (int)gemv<__nv_bfloat16, true>(x, vb, sf, mf, y, K, N, group, splits,
                                          k_split, st);
  }
  return (int)gemv<float, true>(x, vb, sf, mf, y, K, N, group, splits, k_split, st);
}

// K3: x [1, K] bf16, int8 or packed values; the GEMV under the plan of
// ops/qmat.py:_gemv_plan.
extern "C" int qdot_group_launch(const void* x, const void* v, const void* s,
                                 const void* mins, void* y, int packed, int K,
                                 int N, int group, int splits, int k_split,
                                 void* stream) {
  if (bad_shape(1, K, N, group) || !gemv_plan_ok(K, group, splits, k_split)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* vb = static_cast<const uint8_t*>(v);
  const float* sf = static_cast<const float*>(s);
  const float* mf = static_cast<const float*>(mins);
  if (packed) {
    return (int)gemv<__nv_bfloat16, true>(x, vb, sf, mf, y, K, N, group, splits,
                                          k_split, st);
  }
  return (int)gemv<__nv_bfloat16, false>(x, vb, sf, mf, y, K, N, group, splits,
                                         k_split, st);
}

// K4a: x [1, K] (bf16 or f32), int8 values.
extern "C" int qdot_w8a8_launch(const void* x, const void* v, const void* s,
                                const void* mins, void* y, int x_is_bf16,
                                int K, int N, int group, void* stream) {
  if (bad_shape(1, K, N, group)) return (int)cudaErrorInvalidValue;
  by_dtype<W8A8Launch<false>>(
      make_args(x, v, s, mins, y, 1, K, N, group, stream), x_is_bf16);
  return (int)cudaGetLastError();
}

// K4b: x [1, K] (bf16 or f32), packed values.
extern "C" int qdot_w8a8_packed_launch(const void* x, const void* v,
                                       const void* s, const void* mins,
                                       void* y, int x_is_bf16, int K, int N,
                                       int group, void* stream) {
  if (bad_shape(1, K, N, group)) return (int)cudaErrorInvalidValue;
  by_dtype<W8A8Launch<true>>(
      make_args(x, v, s, mins, y, 1, K, N, group, stream), x_is_bf16);
  return (int)cudaGetLastError();
}
