// The single-stream routes of the quantized matmul for Hopper (sm_90a): the
// kernels the JAX package's `qdot` (miotts_tpu/ops/qmat.py) picks under its
// opt-in switches, each a port of one Pallas kernel:
//
//   K2  qdot_split_launch  <- _qdot_split_kernel        (MIOTTS_PACK4_SPLIT=1)
//       M = 1: the GEMV of qdot_gemv.cuh; M > 1: the tile of qdot_tile.cuh
//   K3  qdot_group_launch  <- _qdot_group_kernel        (MIOTTS_QDOT_GEMV=groupdot)
//       the GEMV of qdot_gemv.cuh
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
// K2 at M = 1 and K3 run the split-K GEMV of qdot_gemv.cuh in its
// group-partial form (its note says what bounds it), as K1 does at M = 1:
// on one plan (ops/qmat.py:_gemv_plan) K3 and K1 with bf16 x, and K2 and
// K1 with f32 x, give the same bits.
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
// Plain C interface for ctypes: each *_launch returns the launch's
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdot_gemv.cuh"
#include "qdot_tile.cuh"

namespace {

using qtile::from_f32;
using qtile::to_f32;

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
  if (!qgemv::gemv_plan_ok(K, group, splits, k_split)) return (int)cudaErrorInvalidValue;
  if (x_is_bf16) {
    return (int)qgemv::gemv<__nv_bfloat16, true>(x, vb, sf, mf, y, K, N, group, splits,
                                          k_split, st);
  }
  return (int)qgemv::gemv<float, true>(x, vb, sf, mf, y, K, N, group, splits, k_split, st);
}

// K3: x [1, K] bf16, int8 or packed values; the GEMV under the plan of
// ops/qmat.py:_gemv_plan.
extern "C" int qdot_group_launch(const void* x, const void* v, const void* s,
                                 const void* mins, void* y, int packed, int K,
                                 int N, int group, int splits, int k_split,
                                 void* stream) {
  if (bad_shape(1, K, N, group) || !qgemv::gemv_plan_ok(K, group, splits, k_split)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* vb = static_cast<const uint8_t*>(v);
  const float* sf = static_cast<const float*>(s);
  const float* mf = static_cast<const float*>(mins);
  if (packed) {
    return (int)qgemv::gemv<__nv_bfloat16, true>(x, vb, sf, mf, y, K, N, group, splits,
                                          k_split, st);
  }
  return (int)qgemv::gemv<__nv_bfloat16, false>(x, vb, sf, mf, y, K, N, group, splits,
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
