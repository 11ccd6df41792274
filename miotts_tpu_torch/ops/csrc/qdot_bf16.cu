// The bf16-dot variants of the fused dequant-matmul for Hopper (sm_90a):
//
//   y[M, N] = sum_k bf16(x[m, k]) * w[k, n]  -  sum_b xg[m, b] * mins[b, n]
//
//   mode 1      w = bf16(v * bf16(s))   (MIOTTS_QDOT_BF16=1)
//   mode after  w = bf16(v * s)         (MIOTTS_QDOT_BF16=after)
//
// Replaces miotts_tpu/ops/qmat.py:_qdot_kernel with bf16_dot=True / "after"
// (reached through _qdot_pallas(bf16_dot=...), which `qdot` takes for bf16
// activations under MIOTTS_QDOT_BF16): every quantized linear of a bf16
// model at every M.  The products bf16 x bf16 are exact in f32 and the sums
// are f32.  The mins term is not part of the bf16 dot: xg[m, b] is the f32
// sum of the UNROUNDED x over quant group b, and the term is subtracted in
// f32, as the JAX function does outside its kernel.  The output is rounded
// once to x's type (x arrives as bf16 from the engine; an f32 x from a
// direct call is rounded to bf16 for the dot, as _qdot_pallas casts it).
//
// Inputs: the planar layout of qdot.cu (K1):
//   x     bf16 or f32 [M, K], row-major
//   v     int8 [K, N], or uint8 [K/2, N] nibble-packed PER GROUP: byte row r
//         of group b holds w[b*g + r] in its low nibble and w[b*g + g/2 + r]
//         in its high one
//   s     f32 [K/g, N], g in {16, 32};  mins f32 [K/g, N] or null
//   y     [M, N] in x's type
// The rounding of w is one __float2bfloat16_rn of the f32 product q * s':
// s' = bf16(s) in mode 1 (q * s' is then exact, so w = bf16(v * bf16(s))),
// s' = s in mode after (the f32 product rounded, then rounded to bf16, as
// the JAX function's f32 multiply and one cast).  So the mode is a property
// of the scale alone and costs nothing per weight.
//
// M = 1 (decode): K1's GEMV layout (qdot.cu).  One thread owns one output
// column, so the 32 lanes of a warp read 32 neighbouring bytes of a row of v
// in one sector; 16 warps split K by quant group; bf16(x) and the group sums
// of x are staged once per block in shared memory; each weight is rounded to
// bf16 in registers before its FMA.  Kernel and plain version differ only in
// the order of the f32 sums.  Bound: the bytes of v + s + mins over 3.35
// TB/s, as K1.
//
// M > 1 (prefill, batched decode): the shared tile of qdot_tile.cuh with
// the variant's transform: each weight is rounded to bf16(q * s') from the
// staged quantized bytes in registers, x to bf16, and the tensor cores sum
// bf16 x bf16 in f32 from zero for each quant group, which an IEEE f32 add
// folds into the long accumulator (the mma's own f32 sums truncate; chained
// over K = 8192 they drifted 1e-5 of the output scale from the plain
// version).  The mins term of each group is subtracted in f32 from the
// group sums of the unrounded x.  A 4-stage cp.async ring of the quantized
// bytes and a deterministic split-K in the same launch, as K1's.
//
// Plain C interface for ctypes: qdot_bf16_launch returns cudaGetLastError();
// at M > 1 it takes the tile plan, workspace and tickets as qdot_launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdot_tile.cuh"

namespace {

using qtile::bf16_round;
using qtile::from_f32;
using qtile::to_f32;

// the scale the weight is multiplied by: bf16(s) in mode 1, s in mode after
__device__ __forceinline__ float mode_scale(float s, bool after) {
  return after ? s : bf16_round(s);
}

// one weight: bf16(q * s') (no FMA contraction: the product is rounded
// alone)
__device__ __forceinline__ float bf16_weight(int q, float sp) {
  return bf16_round(__fmul_rn((float)q, sp));
}

// ---------------------------------------------------------------- M == 1
constexpr int GEMV_COLS = 32;   // lanes: one output column each
constexpr int GEMV_WARPS = 16;  // warps: split K by quant group
constexpr int GEMV_THREADS = GEMV_COLS * GEMV_WARPS;

template <typename T, bool PACKED, int G>
__global__ void __launch_bounds__(GEMV_THREADS)
qdot_bf16_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ v,
                      const float* __restrict__ s, const float* __restrict__ mins,
                      T* __restrict__ y, int K, int N, bool after) {
  extern __shared__ float smem[];
  const int n_groups = K / G;
  float* xs = smem;                 // [K]    bf16(x), as f32
  float* xg = smem + K;             // [K/G]  f32 group sums of x
  float* red = xg + n_groups;       // [GEMV_WARPS][GEMV_COLS]
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * GEMV_COLS + lane;
  for (int k = tid; k < K; k += GEMV_THREADS) xs[k] = bf16_round(to_f32(x[k]));
  if (mins) {
    for (int b = tid; b < n_groups; b += GEMV_THREADS) {
      float t = 0.f;
#pragma unroll
      for (int r = 0; r < G; ++r) t += to_f32(x[b * G + r]);
      xg[b] = t;
    }
  }
  __syncthreads();

  const int n = blockIdx.x * GEMV_COLS + lane;
  float acc = 0.f;
  if (n < N) {
    for (int b = warp; b < n_groups; b += GEMV_WARPS) {
      const float sp = mode_scale(s[(size_t)b * N + n], after);
      const float* xb = xs + b * G;
      if (PACKED) {
        constexpr int H = G / 2;
        const uint8_t* vp = v + (size_t)b * H * N + n;
#pragma unroll 8
        for (int r = 0; r < H; ++r) {
          const int q = vp[(size_t)r * N];
          acc = fmaf(xb[r], bf16_weight(q & 0xF, sp), acc);
          acc = fmaf(xb[r + H], bf16_weight(q >> 4, sp), acc);
        }
      } else {
        const int8_t* vp = reinterpret_cast<const int8_t*>(v) + (size_t)b * G * N + n;
        int q[G];
#pragma unroll
        for (int r = 0; r < G; ++r) q[r] = vp[(size_t)r * N];
#pragma unroll
        for (int r = 0; r < G; ++r) acc = fmaf(xb[r], bf16_weight(q[r], sp), acc);
      }
      if (mins) acc = fmaf(-xg[b], mins[(size_t)b * N + n], acc);
    }
  }
  red[warp * GEMV_COLS + lane] = acc;
  __syncthreads();
  if (warp == 0 && n < N) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < GEMV_WARPS; ++w) t += red[w * GEMV_COLS + lane];
    y[n] = from_f32<T>(t);
  }
}

template <typename T, bool PACKED, int G>
cudaError_t launch(const void* x, const void* v, const float* s, const float* mins,
                   void* y, float* ws, int* tickets, int M, int K, int N, int bm,
                   int splits, int k_split, bool after, cudaStream_t stream) {
  if (M > 1) {
    return qtile::tile_by_bm<T, PACKED, G, true>(x, v, s, mins, y, ws, tickets, M, K,
                                                 N, bm, splits, k_split, after, stream);
  }
  const size_t smem = (size_t)(K + K / G + GEMV_THREADS) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(qdot_bf16_gemv_kernel<T, PACKED, G>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 block(GEMV_COLS, GEMV_WARPS);
  dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS);
  qdot_bf16_gemv_kernel<T, PACKED, G><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(v), s, mins,
      static_cast<T*>(y), K, N, after);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* v, int packed, const float* s,
                     const float* mins, void* y, float* ws, int* tickets, int M,
                     int K, int N, int group, int bm, int splits, int k_split,
                     bool after, cudaStream_t stream) {
  if (packed) {
    if (group == 16)
      return launch<T, true, 16>(x, v, s, mins, y, ws, tickets, M, K, N, bm, splits,
                                 k_split, after, stream);
    return launch<T, true, 32>(x, v, s, mins, y, ws, tickets, M, K, N, bm, splits,
                               k_split, after, stream);
  }
  if (group == 16)
    return launch<T, false, 16>(x, v, s, mins, y, ws, tickets, M, K, N, bm, splits,
                                k_split, after, stream);
  return launch<T, false, 32>(x, v, s, mins, y, ws, tickets, M, K, N, bm, splits,
                              k_split, after, stream);
}

}  // namespace

extern "C" int qdot_bf16_launch(const void* x, int x_is_bf16, const void* v,
                                int packed, const void* s, const void* mins,
                                void* y, void* ws, void* tickets, int M, int K,
                                int N, int group, int bm, int splits,
                                int k_split, int after, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (group != 16 && group != 32) || K % group) {
    return (int)cudaErrorInvalidValue;
  }
  if (M > 1 && !qtile::plan_ok(M, K, N, bm, splits, k_split, ws, tickets)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const float* mf = static_cast<const float*>(mins);
  float* wsf = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  if (x_is_bf16) {
    return (int)dispatch<__nv_bfloat16>(x, v, packed, sf, mf, y, wsf, tk, M, K, N,
                                        group, bm, splits, k_split, after != 0, st);
  }
  return (int)dispatch<float>(x, v, packed, sf, mf, y, wsf, tk, M, K, N, group, bm,
                              splits, k_split, after != 0, st);
}
