// Fused dequant-matmul for Hopper (sm_90a):
//
//   y[M, N] = sum_k x[m, k] * (v[k, n] * s[k / g, n] - mins[k / g, n])
//
// Replaces miotts_tpu/ops/qmat.py:_qdot_kernel (reached through
// _qdot_pallas), the one TPU kernel on the offline text-to-WAV path: every
// quantized linear of the LLM (fused QKV, wo, fused gate/up, down, output
// head) runs through it.
//
// Inputs (the JAX package's planar layout, kept as it is):
//   x     bf16 or f32 [M, K], row-major
//   v     int8 [K, N]  (Q8_0, Q6_K, unpacked Q4_0 / Q4_K / Q5_K), or
//         uint8 [K/2, N] nibble-packed PER GROUP: byte row r of group b holds
//         w[b*g + r] in its low nibble and w[b*g + g/2 + r] in its high one
//   s     f32 [K/g, N], g in {16, 32}
//   mins  f32 [K/g, N] or null
//   y     [M, N] in x's type
// Dequantization and accumulation are f32 (the TPU kernel's default
// bf16_dot=False path): the same function as ops/qmat.py:qdot_plain in
// another order of f32 sums.  The output is rounded once to x's type.
//
// What bounds it on the H100: at M = 1 (decode) every weight byte is read
// once for 2 flops, so the kernel is bound by the bytes of v + s + mins over
// the 3.35 TB/s of HBM.  The design keeps those reads coalesced and read
// once: one thread owns one output column n, so the 32 lanes of a warp read
// 32 neighbouring bytes of a row of v (and of s / mins) in one sector; the
// warps of a block split K by quant group, so each (group, column) scale and
// min is loaded once; x is staged once per block in shared memory as f32;
// the per-warp partial sums are reduced in shared memory; the quant group
// is a compile-time constant, so a group's loads are unrolled and several
// are in flight per thread (the kernel is latency-bound at these sizes
// otherwise).  A block covers only 32 columns so the narrow layers of the
// 0.1B model (N = 768) still get 24 blocks.  Blocks run in parallel and in
// no order, so the TPU kernel's K-grid accumulator in scratch becomes the K
// loop inside the block.
//
// At M > 1 (prefill, batched decode, the m8 route) the shared tile of
// qdot_tile.cuh: tensor-core products of bf16 x (an f32 x in three exact
// bf16 parts) with the raw stored integers, a 4-stage cp.async ring of the
// quantized bytes, an f32 fold of s and mins per quant group, and a
// deterministic split-K in the same launch.  Its note says what bounds it.
//
// Plain C interface for ctypes: qdot_launch returns cudaGetLastError().  At
// M > 1 it takes the tile plan of ops/qmat.py:_tile_plan (bm, splits,
// k_split), the f32 workspace [splits][tiles][bm][128] (tiles = the output
// tiles, row-major) and the per-tile tickets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdot_tile.cuh"

namespace {

using qtile::from_f32;
using qtile::to_f32;

// ---------------------------------------------------------------- M == 1
constexpr int GEMV_COLS = 32;   // lanes: one output column each
constexpr int GEMV_WARPS = 16;  // warps: split K by quant group

template <typename T, bool PACKED, bool MINS, int G>
__global__ void __launch_bounds__(GEMV_COLS * GEMV_WARPS)
qdot_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ v,
                 const float* __restrict__ s, const float* __restrict__ mins,
                 T* __restrict__ y, int K, int N) {
  extern __shared__ float smem[];
  float* xs = smem;            // [K]
  float* red = smem + K;       // [GEMV_WARPS][GEMV_COLS]
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * GEMV_COLS + lane;
  for (int k = tid; k < K; k += GEMV_COLS * GEMV_WARPS) xs[k] = to_f32(x[k]);
  __syncthreads();

  const int n = blockIdx.x * GEMV_COLS + lane;
  float acc = 0.f;
  if (n < N) {
    const int n_groups = K / G;
    for (int b = warp; b < n_groups; b += GEMV_WARPS) {
      const float sc = s[(size_t)b * N + n];
      const float mn = MINS ? mins[(size_t)b * N + n] : 0.f;
      const float* xg = xs + b * G;
      // The group size is a template parameter so these loops unroll: int8
      // values issue the whole group's loads before its FMAs; nibbles run an
      // 8-deep partial unroll.  Both were the faster choice measured on an
      // H100 (PERF.md).
      if (PACKED) {
        constexpr int H = G / 2;
        const uint8_t* vp = v + (size_t)b * H * N + n;
#pragma unroll 8
        for (int r = 0; r < H; ++r) {
          const unsigned q = vp[(size_t)r * N];
          acc = fmaf(xg[r], (float)(q & 0xFu) * sc - mn, acc);
          acc = fmaf(xg[r + H], (float)(q >> 4) * sc - mn, acc);
        }
      } else {
        const int8_t* vp = reinterpret_cast<const int8_t*>(v) + (size_t)b * G * N + n;
        int q[G];
#pragma unroll
        for (int r = 0; r < G; ++r) q[r] = vp[(size_t)r * N];
#pragma unroll
        for (int r = 0; r < G; ++r) acc = fmaf(xg[r], (float)q[r] * sc - mn, acc);
      }
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

template <typename T, bool PACKED, bool MINS, int G>
cudaError_t gemv(const void* x, const void* v, const float* s, const float* mins,
                 void* y, int K, int N, cudaStream_t stream) {
  const size_t smem = (size_t)(K + GEMV_COLS * GEMV_WARPS) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(qdot_gemv_kernel<T, PACKED, MINS, G>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 block(GEMV_COLS, GEMV_WARPS);
  dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS);
  qdot_gemv_kernel<T, PACKED, MINS, G><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(v), s, mins,
      static_cast<T*>(y), K, N);
  return cudaGetLastError();
}

template <typename T, bool PACKED, int G>
cudaError_t by_mins(const void* x, const void* v, const float* s,
                    const float* mins, void* y, float* ws, int* tickets, int M,
                    int K, int N, int bm, int splits, int k_split,
                    cudaStream_t stream) {
  if (M > 1) {
    return qtile::tile_by_bm<T, PACKED, G, false>(x, v, s, mins, y, ws, tickets, M, K,
                                                  N, bm, splits, k_split, false,
                                                  stream);
  }
  if (mins) return gemv<T, PACKED, true, G>(x, v, s, mins, y, K, N, stream);
  return gemv<T, PACKED, false, G>(x, v, s, mins, y, K, N, stream);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* v, int packed, const float* s,
                     const float* mins, void* y, float* ws, int* tickets, int M,
                     int K, int N, int group, int bm, int splits, int k_split,
                     cudaStream_t stream) {
  if (packed) {
    if (group == 16)
      return by_mins<T, true, 16>(x, v, s, mins, y, ws, tickets, M, K, N, bm, splits,
                                  k_split, stream);
    return by_mins<T, true, 32>(x, v, s, mins, y, ws, tickets, M, K, N, bm, splits,
                                k_split, stream);
  }
  if (group == 16)
    return by_mins<T, false, 16>(x, v, s, mins, y, ws, tickets, M, K, N, bm, splits,
                                 k_split, stream);
  return by_mins<T, false, 32>(x, v, s, mins, y, ws, tickets, M, K, N, bm, splits,
                               k_split, stream);
}

}  // namespace

extern "C" int qdot_launch(const void* x, int x_is_bf16, const void* v,
                           int packed, const void* s, const void* mins,
                           void* y, void* ws, void* tickets, int M, int K,
                           int N, int group, int bm, int splits, int k_split,
                           void* stream) {
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
                                        group, bm, splits, k_split, st);
  }
  return (int)dispatch<float>(x, v, packed, sf, mf, y, wsf, tk, M, K, N, group, bm,
                              splits, k_split, st);
}
