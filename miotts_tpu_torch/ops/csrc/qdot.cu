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
//   s     f32 or bf16 [K/g, N], g in {16, 32} (s_is_bf16; MIOTTS_SCALE_BF16)
//   mins  [K/g, N] of s's type, or null
//   y     [M, N] in x's type, or f32 (y_is_f32: the unrounded sum, a
//         row-parallel shard's partial)
// Dequantization and accumulation are f32 (the TPU kernel's default
// bf16_dot=False path): the same function as ops/qmat.py:qdot_plain in
// another order of f32 sums.  The output is rounded once to x's type.  bf16
// scales and mins have instantiations of their own (S), which read half the
// scale bytes and upcast each value exactly where it is loaded, as the
// Pallas kernel's s_ref[:].astype(f32) does.
//
// At M = 1 (decode) the split-K GEMV of qdot_gemv.cuh in its
// group-partial form: per chunk of a quant group the f32 partial sum of x *
// v, folded as s * P - mins * (the chunk's sum of x); 16-byte loads a lane,
// K split over a thread-block cluster that sums in rank order (the plan:
// ops/qmat.py:_gemv_plan).  Its note says what bounds it.  On one plan it is
// K3's instantiation for bf16 x and K2's for f32 x on packed values: the
// same bits.
//
// At M > 1 (prefill, batched decode, the m8 route) the shared tile of
// qdot_tile.cuh: tensor-core products of bf16 x (an f32 x in three exact
// bf16 parts) with the raw stored integers, a 4-stage cp.async ring of the
// quantized bytes, an f32 fold of s and mins per quant group, and a
// deterministic split-K in the same launch.  Its note says what bounds it.
//
// Plain C interface for ctypes: qdot_launch returns the launch's
// cudaError_t; s_is_bf16 picks the scales' instantiation.  At M = 1 it takes the GEMV plan of ops/qmat.py:_gemv_plan
// (splits, k_split; bm, ws and tickets unused); at M > 1 the tile plan of
// ops/qmat.py:_tile_plan (bm, splits, k_split), the f32 workspace
// [splits][tiles][bm][128] (tiles = the output tiles, row-major) and the
// per-tile tickets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdot_gemv.cuh"
#include "qdot_tile.cuh"

namespace {

template <typename T, typename S, bool PACKED>
cudaError_t by_m(const void* x, const void* v, const void* s, const void* mins,
                 void* y, bool y_f32, float* ws, int* tickets, int M, int K, int N,
                 int group, int bm, int splits, int k_split, cudaStream_t stream) {
  if (M == 1) {
    return qgemv::gemv<T, S, PACKED>(x, v, s, mins, y, y_f32, K, N, group, splits,
                                     k_split, stream);
  }
  if (group == 16) {
    return qtile::tile_by_bm<T, S, PACKED, 16, false>(x, v, s, mins, y, y_f32, ws,
                                                      tickets, M, K, N, bm, splits,
                                                      k_split, false, stream);
  }
  return qtile::tile_by_bm<T, S, PACKED, 32, false>(x, v, s, mins, y, y_f32, ws,
                                                    tickets, M, K, N, bm, splits,
                                                    k_split, false, stream);
}

template <typename T, typename S>
cudaError_t dispatch(const void* x, const void* v, int packed, const void* s,
                     const void* mins, void* y, bool y_f32, float* ws, int* tickets,
                     int M, int K, int N, int group, int bm, int splits,
                     int k_split, cudaStream_t stream) {
  if (packed) {
    return by_m<T, S, true>(x, v, s, mins, y, y_f32, ws, tickets, M, K, N, group, bm,
                            splits, k_split, stream);
  }
  return by_m<T, S, false>(x, v, s, mins, y, y_f32, ws, tickets, M, K, N, group, bm,
                           splits, k_split, stream);
}

template <typename T>
cudaError_t by_scales(const void* x, const void* v, int packed, const void* s,
                      const void* mins, int s_is_bf16, void* y, bool y_f32,
                      float* ws, int* tickets, int M, int K, int N, int group,
                      int bm, int splits, int k_split, cudaStream_t stream) {
  if (s_is_bf16) {
    return dispatch<T, __nv_bfloat16>(x, v, packed, s, mins, y, y_f32, ws, tickets, M,
                                      K, N, group, bm, splits, k_split, stream);
  }
  return dispatch<T, float>(x, v, packed, s, mins, y, y_f32, ws, tickets, M, K, N,
                            group, bm, splits, k_split, stream);
}

}  // namespace

extern "C" int qdot_launch(const void* x, int x_is_bf16, const void* v,
                           int packed, const void* s, const void* mins,
                           int s_is_bf16, void* y, int y_is_f32, void* ws,
                           void* tickets, int M, int K, int N, int group, int bm,
                           int splits, int k_split, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (group != 16 && group != 32) || K % group) {
    return (int)cudaErrorInvalidValue;
  }
  if (M > 1 ? !qtile::plan_ok(M, K, N, bm, splits, k_split, ws, tickets)
            : !qgemv::gemv_plan_ok(K, group, splits, k_split)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  if (x_is_bf16) {
    return (int)by_scales<__nv_bfloat16>(x, v, packed, s, mins, s_is_bf16, y,
                                         y_is_f32 != 0, wsf, tk, M, K, N, group, bm,
                                         splits, k_split, st);
  }
  return (int)by_scales<float>(x, v, packed, s, mins, s_is_bf16, y, y_is_f32 != 0, wsf,
                               tk, M, K, N, group, bm, splits, k_split, st);
}
