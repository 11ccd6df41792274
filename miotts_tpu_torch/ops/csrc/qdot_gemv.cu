// The single-stream routes of the quantized matmul for Hopper (sm_90a): the
// kernels the JAX package's `qdot` (miotts_tpu/ops/qmat.py) picks under its
// opt-in switches, each a port of one Pallas kernel:
//
//   K2  qdot_split_launch  <- _qdot_split_kernel        (MIOTTS_PACK4_SPLIT=1)
//       M = 1: the GEMV of qdot_gemv.cuh; M > 1: the tile of qdot_tile.cuh
//   K3  qdot_group_launch  <- _qdot_group_kernel        (MIOTTS_QDOT_GEMV=groupdot)
//       the GEMV of qdot_gemv.cuh
//   K4a qdot_w8a8_launch         <- _qdot_w8a8_kernel         (MIOTTS_QDOT_GEMV=w8a8)
//   K4b qdot_w8a8_packed_launch  <- _qdot_w8a8_packed_kernel  (the same, packed)
//       the GEMV of qdot_gemv.cuh in its integer-partial form
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
//       partials d = sum xq * q (int32, __dp4a) a chunk of a group; y = sum
//       d * (s * sx) minus sum mn * (sx * sum xq), the mins term of x^ =
//       xq * sx.
//
// K2 at M > 1 is K1's function on K1's packed layout, so it runs K1's tile
// (qdot_tile.cuh, its note says what bounds it) under the same plan
// (ops/qmat.py:_tile_plan): K2 and K1 give the same bits there.
//
// K2 at M = 1 and K3 run the split-K GEMV of qdot_gemv.cuh in its
// group-partial form (its note says what bounds it), as K1 does at M = 1:
// on one plan (ops/qmat.py:_gemv_plan) K3 and K1 with bf16 x, and K2 and
// K1 with f32 x, give the same bits.  K4a and K4b run the same GEMV in its
// integer-partial form under the same plan.
//
// What is not carried over from the TPU: K4's block-diagonal [K/g, K]
// expansion of xq and its lane-replicated sx (Mosaic had no 8-bit
// elementwise arithmetic), and the separate launches that quantized x and
// computed the mins term: here each block quantizes its own K slice of x
// into shared memory and the mins ride the chunk's fold, so one linear is
// one launch.  K2's split of x into lo / hi halves needs no copy either: the
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

bool bad_shape(int M, int K, int N, int group) {
  return M < 1 || K < 1 || N < 1 || (group != 16 && group != 32) || K % group;
}

// K4a (PACKED false) / K4b: the GEMV's integer-partial form
template <bool PACKED>
int w8a8(const void* x, const void* v, const void* s, const void* mins, void* y,
         int x_is_bf16, int K, int N, int group, int splits, int k_split,
         void* stream) {
  if (bad_shape(1, K, N, group) || !qgemv::gemv_plan_ok(K, group, splits, k_split)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const float* mf = static_cast<const float*>(mins);
  if (x_is_bf16) {
    return (int)qgemv::gemv<__nv_bfloat16, PACKED, qgemv::INT_PARTIAL>(
        x, v, sf, mf, y, K, N, group, splits, k_split, st);
  }
  return (int)qgemv::gemv<float, PACKED, qgemv::INT_PARTIAL>(x, v, sf, mf, y, K, N, group,
                                                             splits, k_split, st);
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

// K4a: x [1, K] (bf16 or f32), int8 values; the GEMV under the plan of
// ops/qmat.py:_gemv_plan.
extern "C" int qdot_w8a8_launch(const void* x, const void* v, const void* s,
                                const void* mins, void* y, int x_is_bf16,
                                int K, int N, int group, int splits,
                                int k_split, void* stream) {
  return w8a8<false>(x, v, s, mins, y, x_is_bf16, K, N, group, splits, k_split,
                     stream);
}

// K4b: x [1, K] (bf16 or f32), packed values; the same.
extern "C" int qdot_w8a8_packed_launch(const void* x, const void* v,
                                       const void* s, const void* mins,
                                       void* y, int x_is_bf16, int K, int N,
                                       int group, int splits, int k_split,
                                       void* stream) {
  return w8a8<true>(x, v, s, mins, y, x_is_bf16, K, N, group, splits, k_split,
                    stream);
}
