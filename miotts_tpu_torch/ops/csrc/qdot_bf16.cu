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
// M = 1 (decode): the split-K GEMV of qdot_gemv.cuh in its bf16-weight
// form: each chunk of a quant group loads s' for its 16 columns before its
// products, rounds each w = bf16(q * s') in registers and sums bf16(x) * w
// from zero in f32 FMAs (every product exact), which an IEEE f32 add folds
// into the lane's accumulator; then the chunk's mins term, from its f32
// sum of the unrounded x.  16-byte loads a lane and K split over a
// thread-block cluster that sums in rank order, as K1, K2 and K3 (the plan:
// ops/qmat.py:_gemv_plan).  Kernel and plain version differ only in the
// order of the f32 sums.
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
// Plain C interface for ctypes: qdot_bf16_launch returns the launch's
// cudaError_t; it takes the GEMV plan at M = 1 and the tile plan, workspace
// and tickets at M > 1, as qdot_launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdot_gemv.cuh"
#include "qdot_tile.cuh"

namespace {

template <typename T, bool PACKED>
cudaError_t by_m(const void* x, const void* v, const float* s, const float* mins,
                 void* y, float* ws, int* tickets, int M, int K, int N, int group,
                 int bm, int splits, int k_split, bool after, cudaStream_t stream) {
  if (M == 1) {
    return qgemv::gemv<T, PACKED, qgemv::BF16_WEIGHT>(x, v, s, mins, y, K, N, group,
                                                      splits, k_split, stream, after);
  }
  if (group == 16) {
    return qtile::tile_by_bm<T, PACKED, 16, true>(x, v, s, mins, y, ws, tickets, M, K,
                                                  N, bm, splits, k_split, after, stream);
  }
  return qtile::tile_by_bm<T, PACKED, 32, true>(x, v, s, mins, y, ws, tickets, M, K, N,
                                                bm, splits, k_split, after, stream);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* v, int packed, const float* s,
                     const float* mins, void* y, float* ws, int* tickets, int M,
                     int K, int N, int group, int bm, int splits, int k_split,
                     bool after, cudaStream_t stream) {
  if (packed) {
    return by_m<T, true>(x, v, s, mins, y, ws, tickets, M, K, N, group, bm, splits,
                         k_split, after, stream);
  }
  return by_m<T, false>(x, v, s, mins, y, ws, tickets, M, K, N, group, bm, splits,
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
  if (M > 1 ? !qtile::plan_ok(M, K, N, bm, splits, k_split, ws, tickets)
            : !qgemv::gemv_plan_ok(K, group, splits, k_split)) {
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
