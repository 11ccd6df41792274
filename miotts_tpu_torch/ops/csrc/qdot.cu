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
// bf16_dot=False path); the mins term is fused into the dequant.  The output
// is rounded once to x's type.
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
// At M > 1 (prefill, M = prompt bucket) a 64 x 64 output tile per block
// loops over K in steps of 32: the x tile (as f32) and the dequantized
// weight tile go through shared memory, and each of the 256 threads keeps a
// 4 x 4 block of f32 accumulators (FMA on the CUDA cores, which keeps the
// f32 dequant exact) and reads its 4 x and 4 w values of a k as one 16-byte
// load each.  The next K-step's global loads go into registers before this
// step's FMAs, so their latency is hidden behind the arithmetic (a block
// that waited on each step's loads in turn ran ~6 us per step).  Ragged
// M / N / K edges are masked.
//
// Plain C interface for ctypes: qdot_launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

// ---------------------------------------------------------------- M > 1
constexpr int TM = 64, TN = 64, TK = 32, TILE_THREADS = 256;
constexpr int XR = TM * TK / TILE_THREADS;    // x elements each thread loads
constexpr int WR = TK * TN / TILE_THREADS;    // weight elements each thread loads
constexpr int XM_STEP = TILE_THREADS / TK;    // rows between a thread's x loads
constexpr int WK_STEP = TILE_THREADS / TN;    // rows between a thread's w loads
constexpr int XS_STRIDE = TM + 4;             // 16-byte rows, 4-way store conflicts

// One K-step's global loads, held raw in registers until the step is stored
// to shared memory.  Out-of-range elements load from a clamped address (so
// the loads carry no branch and issue back to back) and are zeroed at the
// store.
template <typename T, bool PACKED, bool MINS, int G>
struct TileLoads {
  T xr[XR];
  int qr[WR];          // int8 value, or the whole byte of a packed pair
  float sr[WR], mr[WR];

  __device__ __forceinline__ void load(const T* x, const uint8_t* v,
                                       const float* s, const float* mins,
                                       int M, int K, int N, int m0, int n,
                                       int xm, int xk, int wk, int k0) {
#pragma unroll
    for (int r = 0; r < XR; ++r) {
      const int m = min(m0 + xm + XM_STEP * r, M - 1), k = min(k0 + xk, K - 1);
      xr[r] = x[(size_t)m * K + k];
    }
    const int nc = min(n, N - 1);
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const int k = min(k0 + wk + WK_STEP * r, K - 1);
      const int b = k / G;
      if (PACKED) {
        constexpr int H = G / 2;
        const int rr = k - b * G;
        qr[r] = v[((size_t)b * H + (rr < H ? rr : rr - H)) * N + nc];
      } else {
        qr[r] = reinterpret_cast<const int8_t*>(v)[(size_t)k * N + nc];
      }
      sr[r] = s[(size_t)b * N + nc];
      mr[r] = MINS ? mins[(size_t)b * N + nc] : 0.f;
    }
  }

  __device__ __forceinline__ void store(float (*xs)[XS_STRIDE], float (*ws)[TN],
                                        int M, int K, int N, int m0, int n,
                                        int xm, int xk, int wk, int wn,
                                        int k0) const {
#pragma unroll
    for (int r = 0; r < XR; ++r) {
      const int mm = xm + XM_STEP * r;
      xs[xk][mm] = (m0 + mm < M && k0 + xk < K) ? to_f32(xr[r]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const int kk = wk + WK_STEP * r, k = k0 + kk;
      int q = qr[r];
      if (PACKED) q = (k % G < G / 2) ? (q & 0xF) : (q >> 4);
      float w = (float)q * sr[r];
      if (MINS) w -= mr[r];
      ws[kk][wn] = (k < K && n < N) ? w : 0.f;
    }
  }
};

template <typename T, bool PACKED, bool MINS, int G>
__global__ void __launch_bounds__(TILE_THREADS)
qdot_tiled_kernel(const T* __restrict__ x, const uint8_t* __restrict__ v,
                  const float* __restrict__ s, const float* __restrict__ mins,
                  T* __restrict__ y, int M, int K, int N) {
  __shared__ __align__(16) float xs[TK][XS_STRIDE];  // x tile, transposed: xs[k][m]
  __shared__ __align__(16) float ws[TK][TN];         // dequantized weight tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // outputs (4 ty + i, 4 tx + j)
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  // load coordinates: neighbouring threads read neighbouring k of x and
  // neighbouring n of v / s / mins
  const int xk = tid % TK, xm = tid / TK;
  const int wn = tid % TN, wk = tid / TN;
  const int n = n0 + wn;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  TileLoads<T, PACKED, MINS, G> next;
  next.load(x, v, s, mins, M, K, N, m0, n, xm, xk, wk, 0);
  for (int k0 = 0; k0 < K; k0 += TK) {
    next.store(xs, ws, M, K, N, m0, n, xm, xk, wk, wn, k0);
    __syncthreads();
    // the next step's loads are in flight while this step's FMAs run
    if (k0 + TK < K) next.load(x, v, s, mins, M, K, N, m0, n, xm, xk, wk, k0 + TK);
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bw[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + 4 * tx + j;
      if (nn < N) y[(size_t)m * N + nn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, bool PACKED, bool MINS, int G>
void launch(const void* x, const void* v, const float* s, const float* mins,
            void* y, int M, int K, int N, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const uint8_t* vt = static_cast<const uint8_t*>(v);
  T* yt = static_cast<T*>(y);
  if (M == 1) {
    const size_t smem = (size_t)(K + GEMV_COLS * GEMV_WARPS) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(qdot_gemv_kernel<T, PACKED, MINS, G>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    dim3 block(GEMV_COLS, GEMV_WARPS);
    dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS);
    qdot_gemv_kernel<T, PACKED, MINS, G><<<grid, block, smem, stream>>>(
        xt, vt, s, mins, yt, K, N);
  } else {
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    qdot_tiled_kernel<T, PACKED, MINS, G><<<grid, TILE_THREADS, 0, stream>>>(
        xt, vt, s, mins, yt, M, K, N);
  }
}

template <typename T, bool PACKED, bool MINS>
void by_group(const void* x, const void* v, const float* s, const float* mins,
              void* y, int M, int K, int N, int group, cudaStream_t stream) {
  if (group == 16) launch<T, PACKED, MINS, 16>(x, v, s, mins, y, M, K, N, stream);
  else launch<T, PACKED, MINS, 32>(x, v, s, mins, y, M, K, N, stream);
}

template <typename T>
void dispatch(const void* x, const void* v, int packed, const float* s,
              const float* mins, void* y, int M, int K, int N, int group,
              cudaStream_t stream) {
  if (packed) {
    if (mins) by_group<T, true, true>(x, v, s, mins, y, M, K, N, group, stream);
    else by_group<T, true, false>(x, v, s, mins, y, M, K, N, group, stream);
  } else {
    if (mins) by_group<T, false, true>(x, v, s, mins, y, M, K, N, group, stream);
    else by_group<T, false, false>(x, v, s, mins, y, M, K, N, group, stream);
  }
}

}  // namespace

extern "C" int qdot_launch(const void* x, int x_is_bf16, const void* v,
                           int packed, const void* s, const void* mins,
                           void* y, int M, int K, int N, int group,
                           void* stream) {
  if (M < 1 || K < 1 || N < 1 || (group != 16 && group != 32) || K % group) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const float* mf = static_cast<const float*>(mins);
  if (x_is_bf16) {
    dispatch<__nv_bfloat16>(x, v, packed, sf, mf, y, M, K, N, group, st);
  } else {
    dispatch<float>(x, v, packed, sf, mf, y, M, K, N, group, st);
  }
  return (int)cudaGetLastError();
}
