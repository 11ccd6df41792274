// The single-stream routes of the quantized matmul for Hopper (sm_90a): the
// kernels the JAX package's `qdot` (miotts_tpu/ops/qmat.py) picks under its
// opt-in switches, each a port of one Pallas kernel:
//
//   K2  qdot_split_kernel        <- _qdot_split_kernel        (MIOTTS_PACK4_SPLIT=1)
//   K3  qdot_group_kernel        <- _qdot_group_kernel        (MIOTTS_QDOT_GEMV=groupdot)
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
// What each computes (the JAX function, step for step):
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
// What bounds them on the H100: at M = 1 every weight byte is read once for
// two operations, so all four are bound by the bytes of v + s + mins over the
// 3.35 TB/s of HBM (the int8 op bound of K4, 2KN / 1979 TOP/s, is two orders
// below).  The layout is K1's GEMV: one thread owns one output column, so the
// 32 lanes of a warp read 32 neighbouring bytes of a row of v (and of s /
// mins) in one sector; the 16 warps of a block split K by quant group, each
// (group, column) scale and min is loaded once, and the per-warp sums meet in
// shared memory.  The quant group is a compile-time constant so a group's
// loads unroll and several are in flight per thread.
//
// What is not carried over from the TPU: K4's block-diagonal [K/g, K]
// expansion of xq and its lane-replicated sx (Mosaic had no 8-bit
// elementwise arithmetic), and the separate launches that quantized x and
// computed the mins term: here each block quantizes the x row itself into
// shared memory (K bytes of xq plus the K/g scales) and the mins ride the
// per-group scale, so one linear is one launch.  K2's split of x into lo / hi
// halves needs no copy either: the kernel reads both halves of a group from
// the staged x.  Blocks run in parallel and in no order, so the TPU kernels'
// K-grid accumulator becomes the K loop inside the block.
//
// K2 takes any M (the prefill runs it at the prompt bucket): a block covers
// MT = 8 rows (1 at M = 1) and stages x in chunks of 16 * GPW groups, as f32,
// in shared memory.
//
// Plain C interface for ctypes: each *_launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

constexpr int COLS = 32;    // lanes: one output column each
constexpr int WARPS = 16;   // warps: split K by quant group
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

// ------------------------------------------------------------------- K2
// MT rows per block; the x chunk is GPW groups per warp, so at MT = 1 the
// whole x of a 2560-wide layer is staged at once.
template <typename T, bool MINS, int G, int MT>
__global__ void __launch_bounds__(THREADS)
qdot_split_kernel(const T* __restrict__ x, const uint8_t* __restrict__ v,
                  const float* __restrict__ s, const float* __restrict__ mins,
                  T* __restrict__ y, int M, int K, int N) {
  constexpr int H = G / 2;
  constexpr int GPW = MT == 1 ? 8 : 1;
  constexpr int CHUNK = WARPS * GPW * G;            // x columns per step
  __shared__ float xs[MT][CHUNK];
  __shared__ float red[MT][WARPS * COLS];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * COLS + lane;
  const int n = blockIdx.x * COLS + lane;
  const int nc = min(n, N - 1);        // loads clamp; the store masks
  const int m0 = blockIdx.y * MT;
  const int n_groups = K / G;
  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;

  for (int b0 = 0; b0 < n_groups; b0 += WARPS * GPW) {
    const int k0 = b0 * G;
    for (int e = tid; e < MT * CHUNK; e += THREADS) {
      const int mm = e / CHUNK, kk = e % CHUNK;
      const int m = m0 + mm, k = k0 + kk;
      xs[mm][kk] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < GPW; ++j) {
      const int bl = j * WARPS + warp;     // group within the chunk
      const int b = b0 + bl;
      if (b >= n_groups) break;
      const float sc = s[(size_t)b * N + nc];
      const uint8_t* vp = v + (size_t)b * H * N + nc;
      float xsum[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) xsum[i] = 0.f;
#pragma unroll 8
      for (int r = 0; r < H; ++r) {
        const unsigned q = vp[(size_t)r * N];
        const float w_lo = (float)(q & 0xFu) * sc;   // each nibble plane
        const float w_hi = (float)(q >> 4) * sc;     // dequantized in place
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float x_lo = xs[i][bl * G + r], x_hi = xs[i][bl * G + H + r];
          acc[i] = fmaf(x_lo, w_lo, acc[i]);
          acc[i] = fmaf(x_hi, w_hi, acc[i]);
          if (MINS) xsum[i] += x_lo + x_hi;
        }
      }
      if (MINS) {
        const float mn = mins[(size_t)b * N + nc];
#pragma unroll
        for (int i = 0; i < MT; ++i) acc[i] = fmaf(-mn, xsum[i], acc[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) red[i][warp * COLS + lane] = acc[i];
  __syncthreads();
  // warp i writes row m0 + i
  for (int i = warp; i < MT; i += WARPS) {
    if (m0 + i < M) write_column<T>(red[i], y, n, N, (size_t)(m0 + i) * N);
  }
}

// ------------------------------------------------------------------- K3
template <bool PACKED, bool MINS, int G>
__global__ void __launch_bounds__(THREADS)
qdot_group_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ v, const float* __restrict__ s,
                  const float* __restrict__ mins,
                  __nv_bfloat16* __restrict__ y, int K, int N) {
  extern __shared__ float smem[];
  const int n_groups = K / G;
  float* xs = smem;                    // [K] x (bf16 values, exact in f32)
  float* xg = xs + K;                  // [K/G] group sums of x
  float* red = xg + n_groups;          // [WARPS * COLS]
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * COLS + lane;
  for (int k = tid; k < K; k += THREADS) xs[k] = __bfloat162float(x[k]);
  __syncthreads();
  if (MINS) {
    for (int b = tid; b < n_groups; b += THREADS) {
      float t = 0.f;
      for (int r = 0; r < G; ++r) t += xs[b * G + r];
      xg[b] = t;
    }
    __syncthreads();
  }
  const int n = blockIdx.x * COLS + lane;
  const int nc = min(n, N - 1);
  float acc = 0.f;
  for (int b = warp; b < n_groups; b += WARPS) {
    const float* xb = xs + b * G;
    float d = 0.f;                     // this group's partial, scale after
    if (PACKED) {
      constexpr int H = G / 2;
      const uint8_t* vp = v + (size_t)b * H * N + nc;
#pragma unroll 8
      for (int r = 0; r < H; ++r) {
        const unsigned q = vp[(size_t)r * N];
        d = fmaf(xb[r], (float)(q & 0xFu), d);
        d = fmaf(xb[r + H], (float)(q >> 4), d);
      }
    } else {
      const int8_t* vp = reinterpret_cast<const int8_t*>(v) + (size_t)b * G * N + nc;
      int q[G];
#pragma unroll
      for (int r = 0; r < G; ++r) q[r] = vp[(size_t)r * N];
#pragma unroll
      for (int r = 0; r < G; ++r) d = fmaf(xb[r], (float)q[r], d);
    }
    acc = fmaf(d, s[(size_t)b * N + nc], acc);
    if (MINS) acc = fmaf(-mins[(size_t)b * N + nc], xg[b], acc);
  }
  red[warp * COLS + lane] = acc;
  __syncthreads();
  if (warp == 0) write_column<__nv_bfloat16>(red, y, n, N, 0);
}

// ------------------------------------------------------------------- K4
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

struct SplitLaunch {
  template <typename T, bool MINS, int G>
  static void run(const Args& a) {
    const T* x = static_cast<const T*>(a.x);
    T* y = static_cast<T*>(a.y);
    const dim3 block(COLS, WARPS);
    if (a.M == 1) {
      qdot_split_kernel<T, MINS, G, 1><<<dim3(cdiv(a.N, COLS)), block, 0, a.st>>>(
          x, a.v, a.s, a.mins, y, a.M, a.K, a.N);
    } else {
      qdot_split_kernel<T, MINS, G, 8>
          <<<dim3(cdiv(a.N, COLS), cdiv(a.M, 8)), block, 0, a.st>>>(
              x, a.v, a.s, a.mins, y, a.M, a.K, a.N);
    }
  }
};

// P: std::true_type for packed values, std::false_type for int8 ones
struct GroupLaunch {
  template <typename P, bool MINS, int G>
  static void run(const Args& a) {
    auto kern = qdot_group_kernel<P::value, MINS, G>;
    const size_t smem = (size_t)(a.K + a.K / G + THREADS) * sizeof(float);
    allow_smem(kern, smem);
    kern<<<cdiv(a.N, COLS), dim3(COLS, WARPS), smem, a.st>>>(
        static_cast<const __nv_bfloat16*>(a.x), a.v, a.s, a.mins,
        static_cast<__nv_bfloat16*>(a.y), a.K, a.N);
  }
};

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

// K2: x [M, K] (bf16 or f32), packed values.
extern "C" int qdot_split_launch(const void* x, const void* v, const void* s,
                                 const void* mins, void* y, int x_is_bf16,
                                 int M, int K, int N, int group, void* stream) {
  if (bad_shape(M, K, N, group)) return (int)cudaErrorInvalidValue;
  by_dtype<SplitLaunch>(make_args(x, v, s, mins, y, M, K, N, group, stream),
                        x_is_bf16);
  return (int)cudaGetLastError();
}

// K3: x [1, K] bf16, int8 or packed values.
extern "C" int qdot_group_launch(const void* x, const void* v, const void* s,
                                 const void* mins, void* y, int packed, int K,
                                 int N, int group, void* stream) {
  if (bad_shape(1, K, N, group)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, v, s, mins, y, 1, K, N, group, stream);
  if (packed) by_mins<GroupLaunch, std::true_type>(a);
  else by_mins<GroupLaunch, std::false_type>(a);
  return (int)cudaGetLastError();
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
