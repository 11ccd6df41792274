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
// M > 1 (prefill, batched decode): the variant's operands are exactly what
// the tensor cores take, so a block computes a BM x 64 output tile (BM = 16
// for M <= 16, the batched decode's slots; 64 above) with
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.  Per K step of 32:
// the block's 128 threads load x and the weight bytes into registers (the
// next step's loads are issued before this step's mma, so their latency
// hides behind the arithmetic, as in K1's tile), store bf16(x) and the
// rounded bf16 weights into shared memory (rows padded to 40 halves, so the
// fragment loads of the 8 row groups fall in distinct banks), and each warp
// runs its m16n8k16 products from there into f32 partial sums of the
// step, which IEEE f32 adds then fold into the long accumulators (the
// tensor cores' own f32 sums truncate; chained over K = 8192 they drifted
// 1e-5 of the output scale from the plain version).  The mins term of the
// step's one or two groups is subtracted from the same f32 accumulators in
// the step (f32 FMAs of xg and mins staged beside the tiles).  Ragged M / N
// / K edges load zeros and are not stored.  This is the simple form: no
// TMA, no wgmma, no warp specialisation.
//
// Plain C interface for ctypes: qdot_bf16_launch returns cudaGetLastError().

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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// ---------------------------------------------------------------- M > 1
constexpr int BN = 64, BK = 32, TILE_THREADS = 128;
constexpr int SROW = BK + 8;     // shared row in halves: 80 bytes, 8 row groups
                                 // of a fragment load in distinct banks
constexpr int WK_ROWS = 16;      // weight rows (k) each thread loads per step
static_assert(BN * BK == TILE_THREADS * WK_ROWS, "one weight load per thread");

template <int BM> struct Tile {
  static constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int MT = BM / 16 / WARPS_M;          // m16 tiles per warp
  static constexpr int NT = BN / 8 / WARPS_N;           // n8 tiles per warp
  static constexpr int XV = BM * BK / TILE_THREADS;     // x elements per thread
  static constexpr int X_PER_ROW = BK / XV;             // threads per x row
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One K step's global loads, held raw in registers until the step is stored
// to shared memory.  Out-of-range elements load from a clamped address (no
// branch between the loads) and are zeroed at the store.
template <typename T, bool PACKED, int G, int BM>
struct StepLoads {
  using S = Tile<BM>;
  T xr[S::XV];
  int qr[WK_ROWS];   // int8 value, or the whole byte of a packed pair
  float sr, mr;      // the scale and min of this thread's weight rows

  __device__ __forceinline__ void load(const T* x, const uint8_t* v,
                                       const float* s, const float* mins,
                                       int M, int K, int N, int m, int xk,
                                       int n, int wk, int k0) {
    const int mc = min(m, M - 1);
#pragma unroll
    for (int i = 0; i < S::XV; ++i) xr[i] = x[(size_t)mc * K + min(k0 + xk + i, K - 1)];
    const int nc = min(n, N - 1);
    const int kw = min(k0 + wk, K - 1);   // a thread's 16 rows lie in one group
    const int b = kw / G;
#pragma unroll
    for (int i = 0; i < WK_ROWS; ++i) {
      const int k = min(k0 + wk + i, K - 1);
      if (PACKED) {
        constexpr int H = G / 2;
        const int r = k - (k / G) * G;
        qr[i] = v[((size_t)(k / G) * H + (r < H ? r : r - H)) * N + nc];
      } else {
        qr[i] = reinterpret_cast<const int8_t*>(v)[(size_t)k * N + nc];
      }
    }
    sr = s[(size_t)b * N + nc];
    mr = mins ? mins[(size_t)b * N + nc] : 0.f;
  }

  __device__ __forceinline__ void store(__nv_bfloat16 (*as)[SROW],
                                        __nv_bfloat16 (*bs)[SROW],
                                        float (*xgs)[2], float (*ms)[BN],
                                        bool has_mins, bool after,
                                        int M, int K, int N, int m, int xm,
                                        int xk, int n, int wn, int wk,
                                        int k0) const {
    // x: bf16(x) into the A tile; the f32 group sums of the unrounded x
    float xf[S::XV];
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < S::XV; ++i) {
      xf[i] = (m < M && k0 + xk + i < K) ? to_f32(xr[i]) : 0.f;
      part += xf[i];
    }
#pragma unroll
    for (int i = 0; i < S::XV; i += 2) {
      *reinterpret_cast<__nv_bfloat162*>(&as[xm][xk + i]) =
          __floats2bfloat162_rn(xf[i], xf[i + 1]);
    }
    if (has_mins) {
      // the G / XV threads of a group are neighbouring lanes
#pragma unroll
      for (int o = 1; o < (G >= S::XV ? G / S::XV : 1); o <<= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      if (xk % G == 0) xgs[xm][xk / G] = part;
    }
    // weights: bf16(q * s') into the B tile, stored [n][k]
    const bool live = n < N;
    const float sp = mode_scale(sr, after);
#pragma unroll
    for (int i = 0; i < WK_ROWS; i += 2) {
      float w2[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + wk + i + j;
        int q = qr[i + j];
        if (PACKED) q = (k % G < G / 2) ? (q & 0xF) : (q >> 4);
        w2[j] = (live && k < K) ? bf16_weight(q, sp) : 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(&bs[wn][wk + i]) =
          __floats2bfloat162_rn(w2[0], w2[1]);
    }
    if (has_mins && (wk % G == 0)) ms[wk / G][wn] = (live && k0 + wk < K) ? mr : 0.f;
  }
};

template <typename T, bool PACKED, int G, int BM>
__global__ void __launch_bounds__(TILE_THREADS)
qdot_bf16_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ v,
                     const float* __restrict__ s, const float* __restrict__ mins,
                     T* __restrict__ y, int M, int K, int N, bool after) {
  using S = Tile<BM>;
  __shared__ __align__(16) __nv_bfloat16 as[BM][SROW];   // bf16(x): [m][k]
  __shared__ __align__(16) __nv_bfloat16 bs[BN][SROW];   // bf16(w): [n][k]
  __shared__ float xgs[BM][2];                           // group sums of x
  __shared__ float ms[2][BN];                            // the step's mins
  const bool has_mins = mins != nullptr;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp / S::WARPS_N, wnw = warp % S::WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // load coordinates: x row xm, columns xk..xk+XV; weight column wn, rows
  // wk..wk+16 (neighbouring threads read neighbouring n of a row of v)
  const int xm = tid / S::X_PER_ROW, xk = (tid % S::X_PER_ROW) * S::XV;
  const int wn = tid % BN, wk = (tid / BN) * WK_ROWS;
  const int m = m0 + xm, n = n0 + wn;

  float acc[S::MT][S::NT][4];
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  StepLoads<T, PACKED, G, BM> next;
  next.load(x, v, s, mins, M, K, N, m, xk, n, wk, 0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    next.store(as, bs, xgs, ms, has_mins, after, M, K, N, m, xm, xk, n, wn,
               wk, k0);
    __syncthreads();
    // the next step's loads are in flight while this step's mma run
    if (k0 + BK < K) next.load(x, v, s, mins, M, K, N, m, xk, n, wk, k0 + BK);
    // this step's products, summed by the tensor cores from zero and then
    // added to the long f32 accumulator with IEEE adds: the mma's own f32
    // sums truncate, which over a long K (8192: 512 chained mma) biased the
    // result by 1e-5 of its scale
    float part[S::MT][S::NT][4];
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < S::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[S::MT][4];
#pragma unroll
      for (int i = 0; i < S::MT; ++i) {
        const int r = (wm * S::MT + i) * 16 + gid;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&as[r][kk + 2 * tig]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&as[r + 8][kk + 2 * tig]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&as[r][kk + 2 * tig + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&as[r + 8][kk + 2 * tig + 8]);
      }
#pragma unroll
      for (int j = 0; j < S::NT; ++j) {
        const int c = (wnw * S::NT + j) * 8 + gid;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&bs[c][kk + 2 * tig]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&bs[c][kk + 2 * tig + 8]);
#pragma unroll
        for (int i = 0; i < S::MT; ++i) mma_bf16(part[i][j], a[i], b0, b1);
      }
    }
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < S::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    if (has_mins) {
      // minus sum_b xg[m, b] * mins[b, n] over the step's groups, in f32
      constexpr int GS = BK / G;
#pragma unroll
      for (int i = 0; i < S::MT; ++i) {
        const int r = (wm * S::MT + i) * 16 + gid;
#pragma unroll
        for (int j = 0; j < S::NT; ++j) {
          const int c = (wnw * S::NT + j) * 8 + 2 * tig;
#pragma unroll
          for (int g = 0; g < GS; ++g) {
            acc[i][j][0] = fmaf(-xgs[r][g], ms[g][c], acc[i][j][0]);
            acc[i][j][1] = fmaf(-xgs[r][g], ms[g][c + 1], acc[i][j][1]);
            acc[i][j][2] = fmaf(-xgs[r + 8][g], ms[g][c], acc[i][j][2]);
            acc[i][j][3] = fmaf(-xgs[r + 8][g], ms[g][c + 1], acc[i][j][3]);
          }
        }
      }
    }
    __syncthreads();
  }
  // c0, c1: row gid, columns 2 tig, 2 tig + 1; c2, c3: row gid + 8
#pragma unroll
  for (int i = 0; i < S::MT; ++i) {
#pragma unroll
    for (int j = 0; j < S::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mm = m0 + (wm * S::MT + i) * 16 + gid + (e >= 2 ? 8 : 0);
        const int nn = n0 + (wnw * S::NT + j) * 8 + 2 * tig + (e & 1);
        if (mm < M && nn < N) y[(size_t)mm * N + nn] = from_f32<T>(acc[i][j][e]);
      }
    }
  }
}

template <typename T, bool PACKED, int G>
void launch(const void* x, const void* v, const float* s, const float* mins,
            void* y, int M, int K, int N, bool after, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const uint8_t* vt = static_cast<const uint8_t*>(v);
  T* yt = static_cast<T*>(y);
  if (M == 1) {
    const size_t smem = (size_t)(K + K / G + GEMV_THREADS) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(qdot_bf16_gemv_kernel<T, PACKED, G>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    dim3 block(GEMV_COLS, GEMV_WARPS);
    dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS);
    qdot_bf16_gemv_kernel<T, PACKED, G><<<grid, block, smem, stream>>>(
        xt, vt, s, mins, yt, K, N, after);
  } else if (M <= 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    qdot_bf16_mma_kernel<T, PACKED, G, 16><<<grid, TILE_THREADS, 0, stream>>>(
        xt, vt, s, mins, yt, M, K, N, after);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    qdot_bf16_mma_kernel<T, PACKED, G, 64><<<grid, TILE_THREADS, 0, stream>>>(
        xt, vt, s, mins, yt, M, K, N, after);
  }
}

template <typename T, bool PACKED>
void by_group(const void* x, const void* v, const float* s, const float* mins,
              void* y, int M, int K, int N, int group, bool after,
              cudaStream_t stream) {
  if (group == 16) launch<T, PACKED, 16>(x, v, s, mins, y, M, K, N, after, stream);
  else launch<T, PACKED, 32>(x, v, s, mins, y, M, K, N, after, stream);
}

template <typename T>
void dispatch(const void* x, const void* v, int packed, const float* s,
              const float* mins, void* y, int M, int K, int N, int group,
              bool after, cudaStream_t stream) {
  if (packed) by_group<T, true>(x, v, s, mins, y, M, K, N, group, after, stream);
  else by_group<T, false>(x, v, s, mins, y, M, K, N, group, after, stream);
}

}  // namespace

extern "C" int qdot_bf16_launch(const void* x, int x_is_bf16, const void* v,
                                int packed, const void* s, const void* mins,
                                void* y, int M, int K, int N, int group,
                                int after, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (group != 16 && group != 32) || K % group) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const float* mf = static_cast<const float*>(mins);
  if (x_is_bf16) {
    dispatch<__nv_bfloat16>(x, v, packed, sf, mf, y, M, K, N, group, after != 0, st);
  } else {
    dispatch<float>(x, v, packed, sf, mf, y, M, K, N, group, after != 0, st);
  }
  return (int)cudaGetLastError();
}
