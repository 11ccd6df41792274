// The M > 1 tile shared by K1 (qdot.cu) and K1v (qdot_bf16.cu), for Hopper
// (sm_90a).  It replaces the M > 1 bodies of
// miotts_tpu/ops/qmat.py:_qdot_kernel (bf16_dot=False and True / "after"):
// every prefill, the batched decode steps (16 and 64 slots), the m8 route.
//
//   K1   y[m, n] = sum_b ( s[b, n] * P[m, b, n] - mins[b, n] * X[m, b] )
//   K1v  y[m, n] = sum_b ( Q[m, b, n] - mins[b, n] * X[m, b] )
//
// P[m, b, n] = sum over quant group b of x[m, k] * v[k, n] (the raw stored
// integers), Q the same with w = bf16(v * s') in place of v and bf16(x) in
// place of x, X[m, b] the f32 sum of the unrounded x over group b.
//
// What bounds it on the H100: the bytes of v + s + mins over the 3.35 TB/s
// of HBM at M = 16 (a whole LFM2 16-slot step is 1.2 GB, 0.36 ms); at M = 64
// on the 2.6B widths the bf16 tensor-core rate comes within 2x of that.
// What bounds this design is latency: a block spends ~1 us a stage on
// dependent shared loads, integer conversions and mma, so a narrow linear
// needs many blocks (the split-K below) to keep enough bytes in flight.
// The design:
//
// * Products on the tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32.  K1
//   keeps its f32 semantics because every stored value (Q8_0 -127..127, Q6_K
//   -32..31, nibbles 0..15) is exact in bf16 and a bf16 x times it is exact
//   in f32; an f32 x is split into three bf16 parts x = x0 + x1 + x2
//   (exact), three mma per product.  Each quant group's mma chain starts
//   from zero and IEEE f32 FMAs fold it into the long accumulator: the
//   tensor cores' own f32 sums truncate, and chained over K = 8192 they
//   drifted 1e-5 of the output scale.
// * Bytes in flight: a 4-stage cp.async ring of 64-deep K steps holds the
//   raw quantized bytes, the scales and mins, and the x tile; the weights are
//   converted to bf16 fragments from shared memory in registers (byte
//   permutes and one bf16x2 subtraction, not the conversion unit), so the
//   quantized bytes, not bf16 or f32 copies, stream from HBM.  v's rows are
//   N bytes apart and N may be odd (the output head's 13059): each row is
//   copied as the 16-byte chunks that cover it and read back with a funnel
//   shift by its own offset; f32 scales and mins (4-byte aligned) go by
//   4-byte copies straight to their column.  bf16 scales and mins (the
//   S = __nv_bfloat16 instantiation, MIOTTS_SCALE_BF16) halve those bytes:
//   cp.async moves 4, 8 or 16 bytes and a row of an odd N starts anywhere in
//   a 16-byte piece, so, as v's rows, each row is copied as the 16 or 17
//   aligned 16-byte pieces that cover its 128 columns (8 a copy; s and mins
//   16-byte aligned), read back at its own offset (0..7 elements) and upcast
//   exactly in registers; the bytes past the row's last column are
//   zero-filled, as the f32 copies are.  The staged row is 136 elements, in
//   shared memory only.
// * A tile of BM x 128 outputs: BM = 16 (4 warps) or 64 (8 warps; the plan
//   takes it for M > 16 on the larger weights).  A warp owns 32 columns; in
//   its four n8 mma tiles, lane group g stands for columns 4g..4g+3, so one
//   32-bit shared load gives a lane its byte of four tiles, and each lane's
//   outputs are 8 neighbouring columns.
// * A deterministic split-K in the same launch: blockIdx.z splits K (the
//   plan is ops/qmat.py:_tile_plan).  Each split stores its f32 partial
//   tile to a workspace; the last block to take a ticket of its tile (an
//   int32 counter per tile, zeroed once by the wrapper and reset by that
//   block) sums the partials in split order and rounds y once to x's type.
//   The result does not depend on the blocks' order.  The counters assume
//   one stream at a time per device, as the port runs.
//
// Ragged M, N and K load zeros (cp.async with a source size of 0) and are
// not stored.  The kernel allocates nothing.
//
// The f32 fold and the order of its sums do not depend on S: a bf16 scale
// is the f32 value it stands for, so both instantiations give the plain
// version's function of the same (upcast) scales.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qtile {

constexpr int BK = 64;           // K depth of one stage
constexpr int BN = 128;          // output columns of a tile (ops/qmat.py:TILE_BN)
constexpr int STAGES = 4;        // the cp.async ring
constexpr int MAX_GS = BK / 16;  // quant groups of a stage at most

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

// y[i] = v: in T, rounded once from the f32 sum, or the f32 sum itself
// where y_f32 (a row-parallel shard's partial: the ranks' partials are
// summed before the one rounding)
template <typename T>
__device__ __forceinline__ void store_y(void* y, size_t i, float v, bool y_f32) {
  if (y_f32) {
    static_cast<float*>(y)[i] = v;
  } else {
    static_cast<T*>(y)[i] = from_f32<T>(v);
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a warp owns 32 columns and MT m16 tiles
template <int BM> struct Shape {
  static constexpr int WARPS_M = BM >= 32 ? BM / 32 : 1;
  static constexpr int WARPS_N = BN / 32;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MT = BM / 16 / WARPS_M;    // m16 mma tiles per warp
  static constexpr int WROW = BN + 16;   // bytes of a staged weight row
};

// elements of a staged row of scales (or mins): f32 one a column; bf16 the
// 17 pieces of 8 that cover 128 columns at an offset of 0..7
template <typename S> struct ScaleRow { static constexpr int N = BN; };
template <> struct ScaleRow<__nv_bfloat16> { static constexpr int N = BN + 8; };

template <typename T, bool PACKED, int G, int BM, typename S> struct Stage {
  static constexpr int XSTRIDE = BK + 16 / (int)sizeof(T);   // elements
  static constexpr int X_BYTES = BM * XSTRIDE * (int)sizeof(T);
  static constexpr int WROWS = PACKED ? BK / 2 : BK;
  static constexpr int W_BYTES = WROWS * Shape<BM>::WROW;
  static constexpr int GS = BK / G;
  static constexpr int SROW = ScaleRow<S>::N;
  static constexpr int S_BYTES = GS * SROW * (int)sizeof(S);
  static constexpr int BYTES = X_BYTES + W_BYTES + 2 * S_BYTES;
  static constexpr int SMEM = STAGES * BYTES;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// piece p of the aligned 16-byte pieces that cover the bf16 elements
// [e0, e0 + cols) of `a` (16-byte aligned) into dst: the bytes of elements
// from e0 + cols on are zero-filled (cp.async's source size), so are whole
// pieces past them
__device__ __forceinline__ void cp_async_piece(void* dst, const __nv_bfloat16* a,
                                               size_t e0, int cols, int p) {
  const uintptr_t at = (reinterpret_cast<uintptr_t>(a + e0) & ~(uintptr_t)15) + 16 * p;
  const uintptr_t end = reinterpret_cast<uintptr_t>(a + e0 + cols);
  const int bytes = at < end ? (end - at < 16 ? (int)(end - at) : 16) : 0;
  cp_async16(dst, bytes ? reinterpret_cast<const void*>(at) : a, bytes);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte j of w as a signed int8, exactly, as f32: 2^23 + (q + 128) built by
// a byte permute, minus 2^23 + 128
__device__ __forceinline__ float i8_f32(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 | j))
         - 8388736.f;
}

// nibble (low if hi == 0) of byte j of w, exactly, as f32
__device__ __forceinline__ float nib_f32(uint32_t w, int j, int hi) {
  return __uint_as_float(0x4B000000u | ((w >> (8 * j + 4 * hi)) & 0xFu)) - 8388608.f;
}

// bf16x2 {q(wa, j), q(wb, j)} of two int8 bytes, exactly: q = (q & 0x7F) -
// 128 * sign, and 0x4300 | u is the bf16 128 + u, so (128 + (q & 0x7F)) -
// (128 + 128 * sign) in one bf16x2 subtraction (both operands and the
// result are integers of at most 8 significant bits)
__device__ __forceinline__ uint32_t pair_i8(uint32_t wa, uint32_t wb, int j) {
  const uint32_t t = __byte_perm(wa, wb, j | ((4 + j) << 8));
  const uint32_t lo = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t hi = (t & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                             *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<uint32_t*>(&r);
}

// bf16x2 of the low (hi == 0) or high nibbles of byte j of wa and wb:
// 0x4300 | u is the bf16 128 + u, and one bf16x2 subtraction leaves u
__device__ __forceinline__ uint32_t pair_nib(uint32_t wa, uint32_t wb, int j, int hi) {
  const uint32_t t = __byte_perm(wa, wb, j | ((4 + j) << 8)) >> (4 * hi);
  const uint32_t biased = (t & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                             __float2bfloat162_rn(128.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&r);
}

// The A fragments of one m16 x k16 block of the staged x: P bf16 parts
// (P = 1: bf16(x); P = 3: x = x0 + x1 + x2, exact, for K1's f32 x)
template <typename T, int P> struct AFrag;

template <int P> struct AFrag<__nv_bfloat16, P> {
  uint32_t a[1][4];
  // one ldmatrix.x4: lanes 0-7 / 8-15 / 16-23 / 24-31 give the rows of
  // (rows 0-7, k 0-7) / (8-15, 0-7) / (0-7, 8-15) / (8-15, 8-15)
  __device__ __forceinline__ void load(const __nv_bfloat16* xs, int stride, int r0,
                                       int kk, int lane) {
    const __nv_bfloat16* p =
        xs + (r0 + (lane & 15)) * stride + kk + (lane >> 4) * 8;
    const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[0][0]), "=r"(a[0][1]), "=r"(a[0][2]), "=r"(a[0][3])
                 : "r"(addr));
  }
  static constexpr int PARTS = 1;
};

template <int P> struct AFrag<float, P> {
  uint32_t a[P][4];
  __device__ __forceinline__ void load(const float* xs, int stride, int r0, int kk,
                                       int lane) {
    const float* p = xs + (r0 + lane / 4) * stride + kk + 2 * (lane % 4);
    const float2 f[4] = {*reinterpret_cast<const float2*>(p),
                         *reinterpret_cast<const float2*>(p + 8 * stride),
                         *reinterpret_cast<const float2*>(p + 8),
                         *reinterpret_cast<const float2*>(p + 8 * stride + 8)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float lo = f[i].x, hi = f[i].y;
      // parts in decreasing size: part 0 is bf16(x), the next the rounding
      // of what is left; the last is stored first so that the mma chain
      // adds the small parts first
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float l0 = bf16_round(lo), h0 = bf16_round(hi);
        a[P - 1 - q][i] = pack_bf16(l0, h0);
        lo -= l0;
        hi -= h0;
      }
    }
  }
  static constexpr int PARTS = P;
};

// NV (4 or 8) staged scales or mins of a row from column c (even), as f32:
// an f32 row by float4 loads; a bf16 row from the words that hold its
// elements o + c .. o + c + NV - 1 (o: the row's first column in its first
// piece, 0..7), funnel-shifted by an odd o's half word and upcast exactly
template <int NV>
__device__ __forceinline__ void staged(const float* row, int, int c, float (&out)[NV]) {
#pragma unroll
  for (int i = 0; i < NV / 4; ++i) {
    const float4 f = *reinterpret_cast<const float4*>(row + c + 4 * i);
    out[4 * i] = f.x; out[4 * i + 1] = f.y; out[4 * i + 2] = f.z; out[4 * i + 3] = f.w;
  }
}

template <int NV>
__device__ __forceinline__ void staged(const __nv_bfloat16* row, int o, int c,
                                       float (&out)[NV]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (o & ~1) + c);
  uint32_t u[NV / 2 + 1];
#pragma unroll
  for (int i = 0; i <= NV / 2; ++i) u[i] = w[i];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    const uint32_t p = __funnelshift_r(u[i], u[i + 1], 16 * (o & 1));
    out[2 * i] = __uint_as_float(p << 16);
    out[2 * i + 1] = __uint_as_float(p & 0xFFFF0000u);
  }
}

// One staged weight word: columns c..c+3 of byte row lr of the stage, read
// from the row's 16-byte chunks at its own offset o
template <int WROW>
__device__ __forceinline__ uint32_t weight_word(const unsigned char* wt, int lr,
                                                unsigned o, int c) {
  const unsigned p = o + c;
  const unsigned char* row = wt + lr * WROW + (p & ~3u);
  const uint32_t lo = *reinterpret_cast<const uint32_t*>(row);
  const uint32_t hi = *reinterpret_cast<const uint32_t*>(row + 4);
  return __funnelshift_r(lo, hi, 8 * (p & 3u));
}

// SCALED = false: K1 (raw integers, f32 fold of s and mins per group)
// SCALED = true:  K1v (w = bf16(v * s'), s' = s in mode after, bf16(s) in
//                 mode 1; x rounded to bf16; mins folded per group)
// S: the type of s and mins, float (4-byte aligned) or bf16 (16-byte)
template <typename T, bool PACKED, int G, int BM, bool SCALED, typename S>
__global__ void __launch_bounds__(Shape<BM>::THREADS)
qdot_tile_kernel(const T* __restrict__ x, const uint8_t* __restrict__ v,
                 const S* __restrict__ s, const S* __restrict__ mins,
                 void* __restrict__ y, bool y_f32, float* __restrict__ ws,
                 int* __restrict__ tickets, int M, int K, int N, int k_split,
                 bool after) {
  using SH = Shape<BM>;
  using ST = Stage<T, PACKED, G, BM, S>;
  constexpr int THREADS = SH::THREADS, MT = SH::MT, GS = ST::GS;
  constexpr int SROW = ST::SROW;
  constexpr int WROW = SH::WROW;
  constexpr int XS = ST::XSTRIDE;
  constexpr int PARTS = (!SCALED && sizeof(T) == 4) ? 3 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float xsum[BM][MAX_GS];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / SH::WARPS_N, wn = warp % SH::WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  const int n_steps = (min(K, kb + k_split) - kb + BK - 1) / BK;
  const bool has_mins = mins != nullptr;
  const int n_groups = K / G;
  const int rows_total = PACKED ? K / 2 : K;
  const uintptr_t v_end = reinterpret_cast<uintptr_t>(v) + (size_t)rows_total * N;
  const unsigned v_lo = static_cast<unsigned>(reinterpret_cast<uintptr_t>(v)) + n0;

  auto x_tile = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * ST::BYTES);
  };
  auto w_tile = [&](int slot) { return smem + slot * ST::BYTES + ST::X_BYTES; };
  auto s_tile = [&](int slot) {
    return reinterpret_cast<S*>(smem + slot * ST::BYTES + ST::X_BYTES + ST::W_BYTES);
  };
  auto m_tile = [&](int slot) { return s_tile(slot) + GS * SROW; };

  // one stage's copies: x [BM][BK], the weight rows' chunks, s and mins
  auto load = [&](int step, int slot) {
    const int k0 = kb + step * BK;
    T* xt = x_tile(slot);
    constexpr int EPC = 16 / sizeof(T), XCH = BK / EPC;
#pragma unroll
    for (int i = tid; i < BM * XCH; i += THREADS) {
      const int r = i / XCH, c = i % XCH;
      const int m = m0 + r, k = k0 + c * EPC;
      const bool ok = m < M && k < K;
      cp_async16(xt + r * XS + c * EPC, ok ? x + (size_t)m * K + k : x, ok ? 16 : 0);
    }
    unsigned char* wt = w_tile(slot);
    constexpr int WCH = WROW / 16;
    const int row0 = PACKED ? k0 / 2 : k0;
#pragma unroll
    for (int i = tid; i < ST::WROWS * WCH; i += THREADS) {
      const int r = i / WCH, c = i % WCH, row = row0 + r;
      const uintptr_t a = reinterpret_cast<uintptr_t>(v) + (size_t)row * N + n0;
      const uintptr_t src = (a & ~(uintptr_t)15) + 16 * c;
      const uintptr_t left = src < v_end ? v_end - src : 0;
      const int bytes = row < rows_total ? (left < 16 ? (int)left : 16) : 0;
      cp_async16(wt + r * WROW + 16 * c,
                 bytes ? reinterpret_cast<const void*>(src) : v, bytes);
    }
    S* st = s_tile(slot);
    S* mt = m_tile(slot);
    const int b0 = k0 / G;
    if constexpr (sizeof(S) == 4) {
#pragma unroll
      for (int i = tid; i < GS * BN; i += THREADS) {
        const int gi = i / BN, c = i % BN, b = b0 + gi, n = n0 + c;
        const bool ok = b < n_groups && n < N;
        const size_t off = ok ? (size_t)b * N + n : 0;
        cp_async4(st + i, s + off, ok ? 4 : 0);
        if (has_mins) cp_async4(mt + i, mins + off, ok ? 4 : 0);
      }
    } else {
      // a group's row: its BN columns as the 16-byte pieces that cover them
      constexpr int PIECES = SROW / 8;
      const int cols = min(BN, N - n0);
#pragma unroll
      for (int i = tid; i < GS * PIECES; i += THREADS) {
        const int gi = i / PIECES, p = i % PIECES, b = b0 + gi;
        const size_t e0 = (size_t)(b < n_groups ? b : 0) * N + n0;
        const int live = b < n_groups ? cols : 0;
        cp_async_piece(st + gi * SROW + 8 * p, s, e0, live, p);
        if (has_mins) cp_async_piece(mt + gi * SROW + 8 * p, mins, e0, live, p);
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_steps) load(st, st);
    cp_commit();
  }
  const int col = 32 * wn + 4 * gid;   // the lane's columns in its B fragments
  for (int step = 0; step < n_steps; ++step) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (step + STAGES - 1 < n_steps) load(step + STAGES - 1, (step + STAGES - 1) % STAGES);
    cp_commit();
    const int slot = step % STAGES;
    const T* xt = x_tile(slot);
    const unsigned char* wt = w_tile(slot);
    const S* st = s_tile(slot);
    const S* mt = m_tile(slot);
    if (has_mins) {
      // X[m, b]: f32 sums of the unrounded x over the stage's groups
      for (int i = tid; i < BM * GS; i += THREADS) {
        const int r = i / GS, gi = i % GS;
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < G; ++e) t += to_f32(xt[r * XS + gi * G + e]);
        xsum[r][gi] = t;
      }
      __syncthreads();
    }
    const int row0 = PACKED ? (kb + step * BK) / 2 : kb + step * BK;

#pragma unroll
    for (int gi = 0; gi < GS; ++gi) {
      // the staged rows of group gi, and (bf16) the offset of their first
      // column in its first piece
      const S* srow = st + gi * SROW;
      const S* mrow = mt + gi * SROW;
      const int so = (int)(((unsigned)((kb + step * BK) / G + gi) * (unsigned)N
                            + (unsigned)n0) & 7u);
      float part[MT][4][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      float sp[4];
      if (SCALED) {
        float sv[4];
        staged<4>(srow, so, col, sv);
#pragma unroll
        for (int j = 0; j < 4; ++j) sp[j] = after ? sv[j] : bf16_round(sv[j]);
      }
#pragma unroll
      for (int ks = 0; ks < G / 16; ++ks) {
        // the B fragments of the four n8 tiles: b0 holds k = 2 tig, 2 tig + 1
        // and b1 k = 2 tig + 8, 2 tig + 9 of the k16 block, at column
        // col + j of tile j
        uint32_t bf[4][2];
        if (PACKED) {
          // byte row r of a group holds k = r (low nibble) and g/2 + r (high)
          constexpr int H = G / 2;
          const int base = gi * H;
          const int lr[4] = {base + 2 * tig, base + 2 * tig + 1,
                             base + 2 * tig + 8, base + 2 * tig + 9};
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int q = 0; q < (G == 32 ? 4 : 2); ++q)
            w[q] = weight_word<WROW>(wt, lr[q], (v_lo + (unsigned)(row0 + lr[q]) * (unsigned)N) & 15u, col);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // G = 32: k16 block ks is nibble ks of rows 0..15;
            // G = 16: the block is the whole group, b1 its high nibbles
            const int h0 = G == 32 ? ks : 0, h1 = G == 32 ? ks : 1;
            const uint32_t wa1 = G == 32 ? w[2] : w[0], wb1 = G == 32 ? w[3] : w[1];
            if (SCALED) {
              bf[j][0] = pack_bf16(__fmul_rn(nib_f32(w[0], j, h0), sp[j]),
                                   __fmul_rn(nib_f32(w[1], j, h0), sp[j]));
              bf[j][1] = pack_bf16(__fmul_rn(nib_f32(wa1, j, h1), sp[j]),
                                   __fmul_rn(nib_f32(wb1, j, h1), sp[j]));
            } else {
              bf[j][0] = pair_nib(w[0], w[1], j, h0);
              bf[j][1] = pair_nib(wa1, wb1, j, h1);
            }
          }
        } else {
          const int base = gi * G + ks * 16;
          const int lr[4] = {base + 2 * tig, base + 2 * tig + 1,
                             base + 2 * tig + 8, base + 2 * tig + 9};
          uint32_t w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            w[q] = weight_word<WROW>(wt, lr[q], (v_lo + (unsigned)(row0 + lr[q]) * (unsigned)N) & 15u, col);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (SCALED) {
              bf[j][0] = pack_bf16(__fmul_rn(i8_f32(w[0], j), sp[j]),
                                   __fmul_rn(i8_f32(w[1], j), sp[j]));
              bf[j][1] = pack_bf16(__fmul_rn(i8_f32(w[2], j), sp[j]),
                                   __fmul_rn(i8_f32(w[3], j), sp[j]));
            } else {
              bf[j][0] = pair_i8(w[0], w[1], j);
              bf[j][1] = pair_i8(w[2], w[3], j);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          AFrag<T, PARTS> af;
          af.load(xt, XS, (wm * MT + i) * 16, gi * G + ks * 16, lane);
#pragma unroll
          for (int q = 0; q < AFrag<T, PARTS>::PARTS; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(part[i][j], af.a[q], bf[j][0], bf[j][1]);
        }
      }
      // the fold, IEEE f32: the lane's outputs are columns 32 wn + 8 tig +
      // 0..7 (c0 / c2 of tile j at + j, c1 / c3 at + 4 + j)
      const int oc = 32 * wn + 8 * tig;
      float sv[8], mv[8];
      if (!SCALED) staged<8>(srow, so, oc, sv);
      if (has_mins) staged<8>(mrow, so, oc, mv);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = (wm * MT + i) * 16 + gid;
        const float xg[2] = {has_mins ? xsum[r][gi] : 0.f,
                             has_mins ? xsum[r + 8][gi] : 0.f};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = (e & 1) * 4 + j;
            float a = acc[i][j][e];
            a = SCALED ? a + part[i][j][e] : fmaf(sv[c], part[i][j][e], a);
            if (has_mins) a = fmaf(-mv[c], xg[e >> 1], a);
            acc[i][j][e] = a;
          }
      }
    }
  }
  cp_wait<0>();

  // c0 / c1: row gid, c2 / c3: row gid + 8
  const int splits = gridDim.z;
  const int nb = n0 + 32 * wn + 8 * tig;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + (wm * MT + i) * 16 + gid + (e >> 1) * 8;
          const int n = nb + (e & 1) * 4 + j;
          if (m < M && n < N) store_y<T>(y, (size_t)m * N + n, acc[i][j][e], y_f32);
        }
    return;
  }
  // split-K: this split's partial tile, whole, into its slot of the
  // workspace [splits][tiles][BM][BN] (two float4 per lane and row: its 8
  // neighbouring columns)
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t tile_elems = (size_t)BM * BN;
  float* mine = ws + ((size_t)blockIdx.z * gridDim.x * gridDim.y + tile) * tile_elems;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = mine + ((wm * MT + i) * 16 + gid + 8 * h) * BN + 32 * wn + 8 * tig;
      *reinterpret_cast<float4*>(row) = make_float4(
          acc[i][0][2 * h], acc[i][1][2 * h], acc[i][2][2 * h], acc[i][3][2 * h]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(acc[i][0][2 * h + 1], acc[i][1][2 * h + 1],
                      acc[i][2][2 * h + 1], acc[i][3][2 * h + 1]);
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(tickets + tile, 1);
    is_last = prev == splits - 1;
    if (is_last) tickets[tile] = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block sums the splits of its tile in split order: each thread
  // owns PER float4 of the tile, and the loads of a few splits are in
  // flight together
  constexpr int PER = BM * BN / 4 / THREADS;
  float4 t[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) t[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* parts = reinterpret_cast<const float4*>(ws) + tile * (tile_elems / 4);
  const size_t split_stride = (size_t)gridDim.x * gridDim.y * (tile_elems / 4);
#pragma unroll 4
  for (int z = 0; z < splits; ++z) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const float4 p = __ldcg(parts + z * split_stride + tid + q * THREADS);
      t[q].x += p.x;
      t[q].y += p.y;
      t[q].z += p.z;
      t[q].w += p.w;
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e4 = (tid + q * THREADS) * 4;
    const int m = m0 + e4 / BN, n = n0 + e4 % BN;
    if (m >= M) continue;
    const float v4[4] = {t[q].x, t[q].y, t[q].z, t[q].w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n + u < N) store_y<T>(y, (size_t)m * N + n + u, v4[u], y_f32);
  }
}

// Launch one tile configuration; returns cudaGetLastError().  bm is 16 or
// 64 (rows of a tile, at any M); k_split a multiple of BK with splits *
// k_split covering K; ws (f32 [splits][tiles][bm][BN]) and tickets (one per
// tile, zero) are needed when splits > 1.  `static`: each shared library
// that includes this header configures its own kernels (the local static of
// a function template with external linkage is one object in the whole
// process, STB_GNU_UNIQUE, so a second library would skip the attribute).
template <typename T, bool PACKED, int G, int BM, bool SCALED, typename S>
static cudaError_t launch_tile(const T* x, const uint8_t* v, const S* s,
                        const S* mins, void* y, bool y_f32, float* ws,
                        int* tickets, int M, int K, int N, int splits,
                        int k_split, bool after, cudaStream_t stream) {
  auto kern = qdot_tile_kernel<T, PACKED, G, BM, SCALED, S>;
  constexpr int smem = Stage<T, PACKED, G, BM, S>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, Shape<BM>::THREADS, smem, stream>>>(x, v, s, mins, y, y_f32, ws,
                                                   tickets, M, K, N, k_split, after);
  return cudaGetLastError();
}

// the checks of a tile plan that the kernel relies on
inline bool plan_ok(int M, int K, int N, int bm, int splits, int k_split,
                    const void* ws, const void* tickets) {
  if ((bm != 16 && bm != 64) || splits < 1 || k_split < BK || k_split % BK) {
    return false;
  }
  if ((long long)splits * k_split < K || (long long)(splits - 1) * k_split >= K) {
    return false;
  }
  return splits == 1 || (ws != nullptr && tickets != nullptr);
}

// The tile of x (T) against scales and mins of type S (float, 4-byte
// aligned, or bf16, 16-byte aligned: a staged bf16 row starts at the piece
// that holds its first column, never before the tensor); y in T, or f32
// where y_f32
template <typename T, typename S, bool PACKED, int G, bool SCALED>
cudaError_t tile_by_bm(const void* x, const void* v, const void* s,
                       const void* mins, void* y, bool y_f32, float* ws,
                       int* tickets, int M, int K, int N, int bm, int splits,
                       int k_split, bool after, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(mins))
      % (sizeof(S) == 2 ? 16 : 4)) {
    return cudaErrorInvalidValue;
  }
  const T* xt = static_cast<const T*>(x);
  const uint8_t* vt = static_cast<const uint8_t*>(v);
  const S* st = static_cast<const S*>(s);
  const S* mt = static_cast<const S*>(mins);
  if (bm == 16) {
    return launch_tile<T, PACKED, G, 16, SCALED, S>(xt, vt, st, mt, y, y_f32, ws,
                                                    tickets, M, K, N, splits, k_split,
                                                    after, stream);
  }
  return launch_tile<T, PACKED, G, 64, SCALED, S>(xt, vt, st, mt, y, y_f32, ws, tickets,
                                                  M, K, N, splits, k_split, after,
                                                  stream);
}

}  // namespace qtile
