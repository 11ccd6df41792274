// The sparse-expert feed-forward of an lfm2moe model (ops/moe.py) for
// Hopper (sm_90a): routing, the grouped gate/up product with SwiGLU, the
// grouped down product and the weighted combine, four launches an expert
// layer whatever the routing.
//
// They replace no TPU kernel: the JAX package has no expert layer.  They
// were added so that the routed FFN runs inside the batcher's CUDA graphs:
// fixed grids, the routing decided on the device, no host synchronisation
// and no per-expert launch.
//
// What bounds them on the H100: decode at 64 slots routes 256 token-expert
// pairs over 32 experts, ~8 rows an expert, so a layer step reads nearly
// every expert's Q8_0 blocks (22 layers x 32 experts x 11.01 M weights,
// 8.24 GB a step, 2.46 ms at 3.35 TB/s) and does ~30 FLOPs a byte: far below
// the tensor cores' ~295.  A prefill wave has thousands of rows, and there
// the tensor cores bound it.  The design:
//
// * moe_route_kernel, one block: each warp takes rows, picks the top-k of
//   sigmoid(r) + bias by k warp argmaxes (ties go to the lowest expert
//   index; a NaN counts as -inf), and writes the weights sigmoid(r_k) /
//   max(sum, 2^-14) * scale.  Then
//   one warp an expert lists the pairs p = row * k + j that chose it, in p
//   order (ballots), into `order` at the expert's offset (a prefix sum of
//   the counts), with `pos[p]` the pair's place in that list.  It adds the
//   pairs and the experts that have rows to the two 64-bit `counters`.
// * moe_gateup_kernel / moe_down_kernel: one block of four warps a (row
//   chunk, column tile, expert); a block whose chunk holds none of the
//   expert's rows returns at once, so an unchosen expert is never read.
//   Products on the tensor cores, mma.sync m16n8k16 bf16 -> f32: every Q8_0
//   value is exact in bf16, so a quant group's mma chain is exact up to
//   f32 rounding, and IEEE FMAs fold each group times its f16 scale into
//   the long f32 accumulator (ops/csrc/qdot_tile.cuh's scheme).  The
//   weights are held in the mma's fragment order (ops/moe.py, FRAG_K): a
//   lane's B operands of one 64-deep K chunk are 16 contiguous bytes, so a
//   warp streams its 32 weight rows with one 16-byte load a lane and row,
//   PF chunks ahead in registers, and no shared memory.  A (the
//   activations) comes through L1: the chunk's rows are few and every warp
//   of the block reads them.  MT m16 tiles of rows a block: 1 for decode (a
//   chunk of 16 rows; an expert with more takes more chunks), 4 for a
//   prefill wave (64 rows a weight read).
//   gate/up pairs gate row j with up row F + j in one warp, so silu(g) * u
//   is taken in registers and stored once in bf16 (`act`); down writes its
//   f32 sums (`y`), one row a pair.
// * moe_combine_kernel: out[row] = bf16(sum_j w[row, j] * y[pos[row, j]])
//   in j order, separate IEEE products and sums.
//
// Every kernel's result is a function of its inputs alone (no atomics but
// the counters), so a graph's replays give the same bits.  Nothing here
// allocates; the wrapper does.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MOE_MAX_EXPERTS = 64;
constexpr int MOE_MAX_TOPK = 8;
constexpr int MOE_ROUTE_THREADS = 1024;
constexpr int MOE_WARPS = 4;
constexpr int MOE_CHUNK_K = 64;   // K of one 16-byte load a lane

__device__ __forceinline__ float moe_sigmoid(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

__global__ void __launch_bounds__(MOE_ROUTE_THREADS) moe_route_kernel(
    const float* __restrict__ logits, const float* __restrict__ bias, int M,
    int E, int topk, float scale, int norm, int* ids, float* __restrict__ wts,
    int* __restrict__ offsets, int* __restrict__ order, int* __restrict__ pos,
    unsigned long long* __restrict__ counters) {
  __shared__ int s_count[MOE_MAX_EXPERTS];
  __shared__ int s_off[MOE_MAX_EXPERTS + 1];
  const int P = M * topk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  // a warp a row: lane l holds experts l and l + 32; k rounds of a warp
  // argmax, the larger value winning and the lower index on a tie
  for (int row = warp; row < M; row += warps) {
    const float* r = logits + (size_t)row * E;
    float sg[2], v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane + 32 * h;
      sg[h] = e < E ? moe_sigmoid(r[e]) : 0.f;
      v[h] = e < E ? __fadd_rn(sg[h], bias[e]) : -INFINITY;
      if (v[h] != v[h]) v[h] = -INFINITY;
    }
    bool open[2] = {lane < E, lane + 32 < E};
    float sw[MOE_MAX_TOPK];
    float sum = 0.f;
    for (int j = 0; j < topk; ++j) {
      float bv = -INFINITY;
      int be = 0x7fffffff;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (open[h] && (be == 0x7fffffff || v[h] > bv)) {
          bv = v[h];
          be = lane + 32 * h;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oe = __shfl_xor_sync(0xffffffffu, be, off);
        if (ov > bv || (ov == bv && oe < be)) {
          bv = ov;
          be = oe;
        }
      }
      if ((be & 31) == lane) open[be >> 5] = false;
      sw[j] = __shfl_sync(0xffffffffu, (be >> 5) ? sg[1] : sg[0], be & 31);
      sum = __fadd_rn(sum, sw[j]);
      if (lane == 0) ids[row * topk + j] = be;
    }
    const float denom = norm ? fmaxf(sum, 6.103515625e-5f) : 1.f;
    if (lane == 0) {
      for (int j = 0; j < topk; ++j) {
        wts[row * topk + j] = __fmul_rn(__fdiv_rn(sw[j], denom), scale);
      }
    }
  }
  __syncthreads();
  for (int e = warp; e < E; e += warps) {
    int n = 0;
    for (int base = 0; base < P; base += 32) {
      const int p = base + lane;
      n += __popc(__ballot_sync(0xffffffffu, p < P && ids[p] == e));
    }
    if (lane == 0) s_count[e] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int at = 0;
    unsigned long long used = 0;
    for (int e = 0; e < E; ++e) {
      s_off[e] = at;
      offsets[e] = at;
      at += s_count[e];
      used += s_count[e] > 0;
    }
    s_off[E] = at;
    offsets[E] = at;
    atomicAdd(counters, (unsigned long long)P);
    atomicAdd(counters + 1, used);
  }
  __syncthreads();
  for (int e = warp; e < E; e += warps) {
    int at = s_off[e];
    for (int base = 0; base < P; base += 32) {
      const int p = base + lane;
      const bool hit = p < P && ids[p] == e;
      const unsigned b = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int q = at + __popc(b & ((1u << lane) - 1u));
        order[q] = p;
        pos[p] = q;
      }
      at += __popc(b);
    }
  }
}

// bytes 2h and 2h + 1 of w (int8) as bf16x2, exactly: 0x4300 | u is the
// bf16 128 + u, and 0x4380 256, so (128 + (q & 0x7F)) - (128 + (q & 0x80))
// in one bf16x2 subtraction
__device__ __forceinline__ uint32_t moe_i8x2(uint32_t w, int h) {
  const uint32_t t = __byte_perm(w, 0u, h ? 0x4342 : 0x4140);
  const uint32_t lo = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t hi = (t & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                             *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void moe_mma(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 moe_ld_stream(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t moe_word(const uint4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// The grouped product of one expert's rows [start, end) of a chunk against
// its weight stack [N, K] (fragment order) and f16 scales [K/32, N].  A warp
// owns four n8 column tiles at weight rows nrow[0..3]; each lane ends with
// the f32 sums acc[mt][nt][c] of rows start + 16 mt + g (+ 8 for c >= 2)
// and columns nrow[nt] + 2t (+ 1 for odd c).
template <int MT, int PF>
__device__ __forceinline__ void moe_grouped(
    const __nv_bfloat16* const (&xr)[MT][2], const int8_t* wv,
    const __half* ws, const int (&nrow)[4], int K, int N,
    float (&acc)[MT][4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = K / MOE_CHUNK_K;
  const int8_t* wp[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    wp[nt] = wv + (size_t)(nrow[nt] + g) * K + 16 * t;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  uint4 wq[PF][4];
  uint32_t sq[PF][4][2];
  auto load = [&](int i, int c) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      wq[i][nt] = moe_ld_stream(wp[nt] + (size_t)c * MOE_CHUNK_K);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sq[i][nt][h] = __ldg(reinterpret_cast<const unsigned int*>(
            ws + (size_t)(2 * c + h) * N + nrow[nt] + 2 * t));
      }
    }
  };
#pragma unroll
  for (int i = 0; i < PF; ++i) {
    if (i < chunks) load(i, i);
  }
  for (int c0 = 0; c0 < chunks; c0 += PF) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int c = c0 + i;
      if (c >= chunks) break;
      uint4 w[4];
      uint32_t s[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        w[nt] = wq[i][nt];
        s[nt][0] = sq[i][nt][0];
        s[nt][1] = sq[i][nt][1];
      }
      if (c + PF < chunks) load(i, c + PF);
#pragma unroll
      for (int h = 0; h < 2; ++h) {          // the chunk's two quant groups
        float part[MT][4][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.f;
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          const int st = 2 * h + s2;
          const int kb = c * MOE_CHUNK_K + 16 * st;
          uint32_t b[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t word = moe_word(w[nt], st);
            b[nt][0] = moe_i8x2(word, 0);
            b[nt][1] = moe_i8x2(word, 1);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            a[0] = __ldg(reinterpret_cast<const unsigned int*>(xr[mt][0] + kb));
            a[1] = __ldg(reinterpret_cast<const unsigned int*>(xr[mt][1] + kb));
            a[2] = __ldg(reinterpret_cast<const unsigned int*>(xr[mt][0] + kb + 8));
            a[3] = __ldg(reinterpret_cast<const unsigned int*>(xr[mt][1] + kb + 8));
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) moe_mma(part[mt][nt], a, b[nt][0], b[nt][1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 sc = __half22float2(*reinterpret_cast<const __half2*>(&s[nt][h]));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc[mt][nt][0] = fmaf(sc.x, part[mt][nt][0], acc[mt][nt][0]);
            acc[mt][nt][1] = fmaf(sc.y, part[mt][nt][1], acc[mt][nt][1]);
            acc[mt][nt][2] = fmaf(sc.x, part[mt][nt][2], acc[mt][nt][2]);
            acc[mt][nt][3] = fmaf(sc.y, part[mt][nt][3], acc[mt][nt][3]);
          }
        }
      }
    }
  }
}

// act [P, F] (bf16) = silu(h W_gate^T) * (h W_up^T) for each pair, in the
// routed order, against the fused stack [E, 2F, K]: a block takes 64
// columns j of its expert (gate rows j, up rows F + j), 16 a warp.
template <int MT, int PF>
__global__ void __launch_bounds__(MOE_WARPS * 32) moe_gateup_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wv,
    const __half* __restrict__ ws, const int* __restrict__ offsets,
    const int* __restrict__ order, __nv_bfloat16* __restrict__ act, int K,
    int F, int topk, int chunks) {
  const int tiles = F / 64;
  const int chunk = blockIdx.x % chunks;
  const int tile = (blockIdx.x / chunks) % tiles;
  const int e = blockIdx.x / (chunks * tiles);
  const int start = offsets[e] + chunk * 16 * MT;
  const int end = min(offsets[e + 1], start + 16 * MT);
  if (start >= end) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = 2 * F;
  const int j0 = tile * 64 + warp * 16;
  const int nrow[4] = {j0, j0 + 8, F + j0, F + j0 + 8};
  const __nv_bfloat16* xr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(start + 16 * mt + g + 8 * h, end - 1);
      xr[mt][h] = x + (size_t)(order[r] / topk) * K + 2 * t;
    }
  float acc[MT][4][4];
  moe_grouped<MT, PF>(xr, wv + (size_t)e * N * K,
                      ws + (size_t)e * (K / 32) * N, nrow, K, N, acc);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = start + 16 * mt + g + 8 * h;
      if (r >= end) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float gate = acc[mt][nt][2 * h + q];
          const float silu = __fdiv_rn(gate, __fadd_rn(1.f, expf(-gate)));
          v[q] = __fmul_rn(silu, acc[mt][nt + 2][2 * h + q]);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            act + (size_t)r * F + nrow[nt] + 2 * t) = __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

// y [P, N] (f32) = act W_down^T for each pair, in the routed order, against
// the stack [E, N, K]: a block takes 128 columns of its expert, 32 a warp.
template <int MT, int PF>
__global__ void __launch_bounds__(MOE_WARPS * 32) moe_down_kernel(
    const __nv_bfloat16* __restrict__ act, const int8_t* __restrict__ wv,
    const __half* __restrict__ ws, const int* __restrict__ offsets,
    float* __restrict__ y, int K, int N, int chunks) {
  const int tiles = N / 128;
  const int chunk = blockIdx.x % chunks;
  const int tile = (blockIdx.x / chunks) % tiles;
  const int e = blockIdx.x / (chunks * tiles);
  const int start = offsets[e] + chunk * 16 * MT;
  const int end = min(offsets[e + 1], start + 16 * MT);
  if (start >= end) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = tile * 128 + warp * 32;
  const int nrow[4] = {n0, n0 + 8, n0 + 16, n0 + 24};
  const __nv_bfloat16* xr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(start + 16 * mt + g + 8 * h, end - 1);
      xr[mt][h] = act + (size_t)r * K + 2 * t;
    }
  float acc[MT][4][4];
  moe_grouped<MT, PF>(xr, wv + (size_t)e * N * K,
                      ws + (size_t)e * (K / 32) * N, nrow, K, N, acc);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = start + 16 * mt + g + 8 * h;
      if (r >= end) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        *reinterpret_cast<float2*>(y + (size_t)r * N + nrow[nt] + 2 * t) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

// out [M, N] = bf16(sum_j w[row * k + j] * y[pos[row * k + j]]), j in order
__global__ void __launch_bounds__(256) moe_combine_kernel(
    const float* __restrict__ y, const float* __restrict__ wts,
    const int* __restrict__ pos, __nv_bfloat16* __restrict__ out, int N,
    int topk) {
  const int row = blockIdx.x;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < topk; ++j) {
      const int p = row * topk + j;
      acc = __fadd_rn(acc, __fmul_rn(wts[p], y[(size_t)pos[p] * N + n]));
    }
    out[(size_t)row * N + n] = __float2bfloat16_rn(acc);
  }
}

extern "C" int moe_route_launch(const void* logits, const void* bias, int M,
                                int E, int topk, float scale, int norm,
                                void* ids, void* wts, void* offsets,
                                void* order, void* pos, void* counters,
                                void* stream) {
  if (E > MOE_MAX_EXPERTS || topk > MOE_MAX_TOPK || topk > E) {
    return (int)cudaErrorInvalidValue;
  }
  moe_route_kernel<<<1, MOE_ROUTE_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(logits), static_cast<const float*>(bias), M,
      E, topk, scale, norm, static_cast<int*>(ids), static_cast<float*>(wts),
      static_cast<int*>(offsets), static_cast<int*>(order),
      static_cast<int*>(pos), static_cast<unsigned long long*>(counters));
  return (int)cudaGetLastError();
}

// the blocks of a grouped launch: every (row chunk, column tile, expert),
// an expert having at most M rows (a row chooses an expert once)
static unsigned moe_blocks(int M, int mt, int tiles, int E, int* chunks) {
  *chunks = (M + 16 * mt - 1) / (16 * mt);
  return (unsigned)(*chunks) * tiles * E;
}

extern "C" int moe_gateup_launch(const void* x, const void* wv, const void* ws,
                                 const void* offsets, const void* order,
                                 void* act, int M, int K, int F, int E,
                                 int topk, int mt, void* stream) {
  if (K % MOE_CHUNK_K || F % 64) return (int)cudaErrorInvalidValue;
  int chunks = 0;
  const unsigned blocks = moe_blocks(M, mt, F / 64, E, &chunks);
  auto s = (cudaStream_t)stream;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto v = static_cast<const int8_t*>(wv);
  auto sc = static_cast<const __half*>(ws);
  auto off = static_cast<const int*>(offsets);
  auto ord = static_cast<const int*>(order);
  auto out = static_cast<__nv_bfloat16*>(act);
  if (mt == 1) {
    moe_gateup_kernel<1, 4><<<blocks, MOE_WARPS * 32, 0, s>>>(
        xb, v, sc, off, ord, out, K, F, topk, chunks);
  } else if (mt == 4) {
    moe_gateup_kernel<4, 2><<<blocks, MOE_WARPS * 32, 0, s>>>(
        xb, v, sc, off, ord, out, K, F, topk, chunks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int moe_down_launch(const void* act, const void* wv, const void* ws,
                               const void* offsets, void* y, int M, int K,
                               int N, int E, int mt, void* stream) {
  if (K % MOE_CHUNK_K || N % 128) return (int)cudaErrorInvalidValue;
  int chunks = 0;
  const unsigned blocks = moe_blocks(M, mt, N / 128, E, &chunks);
  auto s = (cudaStream_t)stream;
  auto a = static_cast<const __nv_bfloat16*>(act);
  auto v = static_cast<const int8_t*>(wv);
  auto sc = static_cast<const __half*>(ws);
  auto off = static_cast<const int*>(offsets);
  auto out = static_cast<float*>(y);
  if (mt == 1) {
    moe_down_kernel<1, 4><<<blocks, MOE_WARPS * 32, 0, s>>>(
        a, v, sc, off, out, K, N, chunks);
  } else if (mt == 4) {
    moe_down_kernel<4, 2><<<blocks, MOE_WARPS * 32, 0, s>>>(
        a, v, sc, off, out, K, N, chunks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int moe_combine_launch(const void* y, const void* wts,
                                  const void* pos, void* out, int M, int N,
                                  int topk, void* stream) {
  moe_combine_kernel<<<M, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(y), static_cast<const float*>(wts),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), N,
      topk);
  return (int)cudaGetLastError();
}
