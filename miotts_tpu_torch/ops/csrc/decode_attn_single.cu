// Single-query flash-decode attention in f32 for Hopper (sm_90a).
//
// Replaces miotts_tpu/ops/decode_attn.py:_kernel (reached through
// decode_attention), the attention of the LFM2 hybrid decode: every
// attention layer writes the step's k / v into the cache first and then
// reads each valid key of the row through this kernel.
//
// Contract (the JAX one):
//   q       [B, H, D]            f32 (the wrapper upcasts a bf16 q, as the
//                                TPU kernel upcasts its block)
//   k, v    [B, H_kv, S, D]      bf16 / f32 / int8, any batch / head / row
//                                strides (a layer of the stacked [L, B,
//                                H_kv, S, D] cache), the last dim
//                                contiguous, rows 16-byte aligned
//   k_scale, v_scale [B, H_kv, S] f32 (int8 only), any batch / head
//                                strides, the last dim contiguous
//   fill, q_pos [B] int32: key s is valid iff s < min(fill[b], q_pos[b] + 1)
//   out     [B, H, D] f32 = acc / max(l, 1e-20); a row with no valid key
//           returns 0
//
// Arithmetic: everything in f32.  Keys and values are upcast from the
// cache's type and an int8 row is dequantized by its scale: the score is
// (q . k_i8) * k_scale * scale, the value weight p * v_scale.  There is no
// query or probability quantization (that is K6, decode_attn.cu) and p is
// NOT rounded before the PV product, so nothing depends on the tile size.
// Masked scores are -1e9.
//
// Design.  One block per (b, kv-head g): B * H_kv blocks of 256 threads;
// the rep = H / H_kv query rows of the group share every k / v row read.
// The TPU grid's sequential S axis (the flash state carried in VMEM
// scratch across grid steps) becomes a loop over 512-key tiles inside the
// block, with the rows' running (m, l) and [rep, D] accumulator in shared
// memory.  Per tile:
//   1. scores: one thread per key reads its k row with 16-byte loads (the
//      q rows are broadcast from shared memory) and writes rep scores into
//      a shared [rep, 512] tile;
//   2. softmax update: warp r owns query row r (rep <= 8 warps): tile max,
//      m_new, p = exp(s - m_new) (times v_scale for int8), l;
//   3. PV: thread (key group, d) sums p * v over a strided share of the
//      tile's keys for all rep rows (neighbouring threads read neighbouring
//      d of a v row); the key groups are reduced in shared memory and the
//      accumulator is rescaled by exp(m_prev - m_new) and updated.
// Tiles past the row's limit are never read (the TPU kernel skips them
// too), so a row with fill 0 reads nothing and writes 0.
//
// What bounds it: the bytes of every valid key's k and v row (plus its
// scales), q and the output; the 4 * rep * D f32 flops per key are far
// below the card's f32 rate.  At the LFM2-1.2B decode shape (B = 1,
// H = 32 / 8, D = 64, ~200 valid keys, bf16) that is ~0.2 MB, ~0.1 us at
// 3.35 TB/s, while 8 blocks leave 124 of the 132 SMs idle: the time is one
// block's latency chain (a k-row load per thread, three barrier-separated
// phases, the output store).  S is deliberately not split across blocks:
// flash-decoding's split plus a combine pass would shorten the chain only
// for rows of several tiles, and at the decode's ~200 keys (one tile) the
// combine's second launch would cost more than it saves.
//
// Plain C interface for ctypes: decode_attn_single_launch returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 512;     // keys per tile
constexpr int MAX_REP = 8;
constexpr float NEG = -1e9f;

template <typename T> struct IsInt8 { static constexpr bool value = false; };
template <> struct IsInt8<int8_t> { static constexpr bool value = true; };

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* fill;
  const int* q_pos;
  float* out;
  int H, H_kv, S;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  float scale;
};

// T: the cache's element type (int8_t: dequantize by the scales).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_attn_single_kernel(Args a) {
  constexpr bool INT8 = IsInt8<T>::value;
  constexpr int KG = THREADS / D;            // key groups of the PV phase
  constexpr int CN = Chunk<T>::N;
  __shared__ __align__(16) float q_s[MAX_REP * D];
  __shared__ float sc[MAX_REP * TILE];       // scores, then p (* v_scale)
  __shared__ float red[KG * MAX_REP * D];    // PV partials per key group
  __shared__ float acc[MAX_REP * D];
  __shared__ float m_s[MAX_REP], l_s[MAX_REP], alpha_s[MAX_REP];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / a.H_kv;
  const int g = blockIdx.x % a.H_kv;
  const int rep = a.H / a.H_kv;
  const long long h0 = (long long)b * a.H + (long long)g * rep;  // first q row

  for (int i = tid; i < rep * D; i += THREADS) {
    q_s[i] = a.q[h0 * D + i];
    acc[i] = 0.f;
  }
  if (tid < rep) { m_s[tid] = NEG; l_s[tid] = 0.f; }
  __syncthreads();

  int limit = min(a.fill[b], a.q_pos[b] + 1);
  limit = max(0, min(limit, a.S));
  const T* kb = reinterpret_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vb = reinterpret_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  const float* ksb = INT8 ? a.k_scale + b * a.ks_sb + g * a.ks_sh : nullptr;
  const float* vsb = INT8 ? a.v_scale + b * a.vs_sb + g * a.vs_sh : nullptr;

  for (int t0 = 0; t0 < limit; t0 += TILE) {
    const int n = min(TILE, limit - t0);

    // ---- 1. scores: one thread per key
    for (int j = tid; j < n; j += THREADS) {
      const T* kr = kb + (long long)(t0 + j) * a.k_ss;
      float kf[D];
#pragma unroll
      for (int c = 0; c < D / CN; ++c) Chunk<T>::load(kr + CN * c, kf + CN * c);
      // a compiler barrier: the q reads below stay inside the key loop
      // (hoisted out of it, all rep * D of them spill to local memory)
      asm volatile("" ::: "memory");
      const float ks = INT8 ? ksb[t0 + j] : 1.f;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r < rep) {
          const float4* q4 = reinterpret_cast<const float4*>(q_s + r * D);
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < D / 4; ++i) {
            const float4 qv = q4[i];
            dot = fmaf(qv.x, kf[4 * i], dot);
            dot = fmaf(qv.y, kf[4 * i + 1], dot);
            dot = fmaf(qv.z, kf[4 * i + 2], dot);
            dot = fmaf(qv.w, kf[4 * i + 3], dot);
          }
          sc[r * TILE + j] = dot * ks * a.scale;
        }
      }
    }
    __syncthreads();

    // ---- 2. online softmax: warp r owns query row r
    if (warp < rep) {
      const int r = warp;
      float* row = sc + r * TILE;
      float tmax = NEG;
      for (int j = lane; j < n; j += 32) tmax = fmaxf(tmax, row[j]);
      tmax = warp_max(tmax);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, tmax);
      float psum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(row[j] - m_new);
        psum += p;
        row[j] = INT8 ? p * vsb[t0 + j] : p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // ---- 3. PV partials: thread (key group kg, column d)
    {
      const int d = tid % D, kg = tid / D;
      if (kg < KG) {
        float part[MAX_REP];
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) part[r] = 0.f;
        for (int j = kg; j < n; j += KG) {
          const float vv = to_f32(vb[(long long)(t0 + j) * a.v_ss + d]);
#pragma unroll
          for (int r = 0; r < MAX_REP; ++r)
            if (r < rep) part[r] = fmaf(sc[r * TILE + j], vv, part[r]);
        }
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
          if (r < rep) red[(kg * MAX_REP + r) * D + d] = part[r];
      }
    }
    __syncthreads();

    // ---- reduce the key groups, rescale and update the accumulator
    for (int i = tid; i < rep * D; i += THREADS) {
      const int r = i / D, d = i % D;
      float pv = 0.f;
#pragma unroll
      for (int kg = 0; kg < KG; ++kg) pv += red[(kg * MAX_REP + r) * D + d];
      acc[i] = acc[i] * alpha_s[r] + pv;
    }
    // the next tile's first shared writes (sc) come after this tile's PV
    // barrier, and its alpha_s / red writes after the barrier that ends
    // its score phase, which every thread reaches only once it has left
    // this loop; each acc element is owned by one thread
  }
  __syncthreads();

  for (int i = tid; i < rep * D; i += THREADS)
    a.out[h0 * D + i] = acc[i] / fmaxf(l_s[i / D], 1e-20f);
}

template <typename T>
cudaError_t launch_d(const Args& a, int B, int D, cudaStream_t st) {
  const dim3 grid(B * a.H_kv), block(THREADS);
  switch (D) {
    case 64: decode_attn_single_kernel<T, 64><<<grid, block, 0, st>>>(a); break;
    case 80: decode_attn_single_kernel<T, 80><<<grid, block, 0, st>>>(a); break;
    case 128: decode_attn_single_kernel<T, 128><<<grid, block, 0, st>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = int8 (k_scale / v_scale required).
// Strides are in elements.
extern "C" int decode_attn_single_launch(
    const float* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* fill, const int* q_pos, float* out,
    int B, int H, int H_kv, int S, int D, int dtype, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long ks_sb, long long ks_sh, long long vs_sb,
    long long vs_sh, float scale, void* stream) {
  if (B <= 0 || H_kv <= 0 || H % H_kv || H / H_kv > MAX_REP) return cudaErrorInvalidValue;
  Args a{q, k, v, k_scale, v_scale, fill, q_pos, out, H, H_kv, S, k_sb, k_sh,
         k_ss, v_sb, v_sh, v_ss, ks_sb, ks_sh, vs_sb, vs_sh, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_d<float>(a, B, D, st);
    case 1: return (int)launch_d<__nv_bfloat16>(a, B, D, st);
    case 2:
      if (!k_scale || !v_scale) return cudaErrorInvalidValue;
      return (int)launch_d<int8_t>(a, B, D, st);
    default: return cudaErrorInvalidValue;
  }
}
