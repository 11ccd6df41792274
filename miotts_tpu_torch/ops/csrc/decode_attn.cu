// Batched single-query flash-decode attention for Hopper (sm_90a).
//
// Replaces miotts_tpu/ops/decode_attn.py:_batched_kernel (reached through
// decode_attention_batched), the attention of batched serving: every layer
// of every batched decode step reads the KV cache through it.
//
// Contract (the JAX one):
//   q       [B, H, D]            bf16 / f32 (float mode, cast to the cache's
//                                type by the wrapper) or int8 + f32 scales
//                                q_scale [B, H] (int8 mode, quantized per
//                                (b, h) row by the wrapper)
//   k, v    [B, H_kv, S, D]      bf16 / f32 / int8, any batch / head / row
//                                strides (a layer slice of the [L, B, H_kv,
//                                S_alloc, D] cache cut to attn_len keys), the
//                                last dim contiguous
//   k_scale, v_scale [B, H_kv, S] f32 (int8 mode), any batch / head strides
//   fill, q_pos [B] int32: key s is valid iff s < min(fill[b], q_pos[b] + 1)
//   out     [B, H, D] f32: acc / max(l, 1e-20), or the raw flash state acc
//           with m, l [B, H] when out_m / out_l are given
//
// Float mode: scores q.k in f32 times scale (computed in double by the
// wrapper), masked scores -1e9, p = exp(s - m) rounded to the cache's type
// before the PV product, sums in f32, l summing the unrounded p.
//
// int8 mode: scores int32(q_i8 . k_i8) * (q_scale * scale) * k_scale via
// __dp4a (exact).  The PV product quantizes ps = p * v_scale per query row
// PER KEY TILE: psc = max(max(ps), 1e-20) / 127, p_i8 = int(ps / psc + 0.5)
// (true division, truncation), then int32(p_i8 . v_i8) * psc.  The grouping
// of that quantization is part of the result: the port fixes it at 512 keys
// (or S when S <= 512), the TPU kernel's tile before its VMEM halving, which
// is not copied here.
//
// Design.  One block per (b, kv-head g): B * H_kv blocks of 256 threads.
// The TPU grid's sequential S axis, which carried the flash state in VMEM
// scratch, becomes a loop over 512-key tiles inside the block; the block
// keeps the rep = H / H_kv query rows, their running (m, l) and their
// [rep, D] accumulator in shared memory.  Per tile:
//   1. scores: one thread per key reads its k row with 16-byte loads (the
//      rows are contiguous, the q rows are broadcast from shared memory)
//      and writes rep scores into a shared [rep, 512] tile;
//   2. softmax update: warp r owns query row r (rep <= 8 warps): tile max,
//      m_new, exp, l, and in int8 mode the per-row probability quantization;
//   3. PV: thread (key group, d) sums p * v over a strided share of the
//      tile's keys for all rep rows (neighbouring threads read neighbouring
//      d of a v row), the key groups are reduced in shared memory and the
//      accumulator is rescaled by exp(m_prev - m_new) and updated.
// Only keys below the row's limit are read: tiles past it are skipped (on
// those the TPU kernel's update is a no-op), so an idle slot (fill 0) reads
// nothing and returns acc 0, l 0, m -1e9.
//
// What bounds it: every valid key's k and v row is read once, plus scales,
// q and the output, so the bound is those bytes over 3.35 TB/s; the flops
// (4 * rep * D per key) are far below the tensor-core line.  What this
// simple design leaves on the table: one block per (b, g) serialises a
// long row's tiles on one SM (flash-decoding would split S across blocks
// and combine); the k rows are read one per thread, so a warp's load
// touches 32 rows at once instead of TMA / cp.async staging of whole tiles;
// the three phases of a tile are separated by barriers with no overlap of
// the next tile's loads.
//
// Plain C interface for ctypes: decode_attn_launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 512;     // keys per tile (the int8 quantization group)
constexpr int MAX_REP = 8;
constexpr float NEG = -1e9f;

// p rounded to the cache's type before the PV product
template <typename T> __device__ __forceinline__ float round_to(float p);
template <> __device__ __forceinline__ float round_to<float>(float p) { return p; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

struct Args {
  const void* q;
  const float* q_scale;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* fill;
  const int* q_pos;
  float* out;
  float* out_m;
  float* out_l;
  int H, H_kv, S;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  float scale;
};

// T: cache element type; INT8: T == int8_t (int8 mode).
template <typename T, int D, bool INT8>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(Args a) {
  constexpr int KG = THREADS / D;            // key groups of the PV phase
  __shared__ float q_f[INT8 ? 1 : MAX_REP * D];
  __shared__ int q_i[INT8 ? MAX_REP * (D / 4) : 1];
  __shared__ float qss[MAX_REP];             // q_scale * scale (int8)
  __shared__ float sc[MAX_REP * TILE];       // scores, then p (or p * vs)
  __shared__ int8_t p8[INT8 ? MAX_REP * TILE : 1];
  __shared__ int red[KG * MAX_REP * D];      // PV partials (f32 bits or int)
  __shared__ float acc[MAX_REP * D];
  __shared__ float m_s[MAX_REP], l_s[MAX_REP], alpha_s[MAX_REP], psc_s[MAX_REP];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / a.H_kv;
  const int g = blockIdx.x % a.H_kv;
  const int rep = a.H / a.H_kv;
  const long long h0 = (long long)b * a.H + (long long)g * rep;  // first q row

  if constexpr (INT8) {
    const int8_t* q8 = reinterpret_cast<const int8_t*>(a.q);
    for (int i = tid; i < rep * (D / 4); i += THREADS) {
      const int r = i / (D / 4), w = i % (D / 4);
      q_i[r * (D / 4) + w] =
          *reinterpret_cast<const int*>(q8 + (h0 + r) * D + 4 * w);
    }
    if (tid < rep) qss[tid] = a.q_scale[h0 + tid] * a.scale;
  } else {
    const T* qt = reinterpret_cast<const T*>(a.q);
    for (int i = tid; i < rep * D; i += THREADS)
      q_f[i] = to_f32(qt[h0 * D + i]);
  }
  for (int i = tid; i < rep * D; i += THREADS) acc[i] = 0.f;
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
      if constexpr (INT8) {
        int dot[MAX_REP];
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) dot[r] = 0;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const int4 kc = *reinterpret_cast<const int4*>(
              reinterpret_cast<const int8_t*>(kr) + 16 * c);
          const int kw[4] = {kc.x, kc.y, kc.z, kc.w};
#pragma unroll
          for (int r = 0; r < MAX_REP; ++r) {
            if (r < rep) {
#pragma unroll
              for (int w = 0; w < 4; ++w)
                dot[r] = __dp4a(kw[w], q_i[r * (D / 4) + 4 * c + w], dot[r]);
            }
          }
        }
        const float ks = ksb[t0 + j];
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
          if (r < rep) sc[r * TILE + j] = (float)dot[r] * qss[r] * ks;
      } else {
        constexpr int CN = Chunk<T>::N;
        float dot[MAX_REP];
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) dot[r] = 0.f;
#pragma unroll
        for (int c = 0; c < D / CN; ++c) {
          float kf[CN];
          Chunk<T>::load(kr + CN * c, kf);
#pragma unroll
          for (int r = 0; r < MAX_REP; ++r) {
            if (r < rep) {
#pragma unroll
              for (int e = 0; e < CN; ++e)
                dot[r] = fmaf(q_f[r * D + CN * c + e], kf[e], dot[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
          if (r < rep) sc[r * TILE + j] = dot[r] * a.scale;
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
      float psum = 0.f, pmax = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(row[j] - m_new);
        psum += p;
        if constexpr (INT8) {
          const float ps = p * vsb[t0 + j];
          pmax = fmaxf(pmax, ps);
          row[j] = ps;
        } else {
          row[j] = round_to<T>(p);
        }
      }
      psum = warp_sum(psum);
      float psc = 0.f;
      if constexpr (INT8) {
        pmax = warp_max(pmax);
        psc = fmaxf(pmax, 1e-20f) / 127.0f;
        for (int j = lane; j < n; j += 32)
          p8[r * TILE + j] = (int8_t)(int)(row[j] / psc + 0.5f);
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
        psc_s[r] = psc;
      }
    }
    __syncthreads();

    // ---- 3. PV partials: thread (key group kg, column d)
    {
      const int d = tid % D, kg = tid / D;
      if (kg < KG) {
        if constexpr (INT8) {
          int part[MAX_REP];
#pragma unroll
          for (int r = 0; r < MAX_REP; ++r) part[r] = 0;
          for (int j = kg; j < n; j += KG) {
            const int vv = (int)reinterpret_cast<const int8_t*>(vb)[
                (long long)(t0 + j) * a.v_ss + d];
#pragma unroll
            for (int r = 0; r < MAX_REP; ++r)
              if (r < rep) part[r] += (int)p8[r * TILE + j] * vv;
          }
#pragma unroll
          for (int r = 0; r < MAX_REP; ++r)
            if (r < rep) red[(kg * MAX_REP + r) * D + d] = part[r];
        } else {
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
            if (r < rep) red[(kg * MAX_REP + r) * D + d] = __float_as_int(part[r]);
        }
      }
    }
    __syncthreads();

    // ---- reduce the key groups, rescale and update the accumulator
    for (int i = tid; i < rep * D; i += THREADS) {
      const int r = i / D, d = i % D;
      float pv;
      if constexpr (INT8) {
        int s = 0;
#pragma unroll
        for (int kg = 0; kg < KG; ++kg) s += red[(kg * MAX_REP + r) * D + d];
        pv = (float)s * psc_s[r];
      } else {
        pv = 0.f;
#pragma unroll
        for (int kg = 0; kg < KG; ++kg)
          pv += __int_as_float(red[(kg * MAX_REP + r) * D + d]);
      }
      acc[i] = acc[i] * alpha_s[r] + pv;
    }
    // the next tile's first writes (sc, then alpha_s / red) come after the
    // barrier that ends its score phase, which every thread reaches only
    // once it has left this loop
  }
  __syncthreads();

  for (int i = tid; i < rep * D; i += THREADS) {
    const int r = i / D;
    a.out[h0 * D + i] = a.out_m ? acc[i] : acc[i] / fmaxf(l_s[r], 1e-20f);
  }
  if (a.out_m && tid < rep) {
    a.out_m[h0 + tid] = m_s[tid];
    a.out_l[h0 + tid] = l_s[tid];
  }
}

template <typename T, bool INT8>
cudaError_t launch_d(const Args& a, int B, int D, cudaStream_t st) {
  const dim3 grid(B * a.H_kv), block(THREADS);
  switch (D) {
    case 64: decode_attn_kernel<T, 64, INT8><<<grid, block, 0, st>>>(a); break;
    case 80: decode_attn_kernel<T, 80, INT8><<<grid, block, 0, st>>>(a); break;
    case 128: decode_attn_kernel<T, 128, INT8><<<grid, block, 0, st>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = int8 (q_scale / k_scale / v_scale required).
// out_m / out_l null -> normalised output.  Strides are in elements.
extern "C" int decode_attn_launch(
    const void* q, const float* q_scale, const void* k, const void* v,
    const float* k_scale, const float* v_scale, const int* fill,
    const int* q_pos, float* out, float* out_m, float* out_l, int B, int H,
    int H_kv, int S, int D, int dtype, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long ks_sb, long long ks_sh, long long vs_sb, long long vs_sh,
    float scale, void* stream) {
  if (B <= 0 || H_kv <= 0 || H % H_kv || H / H_kv > MAX_REP) return cudaErrorInvalidValue;
  if ((out_m == nullptr) != (out_l == nullptr)) return cudaErrorInvalidValue;
  Args a{q, q_scale, k, v, k_scale, v_scale, fill, q_pos, out, out_m, out_l,
         H, H_kv, S, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb, ks_sh,
         vs_sb, vs_sh, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_d<float, false>(a, B, D, st);
    case 1: return (int)launch_d<__nv_bfloat16, false>(a, B, D, st);
    case 2:
      if (!q_scale || !k_scale || !v_scale) return cudaErrorInvalidValue;
      return (int)launch_d<int8_t, true>(a, B, D, st);
    default: return cudaErrorInvalidValue;
  }
}
