// Device helpers shared by the decode-attention kernels (decode_attn.cu,
// decode_attn_single.cu): 16-byte row loaders, q's 4-value loader, scalar
// upcasts, warp reductions, cp.async copies, a 4 x 4 byte transpose and the
// thread-block cluster's start barrier and rank pointers.  Each source
// includes this header into its own translation unit; _build.py hashes it
// with every source, so an edit rebuilds both.  Everything has internal
// linkage (an anonymous namespace): no object is shared between the
// libraries loaded into one process.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

// one 16-byte chunk of a cache row -> N floats
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 c = *reinterpret_cast<const float4*>(p);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 c = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};
template <> struct Chunk<int8_t> {
  static constexpr int N = 16;
  __device__ static void load(const int8_t* p, float* out) {
    const int4 c = *reinterpret_cast<const int4*>(p);
    const int w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e)   // byte e, sign-extended
        out[4 * i + e] = (float)((int)((uint32_t)w[i] << (24 - 8 * e)) >> 24);
    }
  }
};

// four neighbouring values of q from element idx (f32: one 16-byte load,
// bf16: one 8-byte load), as f32
__device__ __forceinline__ void load_q4(const void* q, bool f32, long long idx,
                                        float (&o)[4]) {
  if (f32) {
    const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(q) + idx);
    o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(q) + idx);
    o[0] = __uint_as_float(u.x << 16); o[1] = __uint_as_float(u.x & 0xFFFF0000u);
    o[2] = __uint_as_float(u.y << 16); o[3] = __uint_as_float(u.y & 0xFFFF0000u);
  }
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) { return (float)v; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes global -> shared, bypassing L1; `bytes` < 16 zero-fills the rest
// (0: a row of zeros, nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes = 16) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 4 x 4 bytes transposed: t[j] holds byte j of a, b, c and d (in that
// order, a in the low byte): four rows' bytes of one column in a word, the
// operand __dp4a takes
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t (&t)[4]) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
  t[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
  t[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  t[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  t[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// The split start barrier of a cluster: every thread arrives at its block's
// entry (relaxed: it orders nothing) and waits before its first write into
// another rank's shared memory, so no rank writes into a block that has not
// started, and the entry does not wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// p in rank r's shared memory (distributed shared memory) in a cluster of R
// blocks; a one-block cluster keeps its own pointer
template <typename P>
__device__ __forceinline__ P* in_rank(cg::cluster_group& cluster, int R, P* p, int r) {
  return R > 1 ? cluster.map_shared_rank(p, r) : p;
}

}  // namespace
