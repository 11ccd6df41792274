// Device helpers shared by the decode-attention kernels (decode_attn.cu,
// decode_attn_single.cu): 16-byte row loaders, scalar upcasts and warp
// reductions.  Each source includes this header into its own translation
// unit; _build.py hashes it with every source, so an edit rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

}  // namespace
