// Bandwidth-floor probes for Hopper (sm_90a): kernels that stream the same
// bytes as a production kernel, in its access layout, with (almost) no
// arithmetic, so their time is the floor that layout can reach on the card.
//
//   K7  attn_dma_floor   <- miotts_tpu/ops/decode_attn.py:_dma_floor
//                           (K5's k / v blocks)
//   K8  qdot_dma_floor   <- benchmarks/bench_qmat.py:dma_floor
//                           (K1's value / scale blocks)
//
// K7.  k, v [B, H_kv, S, D] contiguous, bf16 / f32 / int8, rows of 16-byte
// multiples; s_tile = min(S, 512), n_s = S / s_tile (the JAX grid's whole
// tiles);
//   out[b, h, r, d] = sum_{t < n_s} (k + v)[b, h, t * s_tile + r, d]   (r < 8)
// as f32 [B, H_kv, 8, D], accumulated in t order, so it is the JAX result
// bit for bit.  Layout: K5's (decode_attn_single.cu): one block of 256
// threads per (b, kv-head) streams that head's rows with 16-byte loads,
// neighbouring threads on neighbouring 16 bytes.  The first 8 * D / VEC
// chunks of every tile (VEC elements of 16 bytes) are the output rows, and
// since a tile is a multiple of 256 chunks (s_tile = 512) or the only tile,
// each of them is read by the same thread in every tile.
//
// K8.  values int8 [K, N], scales f32 [K/32, N] (Q8_0's planar layout);
// TILE_N = 512 if N % 512 == 0 else 256, TILE_K = K halved while TILE_N *
// TILE_K > 512 KiB and TILE_K / 2 is a multiple of 256 (bench_qmat.py's
// rule);
//   out[0, n] = sum_{t < K / TILE_K} (v[t * TILE_K, n] + s[t * TILE_K / 32, n])
// as f32 [1, N], for every column n (the JAX grid covers N / TILE_N whole
// tiles; where N is their multiple the two agree up to the f32 order of the
// sums).  Layout: K1's GEMV (qdot.cu): 32 columns per block, one per lane,
// 16 warps splitting K by quant group; each thread reads its column's 32
// value bytes of a group (32 lanes: 32 neighbouring bytes, one sector) and
// its scale; the warps' partial sums meet in shared memory.
//
// Every byte is read.  The output depends on 8 rows of each tile only, and
// nvcc drops a load whose value is unused; so every loaded word is folded
// into a per-thread XOR, and the thread stores that XOR to `sink` only if
// it equals 0x7FBADCAF (a value the caller never reads; a store that
// depends on every load).  The fold is one integer op per loaded word (four
// per 16-byte chunk in K7, one per value byte in K8, which loads bytes as K1
// does), far below the memory time.  What bounds both: the bytes they stream over the
// 3.35 TB/s of HBM, at the occupancy of the layout (K7 at the LFM2 decode
// shape has 8 blocks).
//
// Plain C interface for ctypes: each *_launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

constexpr uint32_t SINK_MAGIC = 0x7FBADCAFu;

__device__ __forceinline__ uint32_t fold(uint4 c) { return c.x ^ c.y ^ c.z ^ c.w; }

// ---------------------------------------------------------------- K7
constexpr int ATTN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_dma_floor_kernel(const T* __restrict__ k, const T* __restrict__ v,
                      float* __restrict__ out, uint32_t* __restrict__ sink,
                      int S, int D, int s_tile, int n_s) {
  constexpr int VEC = Chunk<T>::N;
  const int head = blockIdx.x;                        // b * H_kv + h
  const size_t base = (size_t)head * S * D;
  const int cpr = D / VEC;                            // chunks per row
  const int out_chunks = 8 * cpr;                     // rows 0..7 of a tile
  const int tile_chunks = s_tile * cpr;
  const int total = n_s * tile_chunks;
  const int tid = threadIdx.x;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  uint32_t chk = 0;
#pragma unroll 4
  for (int j = tid; j < total; j += ATTN_THREADS) {
    const T* kp = k + base + (size_t)j * VEC;
    const T* vp = v + base + (size_t)j * VEC;
    const uint4 kc = *reinterpret_cast<const uint4*>(kp);
    const uint4 vc = *reinterpret_cast<const uint4*>(vp);
    chk ^= fold(kc) ^ fold(vc);
    if (j % tile_chunks < out_chunks) {
      float kf[VEC], vf[VEC];
      Chunk<T>::load(kp, kf);
      Chunk<T>::load(vp, vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += kf[e] + vf[e];
    }
  }
  if (tid < out_chunks) {
    float* o = out + (size_t)head * 8 * D + (size_t)tid * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = acc[e];
  }
  if (chk == SINK_MAGIC) sink[0] = chk;
}

// ---------------------------------------------------------------- K8
constexpr int GEMV_COLS = 32;
constexpr int GEMV_WARPS = 16;
constexpr int G = 32;   // Q8_0's group, the probe's

__global__ void __launch_bounds__(GEMV_COLS * GEMV_WARPS)
qdot_dma_floor_kernel(const int8_t* __restrict__ v, const float* __restrict__ s,
                      float* __restrict__ out, uint32_t* __restrict__ sink,
                      int K, int N, int tile_k) {
  __shared__ float red[GEMV_WARPS][GEMV_COLS];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int n = blockIdx.x * GEMV_COLS + lane;
  float acc = 0.f;
  uint32_t chk = 0;
  if (n < N) {
    for (int b = warp; b < K / G; b += GEMV_WARPS) {
      const int8_t* vp = v + (size_t)b * G * N + n;
      int q[G];
#pragma unroll
      for (int r = 0; r < G; ++r) q[r] = vp[(size_t)r * N];
      const float sc = s[(size_t)b * N + n];
#pragma unroll
      for (int r = 0; r < G; ++r) chk ^= (uint32_t)q[r];
      chk ^= __float_as_uint(sc);
      if ((b * G) % tile_k == 0) acc += (float)q[0] + sc;
    }
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && n < N) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < GEMV_WARPS; ++w) t += red[w][lane];
    out[n] = t;
  }
  if (chk == SINK_MAGIC) sink[0] = chk;
}

template <typename T>
void attn_launch(const void* k, const void* v, float* out, uint32_t* sink,
                 int heads, int S, int D, int s_tile, int n_s,
                 cudaStream_t stream) {
  attn_dma_floor_kernel<T><<<heads, ATTN_THREADS, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), out, sink, S, D,
      s_tile, n_s);
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 int8 (the decode-attention kernels' codes)
extern "C" int attn_dma_floor_launch(const void* k, const void* v, void* out,
                                     void* sink, int B, int H_kv, int S, int D,
                                     int dtype, void* stream) {
  const int el = dtype == 0 ? 4 : dtype == 1 ? 2 : 1;
  if (B < 1 || H_kv < 1 || S < 1 || D < 1 || dtype < 0 || dtype > 2 ||
      (D * el) % 16 || 8 * (D * el / 16) > ATTN_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  const int s_tile = S <= 512 ? S : 512;
  const int n_s = S / s_tile;
  if (s_tile < 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  uint32_t* sk = static_cast<uint32_t*>(sink);
  if (dtype == 0) attn_launch<float>(k, v, o, sk, B * H_kv, S, D, s_tile, n_s, st);
  else if (dtype == 1) attn_launch<__nv_bfloat16>(k, v, o, sk, B * H_kv, S, D, s_tile, n_s, st);
  else attn_launch<int8_t>(k, v, o, sk, B * H_kv, S, D, s_tile, n_s, st);
  return (int)cudaGetLastError();
}

extern "C" int qdot_dma_floor_launch(const void* v, const void* s, void* out,
                                     void* sink, int K, int N, int tile_k,
                                     void* stream) {
  if (K < 1 || N < 1 || K % G || tile_k < 8 * G || tile_k % G || K % tile_k) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 block(GEMV_COLS, GEMV_WARPS);
  dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS);
  qdot_dma_floor_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(v), static_cast<const float*>(s),
      static_cast<float*>(out), static_cast<uint32_t*>(sink), K, N, tile_k);
  return (int)cudaGetLastError();
}
