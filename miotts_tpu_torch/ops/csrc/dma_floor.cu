// Bandwidth-floor probes for Hopper (sm_90a): kernels that stream the same
// bytes as a production kernel, in its decomposition and the way it streams
// them, with no arithmetic beyond what their small output needs, so their
// time is the floor of that layout on the card.
//
//   K7  attn_dma_floor   <- miotts_tpu/ops/decode_attn.py:_dma_floor
//                           (K5's k / v rows, decode_attn_single.cu)
//   K8  qdot_dma_floor   <- benchmarks/bench_qmat.py:dma_floor
//                           (K1's M = 1 value / scale rows, qdot_gemv.cuh)
//
// Both stage every byte they stream into shared memory by 16-byte cp.async
// (attn_common.cuh), several chunks in flight in a ring.  The copies are
// asm volatile, so nvcc cannot drop them even though no thread reads the
// staged bytes, and each thread waits on every copy it issued before its
// block exits (a copy never waited on would leave the kernel's end open).
// A thread only ever copies into its own 16-byte pieces of a slot (piece i
// of every chunk goes to thread i mod the block's threads), so waiting on
// its own copies before it refills a slot is all the ring needs: no block
// barrier.  The output rows are read by plain loads and are part of the
// result, so nothing needs folding into a sink.
//
// K7.  k, v [B, H_kv, S, D] contiguous, bf16 / f32 / int8, rows of 16-byte
// multiples (at most 512 bytes); s_tile = min(S, 512), n_s = S / s_tile (the
// JAX grid's whole tiles; the rows past n_s * s_tile are not read);
//   out[b, h, r, d] = sum_{t < n_s} (k + v)[b, h, t * s_tile + r, d]   (r < 8)
// as f32 [B, H_kv, 8, D], accumulated from 0 in t order: the plain version's
// sums, bit for bit.  Layout: K5's.  A thread-block cluster of R <= 8
// blocks of 256 threads per (b, kv head), grid (R, B * H_kv), R from the
// plan (ops/decode_attn.py:_single_plan, or the caller's); rank r streams
// the contiguous share [r * per, (r + 1) * per) of the n_s * s_tile rows,
// per = ceil(n_s * s_tile / R), in chunks of SUB rows (K5's: <= 16 KB of k
// rows, <= 256 rows), each chunk's k and v rows in one slot, NCH = 2 chunks
// in flight, the chunk after next issued once the thread's copies of a
// chunk have landed.  Rank 0 reads the 8 * n_s output rows itself, by
// 16-byte loads issued while its copies are in flight: a few rows, and no
// cluster barrier (K5's one combine barrier, ~1.1 us on the H100, is K5's
// algorithm, not the cost of streaming its layout, PERF.md).  What bounds
// it: at LFM2's decode shape (B = 1, 8 kv heads, S = 256) each of 64 blocks
// streams 8 KB, so a launch is one copy round trip plus the launch itself
// (~2.3 us on the H100, PERF.md); the bytes over HBM's 3.35 TB/s are
// ~0.16 us.  The batched shapes (one rank, 256-1024 blocks) stream at
// 2.2-2.9 TB/s.
//
// K8.  values int8 [K, N], scales f32 or bf16 [K/32, N] (Q8_0's planar
// layout; s_is_bf16 picks the bf16-scale instantiation, the floor of K1 at
// MIOTTS_SCALE_BF16's bytes, whose scale rows are half as wide);
// TILE_N = 512 if N % 512 == 0 else 256, TILE_K = K halved while TILE_N *
// TILE_K > 512 KiB and TILE_K / 2 is a multiple of 256 (bench_qmat.py's
// rule);
//   out[0, n] = sum_{t < K / TILE_K} (v[t * TILE_K, n] + s[t * TILE_K / 32, n])
// as f32 [1, N] (a bf16 s upcast exactly), for every column n (the JAX grid covers N / TILE_N whole
// tiles; where N is their multiple the two agree up to the f32 order of the
// sums).  Layout: K1's M = 1 GEMV (qdot_gemv.cuh): blocks of 128 threads
// over 32 columns (128 where rows are not 16-byte aligned, N % 16 != 0),
// each block a cluster of `splits` blocks along K, k_split rows each (the
// plan: ops/qmat.py:_gemv_plan, or the caller's).  A block streams its
// slice's value rows and scale rows, chunk by chunk (8 quant groups of
// value rows, 8 KB, on aligned rows; 2 on unaligned ones, whose 128
// columns make a row 128 bytes), K8_STAGES = 4 chunks in flight.  A row's
// columns are copied as the aligned 16-byte pieces that cover them (one
// piece more where the row is not aligned: the heads' 13059 columns; the
// last piece of the tensor copies only the bytes that exist), so the copies
// never need a 4-byte path.  The slice's output rows (the rows t * TILE_K
// it holds) are read by the column's thread while the copies fly, summed
// in t order, and the cluster's partial sums meet in rank 0 in rank order
// through distributed shared memory, as K1's do (two cluster barriers, no
// workspace, no atomics: a second call gives the same bits).  What bounds
// it: the value and scale bytes over HBM's 3.35 TB/s, at the plan's blocks
// (about two an SM).  On the H100 the layout's 32-byte row strips and each
// launch's fixed ~2 us hold bench_qmat's 2.6B step to ~1.74 TB/s; the same
// bytes streamed contiguously in the same grid and ring reach ~1.90, and
// 2 to 8 chunks in flight, or 4 to 16 groups a chunk, move it by <= 8 %
// (scripts/torch_probe_variants.py, PERF.md).
//
// Plain C interface for ctypes: each *_launch returns the launch's
// cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

// ---------------------------------------------------------------- K7
constexpr int K7_THREADS = 256;         // K5's block
constexpr int MAX_RANKS = 8;            // the portable cluster size
constexpr int CHUNK_BYTES = 16 * 1024;  // a chunk's k rows at most (K5's)
constexpr int MAX_SUB = 256;            // a chunk's rows at most (K5's)
constexpr int NCH = 2;                  // chunks in flight (K5's ring)

__host__ __device__ constexpr int floor_pow2(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// rows of a chunk for rows of `rowb` bytes: K5's SUB
__host__ __device__ constexpr int sub_rows(int rowb) {
  return floor_pow2(CHUNK_BYTES / rowb < MAX_SUB ? CHUNK_BYTES / rowb : MAX_SUB);
}

// dynamic shared memory of a K7 block: NCH slots of a chunk's k and v rows
size_t k7_smem(int rowb) { return (size_t)NCH * 2 * sub_rows(rowb) * rowb; }

template <typename T>
__global__ void __launch_bounds__(K7_THREADS)
attn_dma_floor_kernel(const T* __restrict__ k, const T* __restrict__ v,
                      float* __restrict__ out, int S, int D, int s_tile, int n_s) {
  constexpr int VEC = Chunk<T>::N;               // elements of 16 bytes
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x;
  const int R = gridDim.x, rank = blockIdx.x;    // the cluster spans grid x
  const int head = blockIdx.y;                   // b * H_kv + h
  const int rowb = D * (int)sizeof(T);
  const int cpr = rowb / 16;                     // 16-byte pieces of a row
  const int sub = sub_rows(rowb);
  const size_t base = (size_t)head * S * D;
  // the rank's share [lo, hi) of the rows the probe reads
  const int total = n_s * s_tile;
  const int per = (total + R - 1) / R;
  const int lo = min(total, rank * per);
  const int hi = min(total, lo + per);
  const int n_rows = hi - lo;
  const int n_chunks = (n_rows + sub - 1) / sub;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k + base) + (size_t)lo * rowb;
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v + base) + (size_t)lo * rowb;

  // chunk j of the share into slot j % NCH (k rows, then v rows): one
  // commit group, empty past the last chunk
  auto issue = [&](int j) {
    unsigned char* slot = ring + (size_t)(j % NCH) * 2 * sub * rowb;
    const int n = j < n_chunks ? min(sub, n_rows - j * sub) * cpr : 0;
    const size_t off = (size_t)j * sub * rowb;
    for (int i = tid; i < n; i += K7_THREADS) {
      cp_async16(slot + 16 * i, kb + off + 16 * i);
      cp_async16(slot + (size_t)sub * rowb + 16 * i, vb + off + 16 * i);
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < NCH; ++j) issue(j);

  // the output: rank 0's threads read rows t * s_tile + r (r < 8) of every
  // tile, 16 bytes each, while the copies are in flight
  if (rank == 0 && tid < 8 * cpr) {
    const int r = tid / cpr, c = tid - r * cpr;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int t = 0; t < n_s; ++t) {
      const size_t at = base + (size_t)(t * s_tile + r) * D + (size_t)c * VEC;
      float kf[VEC], vf[VEC];
      Chunk<T>::load(k + at, kf);
      Chunk<T>::load(v + at, vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += kf[e] + vf[e];
    }
    float4* o = reinterpret_cast<float4*>(out + (size_t)head * 8 * D + (size_t)tid * VEC);
#pragma unroll
    for (int e4 = 0; e4 < VEC / 4; ++e4)
      o[e4] = make_float4(acc[4 * e4], acc[4 * e4 + 1], acc[4 * e4 + 2], acc[4 * e4 + 3]);
  }

  // the ring: chunk j has landed (this thread's copies), its slot takes
  // chunk j + NCH
  for (int j = 0; j < n_chunks; ++j) {
    cp_wait<NCH - 1>();
    issue(j + NCH);
  }
  cp_wait<0>();
}

template <typename T>
cudaError_t attn_launch(const void* k, const void* v, float* out, int heads,
                        int S, int D, int s_tile, int n_s, int ranks,
                        cudaStream_t stream) {
  auto kernel = attn_dma_floor_kernel<T>;
  const size_t smem = k7_smem(D * (int)sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, heads, 1);
  cfg.blockDim = dim3(K7_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(k),
                                             static_cast<const T*>(v), out, S, D,
                                             s_tile, n_s);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// ---------------------------------------------------------------- K8
constexpr int G = 32;                     // Q8_0's group, the probe's
constexpr int K8_THREADS = 128;           // K1's GEMV block (GEMV_THREADS)
constexpr int K8_MAX_SPLITS = 8;          // the portable cluster size
constexpr int K8_STAGES = 4;              // chunks in flight
constexpr int K8_CHUNK_GROUPS = 8;        // quant groups of a chunk, aligned rows
constexpr int K8_CHUNK_GROUPS_UNALIGNED = 2;

// A block's columns and a ring slot: a chunk's value rows, then its scale
// rows (of S: f32 or bf16), each row as the 16-byte pieces that cover its
// columns (one more where rows are not 16-byte aligned).
template <bool ALIGNED, typename S> struct K8Layout {
  static constexpr int COLS = ALIGNED ? 32 : 128;   // ops/qmat.py:_gemv_cols
  static constexpr int VP = COLS / 16 + (ALIGNED ? 0 : 1);
  static constexpr int SP = COLS * (int)sizeof(S) / 16 + (ALIGNED ? 0 : 1);
  static constexpr int ROWS = G * (ALIGNED ? K8_CHUNK_GROUPS : K8_CHUNK_GROUPS_UNALIGNED);
  static constexpr int S_OFF = 16 * ROWS * VP;      // the scale rows in a slot
  static constexpr int SLOT = S_OFF + 16 * (ROWS / G) * SP;
};

// the 16-byte piece p of the aligned pieces that cover bytes [a, b) of
// `src` into dst, if it starts before b; the tensor's last piece copies only
// the bytes before `end`
__device__ __forceinline__ void copy_piece(void* dst, const unsigned char* src,
                                           size_t a, size_t b, int p, size_t end) {
  const size_t at = (a & ~(size_t)15) + 16 * (size_t)p;
  if (at < b) cp_async16(dst, src + at, end - at < 16 ? (int)(end - at) : 16);
}

template <bool ALIGNED, typename S>
__global__ void __launch_bounds__(K8_THREADS)
qdot_dma_floor_kernel(const int8_t* __restrict__ v, const S* __restrict__ s,
                      float* __restrict__ out, int K, int N, int k_split, int tile_k) {
  using L = K8Layout<ALIGNED, S>;
  constexpr size_t SB = sizeof(S);
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float part[L::COLS];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * L::COLS, n1 = min(N, n0 + L::COLS);
  const int k0 = blockIdx.y * k_split, k1 = min(K, k0 + k_split);  // the slice
  const int n_chunks = (k1 - k0 + L::ROWS - 1) / L::ROWS;
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);
  const unsigned char* sb = reinterpret_cast<const unsigned char*>(s);
  const size_t v_end = (size_t)K * N, s_end = (size_t)(K / G) * N * SB;

  // chunk j of the slice into slot j % K8_STAGES: its value rows' pieces,
  // then its scale rows' (one commit group; empty past the last chunk)
  auto issue = [&](int j) {
    unsigned char* slot = ring + (size_t)(j % K8_STAGES) * L::SLOT;
    const int r0 = k0 + j * L::ROWS;
    const int rows = j < n_chunks ? min(L::ROWS, k1 - r0) : 0;
    for (int i = tid; i < rows * L::VP; i += K8_THREADS) {
      const int r = i / L::VP;
      const size_t a = (size_t)(r0 + r) * N + n0;
      copy_piece(slot + 16 * i, vb, a, a + (n1 - n0), i - r * L::VP, v_end);
    }
    for (int i = tid; i < rows / G * L::SP; i += K8_THREADS) {
      const int r = i / L::SP;
      const size_t a = ((size_t)(r0 / G + r) * N + n0) * SB;
      copy_piece(slot + L::S_OFF + 16 * i, sb, a, a + SB * (n1 - n0), i - r * L::SP,
                 s_end);
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < K8_STAGES; ++j) issue(j);

  // the output rows of the slice, t * tile_k in [k0, k1), by the column's
  // thread while the copies are in flight, summed in t order
  const int n = n0 + tid;
  float acc = 0.f;
  if (tid < L::COLS && n < N) {
    for (int t = (k0 + tile_k - 1) / tile_k; t * tile_k < k1; ++t)
      acc += (float)v[(size_t)t * tile_k * N + n]
             + to_f32(s[(size_t)(t * tile_k / G) * N + n]);
  }

  // the ring: chunk j has landed (this thread's copies), its slot takes
  // chunk j + K8_STAGES
  for (int j = 0; j < n_chunks; ++j) {
    cp_wait<K8_STAGES - 1>();
    issue(j + K8_STAGES);
  }
  cp_wait<0>();

  // the cluster's partial sums in rank 0, in rank order (K1's combine)
  if (tid < L::COLS) part[tid] = acc;
  cluster.sync();
  if (cluster.block_rank() == 0 && tid < L::COLS && n < N) {
    float t = 0.f;
    const int n_ranks = (int)cluster.num_blocks();
    for (int r = 0; r < n_ranks; ++r) t += cluster.map_shared_rank(&part[0], r)[tid];
    out[n] = t;
  }
  cluster.sync();   // the other blocks' shared memory lives until it is read
}

template <bool ALIGNED, typename S>
cudaError_t qdot_launch(const int8_t* v, const void* s, float* out, int K, int N,
                        int splits, int k_split, int tile_k, cudaStream_t stream) {
  using L = K8Layout<ALIGNED, S>;
  auto kernel = qdot_dma_floor_kernel<ALIGNED, S>;
  const size_t smem = (size_t)K8_STAGES * L::SLOT;
  if (smem > 48 * 1024 - sizeof(float) * L::COLS) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + L::COLS - 1) / L::COLS, splits, 1);
  cfg.blockDim = dim3(K8_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, v, static_cast<const S*>(s),
                                             out, K, N, k_split, tile_k);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 int8 (the decode-attention kernels' codes); ranks:
// the cluster's blocks a (b, kv head), 1..8 (the plan's)
extern "C" int attn_dma_floor_launch(const void* k, const void* v, void* out,
                                     int B, int H_kv, int S, int D, int dtype,
                                     int ranks, void* stream) {
  const int el = dtype == 0 ? 4 : dtype == 1 ? 2 : 1;
  if (B < 1 || H_kv < 1 || S < 1 || D < 1 || dtype < 0 || dtype > 2 ||
      (D * el) % 16 || 8 * (D * el / 16) > K7_THREADS || ranks < 1 ||
      ranks > MAX_RANKS || (long long)B * H_kv > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int s_tile = S <= 512 ? S : 512;
  const int n_s = S / s_tile;
  if (s_tile < 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int heads = B * H_kv;
  if (dtype == 0) return (int)attn_launch<float>(k, v, o, heads, S, D, s_tile, n_s, ranks, st);
  if (dtype == 1)
    return (int)attn_launch<__nv_bfloat16>(k, v, o, heads, S, D, s_tile, n_s, ranks, st);
  return (int)attn_launch<int8_t>(k, v, o, heads, S, D, s_tile, n_s, ranks, st);
}

// v, s 16-byte aligned; s f32, or bf16 if s_is_bf16; splits (1..8) blocks
// of k_split rows (whole quant groups, covering K exactly: the GEMV plan's
// rule) along K
extern "C" int qdot_dma_floor_launch(const void* v, const void* s, int s_is_bf16,
                                     void* out, int K, int N, int tile_k,
                                     int splits, int k_split, void* stream) {
  if (K < 1 || N < 1 || K % G || tile_k < 8 * G || tile_k % G || K % tile_k ||
      splits < 1 || splits > K8_MAX_SPLITS || k_split < G || k_split % G ||
      (long long)splits * k_split < K || (long long)(splits - 1) * k_split >= K ||
      (reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(s)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int8_t* vp = static_cast<const int8_t*>(v);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_is_bf16) {
    return N % 16 == 0
        ? (int)qdot_launch<true, __nv_bfloat16>(vp, s, o, K, N, splits, k_split, tile_k, st)
        : (int)qdot_launch<false, __nv_bfloat16>(vp, s, o, K, N, splits, k_split, tile_k,
                                                 st);
  }
  return N % 16 == 0
      ? (int)qdot_launch<true, float>(vp, s, o, K, N, splits, k_split, tile_k, st)
      : (int)qdot_launch<false, float>(vp, s, o, K, N, splits, k_split, tile_k, st);
}
