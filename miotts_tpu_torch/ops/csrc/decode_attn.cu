// Batched single-query flash-decode attention for Hopper (sm_90a).
//
// Replaces miotts_tpu/ops/decode_attn.py:_batched_kernel (reached through
// decode_attention_batched), the attention of batched serving: every layer
// of every batched decode step reads the KV cache through it.
//
// Contract (the JAX one):
//   q       [B, H, D]            bf16 / f32: the cache's type (float mode,
//                                cast by the wrapper), or either (int8
//                                mode, quantized per (b, h) row here)
//   k, v    [B, H_kv, S, D]      bf16 / f32 / int8, any batch / head / row
//                                strides (a layer slice of the [L, B, H_kv,
//                                S_alloc, D] cache cut to attn_len keys), the
//                                last dim contiguous, rows 16-byte aligned
//   k_scale, v_scale [B, H_kv, S] f32 (int8 mode), any batch / head strides
//   fill, q_pos [B] int32: key s is valid iff s < min(fill[b], q_pos[b] + 1)
//   out     [B, H, D] f32: acc / max(l, 1e-20), or the raw flash state acc
//           with m, l [B, H] when out_m / out_l are given
//
// Float mode: scores q.k in f32 times scale (computed in double by the
// wrapper), p = exp(s - m) rounded to the cache's type before the PV
// product, sums in f32, l summing the unrounded p.
//
// int8 mode: q (bf16 or f32) is quantized per (b, h) row in the kernel with
// the bits the wrapper's quantize_query gives on a CUDA tensor; scores
// int32(q_i8 . k_i8) * (q_scale * scale) * k_scale via __dp4a (exact).  The
// PV product quantizes ps = p * v_scale per query row PER KEY TILE: psc =
// max(max(ps), 1e-20) / 127, p_i8 = int(ps / psc + 0.5) (true division,
// truncation), then int32(p_i8 . v_i8) * psc.  The grouping of that
// quantization is part of the result: the port fixes it at 512 keys (or S
// when S <= 512), the TPU kernel's tile before its VMEM halving, which is
// not copied here.
//
// Design.  A thread-block cluster of R <= 8 blocks (the portable cluster
// size) per (b, kv-head g): grid (R, B * H_kv), 256 threads a block.  R is
// the plan's (ops/decode_attn.py:_attn_plan, from B, H_kv, S, the cache's
// type and the SM count, never from fill: the host does not sync).  The TPU grid's
// sequential S axis becomes a loop over the row's 512-key tiles; rank r of
// the cluster takes a contiguous share of each tile's valid keys (n valid
// keys, shares of 4 * ceil(n / 4R), so a quad of keys never straddles two
// ranks).  A block first loads q (its loads do not wait for the fill),
// then the fill, then issues its first copies.  Per tile:
//   1. scores: the rank's k rows arrive in a ring of slots in dynamic
//      shared memory by 16-byte cp.async (128 keys a slot where that is <=
//      24 KB, else 64; rows padded to an odd number of 16-byte chunks so a
//      quarter warp's reads meet no bank twice); THREADS / SUB lanes share a key,
//      each its neighbouring chunks, a shuffle tree over the live rows sums
//      them; q is broadcast from shared memory;
//   2. softmax: warp r owns query row r (rep <= 8 warps).  Each rank stores
//      its row maxima into every rank's shared memory (distributed shared
//      memory) before one cluster barrier, so every rank uses the tile's
//      own m_new and p keeps the one-block bits; in int8 mode the ranks
//      swap their ps maxima the same way, so psc and every p_i8 are the
//      one-block ones;
//   3. PV: the rank's v rows arrive in the same ring; thread (key group,
//      columns) walks every KG-th quad of keys, neighbouring threads on
//      neighbouring columns.  Float: two columns a thread, p four keys at a
//      time, the key groups summed in a fixed order.  int8: a word of four
//      columns a thread; the quad's four rows are transposed 4 x 4 (byte
//      permutes) into words of one column's four keys, each __dp4a'd
//      against the quad's four p_i8 (one word); the key groups' int32
//      partials meet by shared-memory atomics (exact in any order);
//   4. combine: each rank stores its partial and p sums into rank 0's
//      shared memory before one cluster barrier; rank 0 sums them in rank
//      order (int8: an integer sum, exact, times psc once), rescales its
//      accumulator by exp(m_prev - m_new) and adds.  Nothing is written into
//      a rank after the last tile's barrier, so no rank waits for another
//      at the end.  No workspace, no global atomics: a second call gives
//      the same bits, and an int8 acc and m are the same bits at any R.
// The ring's loads run ahead of its use: a tile's stages are its k slots,
// then its v slots, then the next tile's, and NBUF - 1 of them are in flight
// at once, so v's first slots land while the scores and the softmax run,
// and tile t+1's k slots while tile t's PV runs.  Only keys below the row's
// limit are copied; tiles past it are skipped (on those the TPU kernel's
// update is a no-op), so an idle slot (fill 0) reads nothing and returns
// acc 0, l 0, m -1e9.  The ring holds 32 KB / slot slots, 2 to 4 (bf16 D =
// 64 and 80: two 128-key slots of 18 and 22.5 KB; int8 D = 64: three of
// 10 KB), and the groups of <= 4 query rows take an instantiation whose
// registers allow 4 blocks an SM, so a split's blocks run in one wave (8
// rows: 2 an SM; a 2.6B block's 57.5 KB of shared memory allows 3).  Registers (-Xptxas -v,
// CUDA 12.8): 63-92 a thread for 4 rows, 8-20 bytes of spill in some int8
// and f32 instantiations at the 64-register cap; 112-128 for 8 rows.
//
// What bounds it: every valid key's k and v row is read once, plus scales,
// q and the output, so the bound is those bytes over 3.35 TB/s; the flops
// (4 * rep * D per key, ~3 a byte) are far below the CUDA cores' f32 rate,
// so no tensor core is needed.  What bounds this design is each block's
// chain of latencies: the fill's load before any copy, a wait, a barrier
// and the next copies' issue a slot, two or three cluster barriers a tile,
// the softmax's serial pass over the rank's keys in rep warps (the other
// warps idle), so a block of ~100 keys runs ~5-7 us (PERF.md's timeline).
// What it still leaves: the key shares follow each row's own fill, so a
// cluster's time is its longest row's, and R is one per launch (the plan
// cannot see the fills); the scores take 2-4 lanes a key and a shuffle
// tree; the float partials go through shared memory twice.
//
// Plain C interface for ctypes: decode_attn_launch returns the launch's
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 512;         // keys per tile (the int8 quantization group)
constexpr int MAX_REP = 8;
constexpr int MAX_RANKS = 8;      // the portable cluster size
constexpr int RING_BYTES = 32 * 1024;   // the ring's budget: 2 to 4 slots
constexpr float NEG = -1e9f;

// K6_CLOCKS (the timeline build of scripts/torch_attn_variants.py): each
// block's timeline, SM clock at
// points of its first tile (slots 0-11), the global timer at entry (12) and
// its keys of the first tile (13), read back by decode_attn_clocks
constexpr int MARKS = 14;
#ifdef K6_CLOCKS
constexpr int CLOCK_BLOCKS = 1 << 14;
__device__ long long k6_clocks[CLOCK_BLOCKS][MARKS];
__device__ __forceinline__ void mark(int i, bool first = true) {
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  if (first && threadIdx.x == 0 && blk < CLOCK_BLOCKS) {
    long long t;
    if (i == 0) {
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      k6_clocks[blk][12] = t;
    }
    k6_clocks[blk][i] = clock64();
  }
}
__device__ __forceinline__ void mark_keys(long long keys) {
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && blk < CLOCK_BLOCKS) k6_clocks[blk][13] = keys;
}
#else
__device__ __forceinline__ void mark(int, bool = true) {}
__device__ __forceinline__ void mark_keys(long long) {}
#endif

// p rounded to the cache's type before the PV product
template <typename T> __device__ __forceinline__ float round_to(float p);
template <> __device__ __forceinline__ float round_to<float>(float p) { return p; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

// The shapes of one instantiation: the ring's slots, the score lanes of a
// key, the PV's threads.  A slot is 128 keys where that is <= 24 KB (bf16
// rows of D <= 80, int8 rows), else 64; a key's score takes THREADS / SUB
// lanes, one pass a slot (each slot costs a wait, a barrier and the next
// copies' issue, so fewer, larger slots and fewer lanes a key were faster
// on the card: PERF.md).
template <typename T, int D, bool INT8> struct Layout {
  static constexpr int CN = Chunk<T>::N;         // elements of a 16-byte chunk
  static constexpr int CPR = D / CN;             // chunks of a row
  // keys of a slot
  static constexpr int SUB = 128 * (CPR | 1) * 16 <= 24 * 1024 ? 128 : 64;
  static constexpr int TPK = THREADS / SUB;      // score lanes of a key
  static constexpr int KPP = THREADS / TPK;      // keys of a score pass
  static constexpr int CPL = (CPR + TPK - 1) / TPK;  // chunks of a score lane
  // a slot row's stride in chunks: odd, so a quarter warp's 16-byte score
  // reads (thread t = TPK * key + lane, chunk key * RS + lane * CPL + i) meet
  // no bank twice.  Where CPL is odd, TPK * CPL (no padding) does too, and
  // fits 4 bf16 D = 80 blocks an SM, but was not faster (PERF.md)
  static constexpr int RS = CPR | 1;
  static constexpr int SLOT = SUB * RS * 16;     // bytes of a slot
  static constexpr int NBUF = RING_BYTES / SLOT < 2 ? 2
                              : RING_BYTES / SLOT > 4 ? 4 : RING_BYTES / SLOT;
  static constexpr int DPT = INT8 ? 4 : 2;       // PV columns of a thread
  static constexpr int TPR = D / DPT;            // PV threads of a row
  static constexpr int KG = THREADS / TPR;       // PV key groups
  static_assert(D % CN == 0 && D % DPT == 0 && D % 4 == 0, "head dim");
  static_assert(TPK >= 1 && TPK <= 32 && (TPK & (TPK - 1)) == 0, "score lanes");
  static_assert(KG >= 1 && KG * D <= DPT * THREADS, "PV threads");
  // float mode: the key groups' partials [KG][rep][D] reuse the score tile
  static_assert(INT8 || KG * D <= TILE, "key-group partials fit the scores");
};

// dynamic shared memory: the ring, the scores [rep][TILE] (f32), in int8
// mode p_i8 [rep][TILE] and the k / v scales [2][TILE] each (a pair of
// buffers by tile parity: the next tile's are copied while this one's are
// read), then every rank's PV partial [ranks][rep * D] (rank 0's is read)
template <typename T, int D, bool INT8>
__host__ __device__ constexpr size_t dyn_smem(int rep, int ranks) {
  return (size_t)Layout<T, D, INT8>::NBUF * Layout<T, D, INT8>::SLOT
         + (size_t)rep * TILE * 4 + (INT8 ? (size_t)rep * TILE + 4 * TILE * 4 : 0)
         + (size_t)ranks * rep * D * 4;
}

// two neighbouring columns d, d + 1 of a staged row, as f32
template <typename T>
__device__ __forceinline__ void load_pair(const unsigned char* row, int d,
                                          float& x, float& y);
template <>
__device__ __forceinline__ void load_pair<float>(const unsigned char* row, int d,
                                                 float& x, float& y) {
  const float2 f = *reinterpret_cast<const float2*>(row + 4 * d);
  x = f.x; y = f.y;
}
template <>
__device__ __forceinline__ void load_pair<__nv_bfloat16>(const unsigned char* row,
                                                         int d, float& x, float& y) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 2 * d);
  x = __uint_as_float(w << 16);
  y = __uint_as_float(w & 0xFFFF0000u);
}

struct Args {
  const void* q;
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
  bool q_f32;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  float scale;
};

// T: cache element type; INT8: T == int8_t (int8 mode); RMAX: the query
// rows of a group it takes (4: registers for 4 blocks an SM, so the plan's
// clusters run in one wave; 8: MAX_REP, 2 blocks an SM).
template <typename T, int D, bool INT8, int RMAX>
__global__ void __launch_bounds__(THREADS, RMAX <= 4 ? 4 : 2)
decode_attn_kernel(Args a) {
  using L = Layout<T, D, INT8>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float q_f[INT8 ? 1 : RMAX * D];
  __shared__ __align__(16) int q_i[INT8 ? RMAX * (D / 4) : 1];
  __shared__ float acc[RMAX * D];                // rank 0's accumulator
  __shared__ int part[INT8 ? RMAX * D : 1];      // the rank's int32 PV
  // written by every rank of the cluster (each into its own row)
  __shared__ float mx_all[MAX_RANKS][RMAX], psm_all[MAX_RANKS][RMAX];
  __shared__ float psum_all[MAX_RANKS][RMAX];
  __shared__ float m_s[RMAX], l_s[RMAX], alpha_s[RMAX], psc_s[RMAX];
  __shared__ float qss[RMAX];                    // q_scale * scale (int8)

  mark(0);
  // no rank writes into another before every rank has started: arrive now,
  // wait once this block is set up
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // a cluster barrier (release / acquire at cluster scope) costs ~0.5 us on
  // the card even for one block: a one-block cluster takes a block barrier
  // and its own shared memory
  auto cluster_sync = [&]() {
    if (R > 1) cluster.sync(); else __syncthreads();
  };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / a.H_kv;
  const int g = blockIdx.y % a.H_kv;
  const int rep = a.H / a.H_kv;
  const int rd = rep * D;
  const long long h0 = (long long)b * a.H + (long long)g * rep;  // first q row

  // q first, its loads not waiting for the fill: lane l of warp r holds
  // row r's values 4l .. 4l + 3
  const bool q_lane = warp < rep && lane < D / 4;
  float qv[4] = {0.f, 0.f, 0.f, 0.f};
  if (q_lane) load_q4(a.q, a.q_f32, (h0 + warp) * D + 4 * lane, qv);

  unsigned char* ring = smem;
  float* sc = reinterpret_cast<float*>(smem + L::NBUF * L::SLOT);
  int8_t* p8 = reinterpret_cast<int8_t*>(sc + rep * TILE);
  float* sks = reinterpret_cast<float*>(p8 + (INT8 ? rep * TILE : 0));
  float* svs = sks + 2 * TILE;
  // rank 0's copy of every rank's PV partial [R][rep * D] (f32 / int32 bits)
  int* part_all = reinterpret_cast<int*>(sks + (INT8 ? 4 * TILE : 0));

  int limit = min(a.fill[b], a.q_pos[b] + 1);
  limit = max(0, min(limit, a.S));
  const int n_tiles = (limit + TILE - 1) / TILE;
  const T* kb = reinterpret_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vb = reinterpret_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  const float* ksb = INT8 ? a.k_scale + b * a.ks_sb + g * a.ks_sh : nullptr;
  const float* vsb = INT8 ? a.v_scale + b * a.vs_sb + g * a.vs_sh : nullptr;

  // the rank's keys [lo, hi) of tile t, counted from the tile's first key
  auto share = [&](int t, int& lo, int& hi) {
    const int n = min(TILE, limit - t * TILE);
    const int per = 4 * ((n + 4 * R - 1) / (4 * R));
    lo = min(n, rank * per);
    hi = min(n, lo + per);
  };

  // The ring's producer: the next stage in the order (tile, k slots, then
  // v slots) into the next slot, one commit group a call (empty past the
  // last stage).  A v slot's rows past its last key up to its quad are
  // zero-filled; a tile's first k slot also brings the rank's k / v scales.
  int p_tile = 0, p_kind = 0, p_sub = 0, p_slot = 0;
  auto issue = [&]() {
    while (p_tile < n_tiles) {
      int lo, hi;
      share(p_tile, lo, hi);
      const int nsub = (hi - lo + L::SUB - 1) / L::SUB;
      if (p_sub < nsub) {
        const int j0 = p_tile * TILE + lo + p_sub * L::SUB;
        const int nk = min(L::SUB, hi - lo - p_sub * L::SUB);
        const int rows = p_kind ? (nk + 3) & ~3 : nk;
        const T* src = p_kind ? vb : kb;
        const long long ss = p_kind ? a.v_ss : a.k_ss;
        unsigned char* dst = ring + p_slot * L::SLOT;
        for (int i = tid; i < rows * L::CPR; i += THREADS) {
          const int r = i / L::CPR, c = i - r * L::CPR;
          const bool ok = r < nk;
          cp_async16(dst + (r * L::RS + c) * 16,
                     src + (ok ? (long long)(j0 + r) * ss + c * L::CN : 0),
                     ok ? 16 : 0);
        }
        if (INT8 && p_kind == 0 && p_sub == 0) {
          float* dk = sks + (p_tile & 1) * TILE;
          float* dv = svs + (p_tile & 1) * TILE;
          const int s0 = p_tile * TILE + lo;
          for (int i = tid; i < hi - lo; i += THREADS) {
            cp_async4(dk + i, ksb + s0 + i);
            cp_async4(dv + i, vsb + s0 + i);
          }
        }
        p_slot = p_slot + 1 == L::NBUF ? 0 : p_slot + 1;
        if (++p_sub == nsub) {
          p_sub = 0;
          p_tile += p_kind;
          p_kind ^= 1;
        }
        break;
      }
      p_kind = 0;   // no key of this rank in the tile
      p_sub = 0;
      ++p_tile;
    }
    cp_commit();
  };

  for (int i = 0; i < L::NBUF - 1; ++i) issue();
  mark(1);

  // q into shared memory; int8: quantized per row here with the bits of
  // ops/decode_attn.py:quantize_query on a CUDA tensor: PyTorch's CUDA
  // division by a scalar multiplies by its f32 reciprocal, so qs = amax *
  // fl(1 / 127); then IEEE division, round half to even, +-127
  if constexpr (INT8) {
    if (warp < rep) {
      float amax = fmaxf(fmaxf(fabsf(qv[0]), fabsf(qv[1])), fmaxf(fabsf(qv[2]), fabsf(qv[3])));
      amax = warp_max(amax);
      const float qs = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
      if (q_lane) {
        uint32_t w = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = max(-127, min(127, __float2int_rn(__fdiv_rn(qv[e], qs))));
          w |= (uint32_t)(qi & 0xFF) << (8 * e);
        }
        q_i[warp * (D / 4) + lane] = (int)w;
      }
      if (lane == 0) qss[warp] = qs * a.scale;
    }
  } else if (q_lane) {
#pragma unroll
    for (int e = 0; e < 4; ++e) q_f[warp * D + 4 * lane + e] = qv[e];
  }
  for (int i = tid; i < rd; i += THREADS) acc[i] = 0.f;
  if (tid < rep) { m_s[tid] = NEG; l_s[tid] = 0.f; }
  __syncthreads();
  cluster_wait();
  mark(2);

  // The ring's consumer: wait for the next stage, free the slot the last
  // one used (every thread is past it) for the stage NBUF - 1 ahead.
  int c_slot = 0;
  auto next_stage = [&]() -> const unsigned char* {
    cp_wait<L::NBUF - 2>();
    __syncthreads();
    issue();
    const unsigned char* slot = ring + c_slot * L::SLOT;
    c_slot = c_slot + 1 == L::NBUF ? 0 : c_slot + 1;
    return slot;
  };

  for (int t = 0; t < n_tiles; ++t) {
    int lo, hi;
    share(t, lo, hi);
    const int m = hi - lo;                 // the rank's keys of the tile
    const int nsub = (m + L::SUB - 1) / L::SUB;
    if (t == 0) mark_keys(m);
    const float* ks_t = sks + (t & 1) * TILE;
    const float* vs_t = svs + (t & 1) * TILE;

    // ---- 1. scores: TPK lanes a key, each its CPL neighbouring chunks of
    // the row, KPP keys a pass
    for (int sub = 0; sub < nsub; ++sub) {
      const unsigned char* slot = next_stage();
      mark(3, t == 0 && sub == 0);
      const int nk = min(L::SUB, m - sub * L::SUB);
      for (int base = 0; base < nk; base += L::KPP) {
        const int kk = base + tid / L::TPK, s = tid % L::TPK;
        const unsigned char* row = slot + kk * L::RS * 16;
        const int j = sub * L::SUB + kk;
        if constexpr (INT8) {
          int dot[RMAX];
#pragma unroll
          for (int r = 0; r < RMAX; ++r) dot[r] = 0;
          if (kk < nk) {
#pragma unroll
            for (int i = 0; i < L::CPL; ++i) {
              const int c = s * L::CPL + i;
              if (c < L::CPR) {
                const int4 kc = *reinterpret_cast<const int4*>(row + 16 * c);
                const int kw[4] = {kc.x, kc.y, kc.z, kc.w};
#pragma unroll
                for (int r = 0; r < RMAX; ++r) {
                  if (r < rep) {
                    const int4 qw = *reinterpret_cast<const int4*>(q_i + r * (D / 4) + 4 * c);
                    dot[r] = __dp4a(kw[0], qw.x, dot[r]);
                    dot[r] = __dp4a(kw[1], qw.y, dot[r]);
                    dot[r] = __dp4a(kw[2], qw.z, dot[r]);
                    dot[r] = __dp4a(kw[3], qw.w, dot[r]);
                  }
                }
              }
            }
          }
#pragma unroll
          for (int o = 1; o < L::TPK; o <<= 1) {
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
              if (r < rep) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
          }
          if (kk < nk) {
            const float ks = ks_t[j];
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
              if (r < rep && r % L::TPK == s) sc[r * TILE + j] = (float)dot[r] * qss[r] * ks;
          }
        } else {
          constexpr int CN = L::CN;
          float dot[RMAX];
#pragma unroll
          for (int r = 0; r < RMAX; ++r) dot[r] = 0.f;
          if (kk < nk) {
#pragma unroll
            for (int i = 0; i < L::CPL; ++i) {
              const int c = s * L::CPL + i;
              if (c < L::CPR) {
                float kf[CN];
                Chunk<T>::load(reinterpret_cast<const T*>(row) + CN * c, kf);
#pragma unroll
                for (int r = 0; r < RMAX; ++r) {
                  if (r < rep) {
#pragma unroll
                    for (int e = 0; e < CN; ++e)
                      dot[r] = fmaf(q_f[r * D + CN * c + e], kf[e], dot[r]);
                  }
                }
              }
            }
          }
#pragma unroll
          for (int o = 1; o < L::TPK; o <<= 1) {
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
              if (r < rep) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
          }
          if (kk < nk) {
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
              if (r < rep && r % L::TPK == s) sc[r * TILE + j] = dot[r] * a.scale;
          }
        }
      }
    }
    __syncthreads();
    mark(4, t == 0);

    // ---- 2. online softmax: warp r owns query row r.  Each rank stores its
    // row maxima (and, int8, its ps maxima) into every rank, its p sums into
    // rank 0, then one cluster barrier; every rank reads them locally.
    if (warp < rep) {
      const float* row = sc + warp * TILE;
      float tmax = NEG;
      for (int j = lane; j < m; j += 32) tmax = fmaxf(tmax, row[j]);
      tmax = warp_max(tmax);
      if (lane < R) *in_rank(cluster, R, &mx_all[rank][warp], lane) = tmax;
    }
    cluster_sync();   // every rank's row maxima (and the last tile's reads done)
    mark(5, t == 0);
    if constexpr (INT8) {
      for (int i = tid; i < rd; i += THREADS) part[i] = 0;
    }
    if (warp < rep) {
      const int r = warp;
      float* row = sc + r * TILE;
      float tmax = NEG;
      for (int rr = 0; rr < R; ++rr) tmax = fmaxf(tmax, mx_all[rr][r]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, tmax);
      float ps_sum = 0.f, pmax = 0.f;
      for (int j = lane; j < m; j += 32) {
        const float p = expf(row[j] - m_new);
        ps_sum += p;
        if constexpr (INT8) {
          const float ps = p * vs_t[j];
          pmax = fmaxf(pmax, ps);
          row[j] = ps;
        } else {
          row[j] = round_to<T>(p);
        }
      }
      if constexpr (!INT8) {
        for (int j = m + lane; j < ((m + 3) & ~3); j += 32) row[j] = 0.f;
      }
      ps_sum = warp_sum(ps_sum);
      if constexpr (INT8) {
        pmax = warp_max(pmax);
        if (lane < R) *in_rank(cluster, R, &psm_all[rank][r], lane) = pmax;
      }
      if (lane == 0) {
        *in_rank(cluster, R, &psum_all[rank][r], 0) = ps_sum;
        alpha_s[r] = expf(m_prev - m_new);
        m_s[r] = m_new;
      }
    }
    if constexpr (INT8) {
      cluster_sync();   // every rank's ps maxima
      if (warp < rep) {
        const int r = warp;
        const float* row = sc + r * TILE;
        float pmax = 0.f;
        for (int rr = 0; rr < R; ++rr) pmax = fmaxf(pmax, psm_all[rr][r]);
        const float psc = fmaxf(pmax, 1e-20f) / 127.0f;
        for (int j = lane; j < ((m + 3) & ~3); j += 32)
          p8[r * TILE + j] = j < m ? (int8_t)(int)(row[j] / psc + 0.5f) : (int8_t)0;
        if (lane == 0) psc_s[r] = psc;
      }
    }

    // ---- 3. PV: thread (key group kg, columns), a slot at a time
    mark(6, t == 0);
    int* to0 = in_rank(cluster, R, part_all, 0) + rank * rd;   // rank 0's row
    {
      const int cw = tid % L::TPR, kg = tid / L::TPR;
      if constexpr (INT8) {
        int ip[RMAX][4];
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) ip[r][c] = 0;
        for (int sub = 0; sub < nsub; ++sub) {
          const unsigned char* slot = next_stage();
          mark(7, t == 0 && sub == 0);
          const int nq = (min(L::SUB, m - sub * L::SUB) + 3) >> 2;
          for (int qd = kg; kg < L::KG && qd < nq; qd += L::KG) {
            const unsigned char* r0 = slot + 4 * qd * L::RS * 16 + 4 * cw;
            uint32_t t4[4];
            transpose4(*reinterpret_cast<const uint32_t*>(r0),
                       *reinterpret_cast<const uint32_t*>(r0 + L::RS * 16),
                       *reinterpret_cast<const uint32_t*>(r0 + 2 * L::RS * 16),
                       *reinterpret_cast<const uint32_t*>(r0 + 3 * L::RS * 16), t4);
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
              if (r < rep) {
                const int pw = *reinterpret_cast<const int*>(p8 + r * TILE + sub * L::SUB + 4 * qd);
#pragma unroll
                for (int c = 0; c < 4; ++c) ip[r][c] = __dp4a((int)t4[c], pw, ip[r][c]);
              }
            }
          }
        }
        // the key groups: integer atomics (exact in any order)
        if (kg < L::KG && nsub > 0) {
#pragma unroll
          for (int r = 0; r < RMAX; ++r)
            if (r < rep) {
#pragma unroll
              for (int c = 0; c < 4; ++c) atomicAdd(&part[r * D + 4 * cw + c], ip[r][c]);
            }
        }
        __syncthreads();
        for (int i = tid; i < rd; i += THREADS) to0[i] = part[i];
      } else {
        float fp[RMAX][2];
#pragma unroll
        for (int r = 0; r < RMAX; ++r) fp[r][0] = fp[r][1] = 0.f;
        for (int sub = 0; sub < nsub; ++sub) {
          const unsigned char* slot = next_stage();
          mark(7, t == 0 && sub == 0);
          const int nq = (min(L::SUB, m - sub * L::SUB) + 3) >> 2;
          for (int qd = kg; kg < L::KG && qd < nq; qd += L::KG) {
            float vx[4], vy[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              load_pair<T>(slot + (4 * qd + e) * L::RS * 16, 2 * cw, vx[e], vy[e]);
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
              if (r < rep) {
                const float4 p = *reinterpret_cast<const float4*>(sc + r * TILE + sub * L::SUB + 4 * qd);
                const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  fp[r][0] = fmaf(pe[e], vx[e], fp[r][0]);
                  fp[r][1] = fmaf(pe[e], vy[e], fp[r][1]);
                }
              }
            }
          }
        }
        // the key groups in order, through the score tile (free now)
        __syncthreads();
        float* red = sc;
        if (kg < L::KG) {
#pragma unroll
          for (int r = 0; r < RMAX; ++r)
            if (r < rep)
              *reinterpret_cast<float2*>(red + (kg * rep + r) * D + 2 * cw) =
                  make_float2(fp[r][0], fp[r][1]);
        }
        __syncthreads();
        for (int i = tid; i < rd; i += THREADS) {
          const int r = i / D, d = i - r * D;
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < L::KG; ++k) s += red[(k * rep + r) * D + d];
          to0[i] = __float_as_int(s);
        }
      }
    }

    // ---- 4. combine: rank 0 sums the ranks' partials in rank order
    mark(8, t == 0);
    cluster_sync();   // every rank's partials and p sums are in rank 0
    mark(9, t == 0);
    if (rank == 0) {
      for (int i = tid; i < rd; i += THREADS) {
        const int r = i / D;
        float pv;
        if constexpr (INT8) {
          int s = 0;
          for (int rr = 0; rr < R; ++rr) s += part_all[rr * rd + i];
          pv = (float)s * psc_s[r];
        } else {
          pv = 0.f;
          for (int rr = 0; rr < R; ++rr) pv += __int_as_float(part_all[rr * rd + i]);
        }
        acc[i] = acc[i] * alpha_s[r] + pv;
      }
      if (tid < rep) {
        float s = 0.f;
        for (int rr = 0; rr < R; ++rr) s += psum_all[rr][tid];
        l_s[tid] = l_s[tid] * alpha_s[tid] + s;
      }
    }
    // the next writes into another rank's shared memory (its row maxima,
    // then partials and p sums) come after the next tile's first cluster
    // barrier, which rank 0 reaches only once it has read these; after the
    // last tile nothing is written into a rank, so none waits for another
  }
  mark(10);

  if (rank == 0) {
    __syncthreads();
    for (int i = tid; i < rd; i += THREADS) {
      const int r = i / D;
      a.out[h0 * D + i] = a.out_m ? acc[i] : acc[i] / fmaxf(l_s[r], 1e-20f);
    }
    if (a.out_m && tid < rep) {
      a.out_m[h0 + tid] = m_s[tid];
      a.out_l[h0 + tid] = l_s[tid];
    }
  }
  mark(11);
}

template <typename T, int D, bool INT8, int RMAX>
cudaError_t launch(const Args& a, int B, int ranks, cudaStream_t st) {
  auto kernel = decode_attn_kernel<T, D, INT8, RMAX>;
  const size_t smem = dyn_smem<T, D, INT8>(a.H / a.H_kv, ranks);
  // static + dynamic past 48 KB needs the opt-in (the static part read once)
  static const size_t static_smem = [&] {
    cudaFuncAttributes fa = {};
    return cudaFuncGetAttributes(&fa, kernel) == cudaSuccess ? fa.sharedSizeBytes
                                                             : (size_t)48 * 1024;
  }();
  if (static_smem + smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, B * a.H_kv, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T, bool INT8, int RMAX>
cudaError_t launch_d(const Args& a, int B, int D, int ranks, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64, INT8, RMAX>(a, B, ranks, st);
    case 80: return launch<T, 80, INT8, RMAX>(a, B, ranks, st);
    case 128: return launch<T, 128, INT8, RMAX>(a, B, ranks, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool INT8>
cudaError_t launch_rep(const Args& a, int B, int D, int ranks, cudaStream_t st) {
  return a.H / a.H_kv <= 4 ? launch_d<T, INT8, 4>(a, B, D, ranks, st)
                           : launch_d<T, INT8, MAX_REP>(a, B, D, ranks, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q in the cache's type), 2 = int8 (q bf16 or f32
// as q_f32 says, quantized per (b, h) row in the kernel; k_scale / v_scale
// required).  ranks: the cluster's blocks a (b, kv head), 1..8 (the plan's).
// out_m / out_l null -> normalised output.  Strides are in elements.
extern "C" int decode_attn_launch(
    const void* q, int q_f32, const void* k, const void* v,
    const float* k_scale, const float* v_scale, const int* fill,
    const int* q_pos, float* out, float* out_m, float* out_l, int B, int H,
    int H_kv, int S, int D, int dtype, int ranks, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long ks_sb, long long ks_sh, long long vs_sb,
    long long vs_sh, float scale, void* stream) {
  if (B <= 0 || H_kv <= 0 || H % H_kv || H / H_kv > MAX_REP) return cudaErrorInvalidValue;
  if ((long long)B * H_kv > 65535 || ranks < 1 || ranks > MAX_RANKS) return cudaErrorInvalidValue;
  if ((out_m == nullptr) != (out_l == nullptr)) return cudaErrorInvalidValue;
  if (dtype != 2 && (q_f32 != 0) != (dtype == 0)) return cudaErrorInvalidValue;
  Args a{q, k, v, k_scale, v_scale, fill, q_pos, out, out_m, out_l,
         H, H_kv, S, q_f32 != 0, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb,
         ks_sh, vs_sb, vs_sh, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_rep<float, false>(a, B, D, ranks, st);
    case 1: return (int)launch_rep<__nv_bfloat16, false>(a, B, D, ranks, st);
    case 2:
      if (!k_scale || !v_scale) return cudaErrorInvalidValue;
      return (int)launch_rep<int8_t, true>(a, B, D, ranks, st);
    default: return cudaErrorInvalidValue;
  }
}

#ifdef K6_CLOCKS
// the first `blocks` blocks' timelines (MARKS int64 each) into host
// memory, then zeros in their place
extern "C" int decode_attn_clocks(long long* host, int blocks) {
  const size_t bytes = sizeof(long long) * MARKS * (size_t)blocks;
  cudaError_t e = cudaMemcpyFromSymbol(host, k6_clocks, bytes);
  if (e != cudaSuccess) return (int)e;
  void* dev = nullptr;
  e = cudaGetSymbolAddress(&dev, k6_clocks);
  return (int)(e != cudaSuccess ? e : cudaMemset(dev, 0, bytes));
}
#endif
