// Single-query flash-decode attention in f32 for Hopper (sm_90a).
//
// Replaces miotts_tpu/ops/decode_attn.py:_kernel (reached through
// decode_attention), the attention of the LFM2 hybrid decode: every
// attention layer writes the step's k / v into the cache first and then
// reads each valid key of the row through this kernel.
//
// Contract (the JAX one):
//   q       [B, H, D]            bf16 / f32 (upcast here, as the TPU kernel
//                                upcasts its block)
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
// NOT rounded before the PV product, so nothing depends on how the keys
// are grouped: the split below changes only the order of f32 sums.
//
// Design.  A thread-block cluster of R <= 8 blocks (the portable cluster
// size) per (b, kv-head g): grid (R, B * H_kv), 256 threads a block; the rep
// = H / H_kv query rows of the group share every k / v row read.  R is the
// plan's (ops/decode_attn.py:_single_plan, from B, H_kv, S and the SM
// count, never from fill: the host does not sync).  Rank r takes the
// contiguous share [r * per, (r + 1) * per) of the row's `limit` valid keys,
// per = ceil(limit / R), and keeps its own flash state (m_r, l_r, acc_r)
// over it.  A block loads q first (its loads do not wait for the fill),
// then the fill, then issues its copies:
//   - the share's k rows (with the int8 scales) and v rows arrive in shared
//     memory by 16-byte cp.async, in chunks of SUB keys (<= 16 KB of k
//     rows, <= 256 keys), NCH = 2 chunks in flight: a share of up to 2 * SUB
//     keys (256 bf16 D = 64 keys) is all in flight at once, and v lands while
//     the scores and the softmax run; a longer share walks the ring, the
//     chunk after next issued once every thread has left the last one;
//   - scores: TPK lanes a key (each its neighbouring 16-byte chunks of the
//     row, q broadcast from shared memory), a shuffle tree over the rows;
//     all RMAX rows of the instantiation without a branch a row (q's rows
//     past rep are zeros), so the rows' loads and shuffles overlap; each
//     thread keeps its rows' running maxima, one warp reduction and a
//     barrier give the chunk's;
//   - softmax: every thread takes p = exp(s - m_new) of some (row, key);
//   - PV: thread (key group, row, 16-byte chunk of columns) walks every
//     KG-th key of the chunk with 16-byte loads of v, its accumulators and
//     its row's p sum (l) in registers, rescaled by exp(m_prev - m_new) a
//     chunk (int8: p * v_scale weights the values, l sums p);
//   - the key groups meet once, in order, through shared memory; each rank
//     with r > 0 then pushes (m_r, l_r, acc_r) into rank 0's shared memory
//     (distributed shared memory; the cluster's split start barrier, its
//     arrival at entry, is waited on just before the first push), one
//     cluster barrier, and rank 0 combines in rank order: m = max m_r, l =
//     sum exp(m_r - m) l_r, acc = sum exp(m_r - m) acc_r.  An empty share
//     gives m_r = -1e9, l_r = 0, acc_r = 0.  R = 1 takes no cluster barrier.
// No workspace, no global atomics: a second call gives the same bits.  Keys
// past the row's limit are never read (the TPU kernel skips their tiles), so
// a row with fill 0 reads nothing and writes 0.
//
// What bounds it: the bytes of every valid key's k and v row (plus its
// scales), q and the output; the 4 * rep * D f32 flops per key are far
// below the card's f32 rate.  At the LFM2-1.2B decode shape (B = 1, H =
// 32 / 8, D = 64, ~190 valid keys, bf16) that is ~0.4 MB, ~0.1 us at 3.35
// TB/s: the time is one block's chain of latencies, which the split
// shortens by cutting each block's keys R-fold over up to 64 of the 132
// SMs.  What is left of the chain (the timeline build, PERF.md): the fill's
// load before the first copy, the copies' round trip, four block barriers,
// and the one cluster barrier, which alone costs about as much as the
// scores, softmax and PV of a 24-key share together.  Registers: at most
// 128 a thread (two blocks an SM where R = 1 leaves more blocks than SMs;
// the plan keeps a split's blocks to one an SM).
//
// Plain C interface for ctypes: decode_attn_single_launch returns the
// launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;
constexpr int MAX_RANKS = 8;            // the portable cluster size
constexpr int CHUNK_BYTES = 16 * 1024;  // a chunk's k rows at most
constexpr int MAX_SUB = 256;            // a chunk's keys at most
constexpr int NCH = 2;                  // chunks in the ring
constexpr float NEG = -1e9f;

// K5_CLOCKS (the timeline build of scripts/torch_k5_ranks.py): each block's
// SM clock at the marks of its first chunk (slots 0-9: entry, copies
// issued, k landed, scores, p and v landed, PV, key groups summed, start
// barrier waited, cluster barrier passed, exit), its keys (10) and the
// global timer at entry (11), read back by decode_attn_single_clocks
constexpr int MARKS = 12;
#ifdef K5_CLOCKS
constexpr int CLOCK_BLOCKS = 1 << 12;
__device__ long long k5_clocks[CLOCK_BLOCKS][MARKS];
__device__ __forceinline__ void mark(int i, bool on = true) {
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  if (on && threadIdx.x == 0 && blk < CLOCK_BLOCKS) {
    if (i == 0) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      k5_clocks[blk][11] = t;
    }
    k5_clocks[blk][i] = clock64();
  }
}
__device__ __forceinline__ void mark_keys(long long keys) {
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && blk < CLOCK_BLOCKS) k5_clocks[blk][10] = keys;
}
#else
__device__ __forceinline__ void mark(int, bool = true) {}
__device__ __forceinline__ void mark_keys(long long) {}
#endif

template <typename T> struct IsInt8 { static constexpr bool value = false; };
template <> struct IsInt8<int8_t> { static constexpr bool value = true; };

__host__ __device__ constexpr int floor_pow2(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// The shapes of one instantiation: a chunk of SUB keys (a power of two: <=
// CHUNK_BYTES of k rows, <= MAX_SUB keys), TPK score lanes a key (<= 8,
// CPL neighbouring 16-byte chunks each), a ring slot holding a chunk's k
// rows, v rows and (int8) k / v scales.
template <typename T, int D> struct Layout {
  static constexpr bool INT8 = IsInt8<T>::value;
  static constexpr int CN = Chunk<T>::N;         // elements of a 16-byte chunk
  static constexpr int CPR = D / CN;             // chunks of a row
  static constexpr int ROWB = D * (int)sizeof(T);
  static constexpr int SUB = floor_pow2(CHUNK_BYTES / ROWB < MAX_SUB
                                        ? CHUNK_BYTES / ROWB : MAX_SUB);
  static constexpr int TPK = floor_pow2(CPR) < 8 ? floor_pow2(CPR) : 8;
  static constexpr int CPL = (CPR + TPK - 1) / TPK;
  static constexpr int KPP = THREADS / TPK;      // keys of a score pass
  static constexpr int V_OFF = SUB * ROWB;       // v rows in a slot
  static constexpr int S_OFF = 2 * SUB * ROWB;   // k / v scales in a slot
  static constexpr int SLOT = S_OFF + (INT8 ? 2 * SUB * 4 : 0);
  static_assert(D % CN == 0 && D % 4 == 0, "head dim");
};

// dynamic shared memory: the ring, the scores [RMAX][SUB] (then p), the key
// groups' partials [THREADS * CN] and p sums [THREADS], and (R > 1) every
// rank's accumulator [R][rep * D] (rank 0's is read)
template <typename T, int D, int RMAX>
__host__ __device__ constexpr size_t dyn_smem(int rep, int ranks) {
  using L = Layout<T, D>;
  return (size_t)NCH * L::SLOT + (size_t)RMAX * L::SUB * 4
         + (size_t)THREADS * L::CN * 4 + (size_t)THREADS * 4
         + (ranks > 1 ? (size_t)ranks * rep * D * 4 : 0);
}

// v[r] of a per-thread array at a row index known only at run time, without
// indexing registers dynamically (a select chain)
template <int RMAX>
__device__ __forceinline__ float pick(const float (&v)[RMAX], int r) {
  float x = v[0];
#pragma unroll
  for (int i = 1; i < RMAX; ++i) x = r == i ? v[i] : x;
  return x;
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
  int H, H_kv, S;
  bool q_f32;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  float scale;
};

// T: the cache's element type (int8_t: dequantize by the scales); RMAX: the
// query rows of a group it takes (4 or MAX_REP).
template <typename T, int D, int RMAX>
__global__ void __launch_bounds__(THREADS, 2) decode_attn_single_kernel(Args a) {
  using L = Layout<T, D>;
  constexpr bool INT8 = L::INT8;
  constexpr int CN = L::CN, CPR = L::CPR, ROWB = L::ROWB, SUB = L::SUB;
  constexpr int TPK = L::TPK, CPL = L::CPL, KPP = L::KPP;
  static_assert(RMAX * D / 4 <= THREADS, "q: one 4-value load a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float q_s[RMAX * D];
  __shared__ __align__(16) float wmax[WARPS][RMAX];   // each warp's row maxima
  // written by every rank into rank 0 (each into its own row)
  __shared__ float comb_m[MAX_RANKS][RMAX], comb_l[MAX_RANKS][RMAX];

  mark(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  if (R > 1) cluster_arrive_relaxed();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / a.H_kv;
  const int g = blockIdx.y % a.H_kv;
  const int rep = a.H / a.H_kv;
  const int rd = rep * D;
  const long long h0 = (long long)b * a.H + (long long)g * rep;  // first q row

  // q first, its loads not waiting for the fill: thread t holds values
  // 4t .. 4t + 3 of the group's rows
  const bool q_lane = 4 * tid < rd;
  float qv[4] = {0.f, 0.f, 0.f, 0.f};
  if (q_lane) load_q4(a.q, a.q_f32, h0 * D + 4 * tid, qv);

  unsigned char* ring = smem;
  float* sc = reinterpret_cast<float*>(smem + NCH * L::SLOT);
  float* red = sc + RMAX * SUB;                  // [KG][rd]
  float* lred = red + THREADS * CN;              // [KG][rep]
  float* comb_acc = lred + THREADS;              // [R][rd], rank 0's read

  int limit = min(a.fill[b], a.q_pos[b] + 1);
  limit = max(0, min(limit, a.S));
  // the rank's share [lo, hi) of the row's valid keys
  const int per = (limit + R - 1) / R;
  const int lo = min(limit, rank * per);
  const int hi = min(limit, lo + per);
  const int n_keys = hi - lo;
  const int n_chunks = (n_keys + SUB - 1) / SUB;
  const T* kb = reinterpret_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh + lo * a.k_ss;
  const T* vb = reinterpret_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh + lo * a.v_ss;
  const float* ksb = INT8 ? a.k_scale + b * a.ks_sb + g * a.ks_sh + lo : nullptr;
  const float* vsb = INT8 ? a.v_scale + b * a.vs_sb + g * a.vs_sh + lo : nullptr;

  // chunk j of the share into slot j % NCH: two commit groups, its k rows
  // (with both scales), then its v rows; empty past the last chunk
  auto issue = [&](int j) {
    unsigned char* slot = ring + (j % NCH) * L::SLOT;
    const int j0 = j * SUB;
    const int nk = j < n_chunks ? min(SUB, n_keys - j0) : 0;
    for (int i = tid; i < nk * CPR; i += THREADS) {
      const int r = i / CPR, c = i - r * CPR;
      cp_async16(slot + r * ROWB + c * 16, kb + (long long)(j0 + r) * a.k_ss + c * CN);
    }
    if constexpr (INT8) {
      float* s = reinterpret_cast<float*>(slot + L::S_OFF);
      for (int i = tid; i < nk; i += THREADS) {
        cp_async4(s + i, ksb + j0 + i);
        cp_async4(s + SUB + i, vsb + j0 + i);
      }
    }
    cp_commit();
    for (int i = tid; i < nk * CPR; i += THREADS) {
      const int r = i / CPR, c = i - r * CPR;
      cp_async16(slot + L::V_OFF + r * ROWB + c * 16,
                 vb + (long long)(j0 + r) * a.v_ss + c * CN);
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < NCH; ++j) issue(j);
  mark(1);
  mark_keys(n_keys);

  // q's rows past rep are zeros: the scores below run all RMAX rows with
  // no branch a row, so the rows' loads and shuffles overlap (a branch a
  // row runs them one after another); rows past rep are never read out
  if (4 * tid < RMAX * D)
    *reinterpret_cast<float4*>(q_s + 4 * tid) = make_float4(qv[0], qv[1], qv[2], qv[3]);

  // the PV threads: (key group kg, row r, chunk of columns c), KG groups of
  // CPR * rep threads
  const int G = CPR * rep;
  const int KG = THREADS / G;
  const bool pv_lane = tid < KG * G;
  const int pc = tid % CPR, pr = (tid / CPR) % rep, kg = tid / G;
  float acc[CN];
#pragma unroll
  for (int e = 0; e < CN; ++e) acc[e] = 0.f;
  float lsum = 0.f;
  float m_run[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) m_run[r] = NEG;

  for (int j = 0; j < n_chunks; ++j) {
    const unsigned char* slot = ring + (j % NCH) * L::SLOT;
    const int nk = min(SUB, n_keys - j * SUB);
    // this chunk's k rows and scales have landed (and, at j = 0, q is in
    // shared memory; at j > 0 every thread has left chunk j - 1, whose slot
    // takes chunk j + NCH - 1)
    if (j == 0) cp_wait<2 * NCH - 1>(); else cp_wait<2 * NCH - 3>();
    __syncthreads();
    mark(2, j == 0);
    if (j > 0) issue(j + NCH - 1);
    const float* ks = reinterpret_cast<const float*>(slot + L::S_OFF);

    // ---- scores: TPK lanes a key, each its CPL neighbouring chunks, KPP
    // keys a pass; each thread's running maxima of the rows
    float tmax[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) tmax[r] = NEG;
    for (int base = 0; base < nk; base += KPP) {
      const int kk = base + tid / TPK, s = tid % TPK;
      float dot[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) dot[r] = 0.f;
      if (kk < nk) {
        const T* row = reinterpret_cast<const T*>(slot + kk * ROWB);
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = s * CPL + i;
          if (c < CPR) {
            float kf[CN];
            Chunk<T>::load(row + CN * c, kf);
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
              const float4* q4 = reinterpret_cast<const float4*>(q_s + r * D + CN * c);
#pragma unroll
              for (int e4 = 0; e4 < CN / 4; ++e4) {
                const float4 qq = q4[e4];
                dot[r] = fmaf(qq.x, kf[4 * e4], dot[r]);
                dot[r] = fmaf(qq.y, kf[4 * e4 + 1], dot[r]);
                dot[r] = fmaf(qq.z, kf[4 * e4 + 2], dot[r]);
                dot[r] = fmaf(qq.w, kf[4 * e4 + 3], dot[r]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int o = 1; o < TPK; o <<= 1) {
#pragma unroll
        for (int r = 0; r < RMAX; ++r) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
      }
      if (kk < nk) {
        const float ksc = INT8 ? ks[kk] : 1.f;
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          const float sv = INT8 ? dot[r] * ksc * a.scale : dot[r] * a.scale;
          tmax[r] = fmaxf(tmax[r], sv);
          if (r < rep && r % TPK == s) sc[r * SUB + kk] = sv;
        }
      }
    }
    // the warp's row maxima (a key's TPK lanes hold the same values)
#pragma unroll
    for (int o = TPK; o < 32; o <<= 1) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], o));
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r) wmax[warp][r] = tmax[r];
    }
    __syncthreads();
    mark(3, j == 0);

    // ---- softmax: the chunk's row maxima, p = exp(s - m_new) by every
    // thread, THREADS / RMAX threads a row
    float m_new[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      float t = m_run[r];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t = fmaxf(t, wmax[w][r]);
      m_new[r] = t;
    }
    {
      constexpr int TPR = THREADS / RMAX;
      const int r = tid / TPR;
      if (r < rep) {
        const float m = pick<RMAX>(m_new, r);
        for (int kk = tid % TPR; kk < nk; kk += TPR)
          sc[r * SUB + kk] = expf(sc[r * SUB + kk] - m);
      }
    }
    cp_wait<2 * NCH - 2>();   // this chunk's v rows have landed
    __syncthreads();
    mark(4, j == 0);

    // ---- PV: the thread's row and 16 bytes of columns over every KG-th key
    if (pv_lane) {
      const float alpha = expf(pick<RMAX>(m_run, pr) - pick<RMAX>(m_new, pr));
#pragma unroll
      for (int e = 0; e < CN; ++e) acc[e] *= alpha;
      lsum *= alpha;
      const float* prow = sc + pr * SUB;
      const T* vrow = reinterpret_cast<const T*>(slot + L::V_OFF) + CN * pc;
      for (int kk = kg; kk < nk; kk += KG) {
        const float p = prow[kk];
        const float w = INT8 ? p * ks[SUB + kk] : p;
        float vf[CN];
        Chunk<T>::load(vrow + (long long)kk * D, vf);
#pragma unroll
        for (int e = 0; e < CN; ++e) acc[e] = fmaf(w, vf[e], acc[e]);
        lsum += p;
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) m_run[r] = m_new[r];
    mark(5, j == 0);
    // the next chunk's first shared writes (its scores) come after its
    // first barrier, which every thread reaches only once it has left this
    // chunk's PV
  }

  // ---- the key groups, in order: [KG][rd] partials and [KG][rep] p sums
  if (pv_lane) {
    float4* dst = reinterpret_cast<float4*>(red + kg * rd + pr * D + CN * pc);
#pragma unroll
    for (int e4 = 0; e4 < CN / 4; ++e4)
      dst[e4] = make_float4(acc[4 * e4], acc[4 * e4 + 1], acc[4 * e4 + 2], acc[4 * e4 + 3]);
    if (pc == 0) lred[kg * rep + pr] = lsum;
  }
  __syncthreads();
  mark(6);

  // ---- one combine: the ranks' states meet in rank 0, in rank order
  if (R > 1) cluster_wait();   // every rank has started: pushes may begin
  mark(7);
  float* acc0 = in_rank(cluster, R, comb_acc, 0) + rank * rd;
  for (int i = tid; i < rd; i += THREADS) {
    const int r = i / D;
    float s = 0.f, l = 0.f;
    for (int k = 0; k < KG; ++k) s += red[k * rd + i];
    for (int k = 0; k < KG; ++k) l += lred[k * rep + r];
    if (R == 1) {
      a.out[h0 * D + i] = s / fmaxf(l, 1e-20f);
    } else {
      acc0[i] = s;
      if (i - r * D == 0) {
        *in_rank(cluster, R, &comb_m[rank][r], 0) = pick<RMAX>(m_run, r);
        *in_rank(cluster, R, &comb_l[rank][r], 0) = l;
      }
    }
  }
  if (R > 1) {
    cluster.sync();   // every rank's state is in rank 0
    mark(8);
    if (rank == 0) {
      for (int i = tid; i < rd; i += THREADS) {
        const int r = i / D;
        float m = NEG;
        for (int rr = 0; rr < R; ++rr) m = fmaxf(m, comb_m[rr][r]);
        float l = 0.f, s = 0.f;
        for (int rr = 0; rr < R; ++rr) {
          const float w = expf(comb_m[rr][r] - m);
          l += w * comb_l[rr][r];
          s += w * comb_acc[rr * rd + i];
        }
        a.out[h0 * D + i] = s / fmaxf(l, 1e-20f);
      }
    }
  }
  mark(9);
}

template <typename T, int D, int RMAX>
cudaError_t launch(const Args& a, int B, int ranks, cudaStream_t st) {
  auto kernel = decode_attn_single_kernel<T, D, RMAX>;
  const size_t smem = dyn_smem<T, D, RMAX>(a.H / a.H_kv, ranks);
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

template <typename T, int RMAX>
cudaError_t launch_d(const Args& a, int B, int D, int ranks, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64, RMAX>(a, B, ranks, st);
    case 80: return launch<T, 80, RMAX>(a, B, ranks, st);
    case 128: return launch<T, 128, RMAX>(a, B, ranks, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_rep(const Args& a, int B, int D, int ranks, cudaStream_t st) {
  return a.H / a.H_kv <= 4 ? launch_d<T, 4>(a, B, D, ranks, st)
                           : launch_d<T, MAX_REP>(a, B, D, ranks, st);
}

}  // namespace

// q_f32: q is f32 (else bf16).  dtype: 0 = f32, 1 = bf16, 2 = int8 (k_scale /
// v_scale required).  ranks: the cluster's blocks a (b, kv head), 1..8 (the
// plan's).  Strides are in elements.
extern "C" int decode_attn_single_launch(
    const void* q, int q_f32, const void* k, const void* v,
    const float* k_scale, const float* v_scale, const int* fill,
    const int* q_pos, float* out, int B, int H, int H_kv, int S, int D,
    int dtype, int ranks, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long ks_sb,
    long long ks_sh, long long vs_sb, long long vs_sh, float scale,
    void* stream) {
  if (B <= 0 || H_kv <= 0 || H % H_kv || H / H_kv > MAX_REP) return cudaErrorInvalidValue;
  if ((long long)B * H_kv > 65535 || ranks < 1 || ranks > MAX_RANKS) return cudaErrorInvalidValue;
  Args a{q, k, v, k_scale, v_scale, fill, q_pos, out, H, H_kv, S, q_f32 != 0,
         k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb, ks_sh, vs_sb, vs_sh, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_rep<float>(a, B, D, ranks, st);
    case 1: return (int)launch_rep<__nv_bfloat16>(a, B, D, ranks, st);
    case 2:
      if (!k_scale || !v_scale) return cudaErrorInvalidValue;
      return (int)launch_rep<int8_t>(a, B, D, ranks, st);
    default: return cudaErrorInvalidValue;
  }
}

#ifdef K5_CLOCKS
// the first `blocks` blocks' timelines (MARKS int64 each) into host memory,
// then zeros in their place
extern "C" int decode_attn_single_clocks(long long* host, int blocks) {
  const size_t bytes = sizeof(long long) * MARKS * (size_t)blocks;
  cudaError_t e = cudaMemcpyFromSymbol(host, k5_clocks, bytes);
  if (e != cudaSuccess) return (int)e;
  void* dev = nullptr;
  e = cudaGetSymbolAddress(&dev, k5_clocks);
  return (int)(e != cudaSuccess ? e : cudaMemset(dev, 0, bytes));
}
#endif
