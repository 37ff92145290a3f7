// fused_expand, fused_expand_sq, fused_expand_pq, fused_expand_pq4,
// fused_expand_bin: one beam-search step's candidate block, gathered,
// scored, sorted and cut to the T = min(L, C) best, in one kernel, over
// f32 rows, SQ codes, PQ codes, nibble-packed PQ4 codes or sign codes.
//
// Replaces the Pallas kernels `fused_expand`, `fused_expand_sq`,
// `fused_expand_pq` and `fused_expand_pq4` of the JAX package
// (src/repro/kernels/traverse_step.py, shared epilogue `_finalize`) and
// `fused_expand_bin` (src/repro/kernels/bin_hamming.py). For each query,
// over the C = W*M flat candidate ids (expansion w owns positions
// [w*M, (w+1)*M)):
//   d[j]      = the candidate's distance (gather_dist, sq_gather_dist,
//               pq_adc, pq4_adc or bin_dist arithmetic), +inf where
//               ids[j] < 0;
//   (sd, si)  = stable ascending sort of (d, ids), first T kept, ids -1
//               where sd is not finite;
//   bests[w]  = min over expansion w's M entries of the unsorted d;
//   ties[w]   = number of entries of expansions w' < w whose d == bests[w].
//
// Bound on this card: bytes. The gathered rows (Q*C*d*4 bytes for f32,
// Q*C*d for SQ, Q*C*m for PQ, Q*C*m/2 for PQ4, Q*C*nw*4 for bin) and, for
// PQ, the sectors of the query's (m, K) f32 LUT that the codes hit (at
// m=16, K=256 and C=96 nearly all of its 16 KB: most of the PQ step's
// bytes; 1 KB for PQ4). Each block's threads x registers stay within an
// eighth of an SM's 65,536 registers (__launch_bounds__), so 8 blocks fit
// an SM and a batch of up to 1,056 queries is resident in one wave: a
// step then takes its launch, one block's dependent chain (the ids, the
// rows, the sort) and, for f32 rows and PQ tables, the bytes at the
// card's memory rate. On ids that are all -1 the PQ, PQ4 and bin steps
// take 0.0052-0.0055 ms on the H100 (Q=1000, C=96), against 0.0020 for
// the bin_dist gather: the block a query, its sort and its outputs are a
// floor that a scorer cannot cut.
//
// Design: one block per query, in three parts.
// 1. Scoring. The f32 and SQ steps run blocks of 128 threads (at most 64
//    registers a thread) and give each candidate a group of G = 8 lanes,
//    so a round scores 16 candidates (6 rounds at C=96). A lane reads the
//    ids of a pass's rounds, then issues every row load of those rounds
//    into registers before the first FMA, so a pass waits for one row
//    round trip, not one per candidate; a pass holds as many rounds as 24
//    registers of row units take: at d=96 all 6 SQ rounds (a 16-byte unit
//    a lane a row), and 2 f32 rounds (three float4 a lane a row), so 3
//    passes (more rounds a pass spill or cost the single wave, and ran
//    slower on the H100). Each query unit read from shared memory serves
//    the pass's rounds, and each group ends in a 3-step segmented shuffle.
//    Rows are read in the widest unit their size and alignment allow
//    (float4 for f32; 16, 8, 4 or 1 bytes for SQ, each code byte made a
//    float exactly by a byte permute); at the presets' d (96, 100, 128,
//    200) a row takes one pass of the unit loop, and any other d or an
//    unaligned row runs the same loop more times. The query (and SQ's
//    scale and zero) are staged in shared memory while the first loads
//    fly. The PQ step runs blocks of 128 threads (at most 64 registers)
//    and scores one candidate a thread with nothing staged: the id, the
//    code row, then the 16 table entries its codes hit, loaded from device
//    memory before any is added (distances.cuh, thread_adc_ldg). Staging
//    the table in shared memory (one bulk copy, or cp.async copies, issued
//    before or after the threads' id and code loads) measured no faster
//    at C=96 and slower at the traversal's share of valid ids, on tables
//    at a 4-byte offset and at m=32 (two waves); only C=192 (cp.async)
//    and m=12 over K=64 (the bulk copy) ran faster, by 5%. The PQ4 and
//    bin steps run blocks of 256 threads (at most 32 registers) and score
//    one candidate a thread from their staged table or query words.
// 2. Minima and tie counts: one warp per expansion, a warp min over its M
//    entries and a ballot count over the earlier expansions' entries.
// 3. The sort, of (distance, original position) pairs: for C <= 128 (every
//    preset) one warp sorts 128 64-bit keys in registers, 4 a lane, by a
//    bitonic network of register and __shfl_xor_sync compare-exchanges,
//    with no block barrier, while the other warps do part 2. A key is an
//    order-preserving u32 of the distance (-0.0 taken as +0.0, as the float
//    compare and jax.lax.sort take it) above the position, so every key is
//    distinct and the network's result is exactly the stable sort of
//    jax.lax.sort(is_stable=True), also for Hamming blocks, which are
//    mostly exact ties (bin writes one float per integer count); the
//    written distance is the original value. Larger C, up to 4096, sorts
//    (distance, position) pairs padded to a power of two P >= C with
//    (+inf, position >= C) by a bitonic network in shared memory.
// Shared memory: the functor's staging (d*4, d*12, m*16*4 or nw*4 bytes;
// none for PQ), C distances and C ids, plus P*8 bytes when C > 128.
#include "distances.cuh"

namespace {

// Blocks: threads, and the blocks an SM must hold at once
// (__launch_bounds__, which caps a thread's registers), for the grouped
// scorers (f32, SQ), for the PQ scorer and for the scorers of a thread a
// candidate from staged values (PQ4, bin); the subspaces whose table loads
// a PQ thread has in flight at once; the registers a lane of a grouped
// scorer may fill with row units in flight before it computes (so the
// rounds a pass takes).
constexpr int kGroupBlock = 128, kGroupMinBlocks = 8;
constexpr int kPqBlock = 128, kPqMinBlocks = 8;
constexpr int kThreadBlock = 256, kThreadMinBlocks = 8;
constexpr int kPqChunk = 16;
constexpr int kF32FlightRegs = 24, kSqFlightRegs = 24;
constexpr int kWarpSortC = 128;   // C up to which one warp sorts in registers
constexpr int kSortLane = kWarpSortC / 32;   // keys a lane holds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool pair_less(float ka, int pa, float kb, int pb) {
  return ka < kb || (ka == kb && pa < pb);
}

// ---- the grouped scorer of the f32 and SQ steps ----
// Rows supplies a row's units: units() per row, load(id, u) of unit u,
// dot(col, ex, u, acc) adding the terms of unit u of the RB rows in col to
// their sums (so the staged query values of unit u are read once for all
// RB), kNegate for the inner product. Candidate j = round * (Rows::kBlock
// / G) + thread / G; RB rounds a pass.
template <int G, int V, int RB, class Rows>
__device__ __forceinline__ void score_grouped(const Rows& rows,
                                              const float* ex,
                                              const int* __restrict__ idrow,
                                              int C, float* out,
                                              int* ids_s) {
  using Unit = typename Rows::Unit;
  constexpr int kGroups = Rows::kBlock / G;
  const int gl = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  const int nu = rows.units();
  const int rounds = (C + kGroups - 1) / kGroups;
  bool staged = false;
  for (int r0 = 0; r0 < rounds; r0 += RB) {
    int id[RB];
    float acc[RB];
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int j = (r0 + b) * kGroups + grp;
      id[b] = j < C ? __ldg(idrow + j) : -1;
      acc[b] = 0.f;
    }
    for (int u0 = 0; u0 < nu; u0 += G * V) {
      Unit buf[V][RB];
#pragma unroll
      for (int b = 0; b < RB; ++b) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int u = u0 + gl + G * v;
          buf[v][b] = id[b] >= 0 && u < nu ? rows.load(id[b], u) : Unit{};
        }
      }
      if (!staged) {         // the query staged by stage(), once, block-wide
        __syncthreads();
        staged = true;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int u = u0 + gl + G * v;
        if (u < nu) rows.dot(buf[v], ex, u, acc);
      }
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        acc[b] += __shfl_xor_sync(kFull, acc[b], off);
      const int j = (r0 + b) * kGroups + grp;
      if (gl == 0 && j < C) {
        out[j] = id[b] < 0 ? CUDART_INF_F
                           : (Rows::kNegate ? -acc[b] : acc[b]);
        ids_s[j] = id[b];
      }
    }
  }
}

// ---- distance functors: stage(ex, qi), then score(ex, idrow, C, out, ids) --
// U = 4: float4 units (d % 4 == 0, 16-byte aligned rows); U = 1: floats.
template <int V, int U, bool IP>
struct F32Dist {
  using Unit = typename kbest::F32Unit<U>::T;
  static constexpr bool kNegate = IP;
  static constexpr int kBlock = kGroupBlock, kMinBlocks = kGroupMinBlocks;
  static constexpr int kRounds = kF32FlightRegs / (V * U) > 0
                                     ? kF32FlightRegs / (V * U) : 1;
  const float* q;
  const float* db;
  int d;
  __device__ int units() const { return d / U; }
  __device__ Unit load(int id, int u) const {
    return __ldg(reinterpret_cast<const Unit*>(db + (size_t)id * d) + u);
  }
  template <int RB>
  __device__ void dot(const float4 (&r)[RB], const float* ex, int u,
                      float (&acc)[RB]) const {
    const float4 v = reinterpret_cast<const float4*>(ex)[u];
#pragma unroll
    for (int b = 0; b < RB; ++b) kbest::f32_unit<IP>(r[b], v, acc[b]);
  }
  template <int RB>
  __device__ void dot(const float (&r)[RB], const float* ex, int u,
                      float (&acc)[RB]) const {
    const float v = ex[u];
#pragma unroll
    for (int b = 0; b < RB; ++b) kbest::f32_unit<IP>(r[b], v, acc[b]);
  }
  __device__ void stage(float* ex, int qi) const {
    const float* qrow = q + (size_t)qi * d;
    for (int k = threadIdx.x; k < d; k += kBlock) ex[k] = qrow[k];
  }
  __device__ void score(const float* ex, const int* idrow, int C, float* out,
                        int* ids_s) const {
    score_grouped<8, V, kRounds>(*this, ex, idrow, C, out, ids_s);
  }
};

// UB bytes a unit: 16, 8 or 4 (d % UB == 0 and UB-aligned rows), or 1.
// ex holds the query, then scale, then zero (d floats each).
template <int UB, bool IP>
struct SqDist {
  using Unit = typename kbest::SqUnit<UB>::T;
  static constexpr bool kNegate = IP;
  static constexpr int kBlock = kGroupBlock, kMinBlocks = kGroupMinBlocks;
  static constexpr int kV = UB == 16 ? 1 : 4;   // units a lane a pass
  static constexpr int kUnitRegs = UB == 16 ? 4 : UB == 8 ? 2 : 1;
  static constexpr int kRounds = kSqFlightRegs / (kV * kUnitRegs) > 0
                                     ? kSqFlightRegs / (kV * kUnitRegs) : 1;
  const float* q;
  const unsigned char* codes;
  const float* scale;
  const float* zero;
  int d;
  __device__ int units() const { return d / UB; }
  __device__ Unit load(int id, int u) const {
    const unsigned char* row = codes + (size_t)id * d;
    if constexpr (UB == 1) return __ldg(row + u);
    else return __ldg(reinterpret_cast<const Unit*>(row) + u);
  }
  template <int RB>
  __device__ void dot(const Unit (&c)[RB], const float* ex, int u,
                      float (&acc)[RB]) const {
    constexpr int metric = IP ? 1 : 0;
    if constexpr (UB == 1) {
      const float qv = ex[u], s = ex[d + u], z = ex[2 * d + u];
#pragma unroll
      for (int b = 0; b < RB; ++b)
        kbest::sq_term(kbest::code_at(c[b], 0), s, z, qv, metric,
                       acc[b]);
    } else {
#pragma unroll
      for (int i = 0; i < UB / 4; ++i) {
        const int k = u * UB + 4 * i;
        const float4 qv = *reinterpret_cast<const float4*>(ex + k);
        const float4 s = *reinterpret_cast<const float4*>(ex + d + k);
        const float4 z = *reinterpret_cast<const float4*>(ex + 2 * d + k);
#pragma unroll
        for (int b = 0; b < RB; ++b)
          kbest::sq_word<IP>(kbest::word(c[b], i), qv, s, z, acc[b]);
      }
    }
  }
  __device__ void stage(float* ex, int qi) const {
    const float* qrow = q + (size_t)qi * d;
    for (int k = threadIdx.x; k < d; k += kBlock) {
      ex[k] = qrow[k];
      ex[d + k] = scale[k];
      ex[2 * d + k] = zero[k];
    }
  }
  __device__ void score(const float* ex, const int* idrow, int C, float* out,
                        int* ids_s) const {
    score_grouped<8, kV, kRounds>(*this, ex, idrow, C, out, ids_s);
  }
};

// PQ, one thread a candidate and nothing staged: a thread loads its id,
// its code row (V16: one 16-byte load per 16 subspaces, m % 16 == 0 and
// 16-byte aligned rows; else bytes), then the table entries of kPqChunk
// subspaces from device memory through the read-only path before it adds
// any (thread_adc_ldg), so no barrier stands between the ids and the sort
// and only the table sectors the codes hit are read.
template <bool V16>
struct PqDist {
  static constexpr int kBlock = kPqBlock, kMinBlocks = kPqMinBlocks;
  const float* lut;            // (Q, m, K)
  const unsigned char* codes;  // (n, m)
  int m, K;
  __device__ void stage(float*, int) const {}
  __device__ void score(const float*, const int* idrow, int C, float* out,
                        int* ids_s) const {
    const float* lrow = lut + (size_t)blockIdx.x * m * K;
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const int id = __ldg(idrow + j);
      out[j] = id >= 0 ? kbest::thread_adc_ldg<kPqChunk>(codes, id, lrow, m,
                                                         K, V16)
                       : CUDART_INF_F;
      ids_s[j] = id;
    }
  }
};

struct Pq4Dist {
  static constexpr int kBlock = kThreadBlock, kMinBlocks = kThreadMinBlocks;
  const float* lut;            // (Q, m, 16)
  const unsigned char* codes;  // (n, m/2), two codes a byte
  int m, vec8;
  __device__ void stage(float* ex, int qi) const {
    const float* lrow = lut + (size_t)qi * m * 16;
    for (int k = threadIdx.x; k < m * 16; k += blockDim.x) ex[k] = lrow[k];
  }
  __device__ void score(const float* ex, const int* idrow, int C, float* out,
                        int* ids_s) const {
    __syncthreads();
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const int id = idrow[j];
      out[j] = id >= 0 ? kbest::thread_adc4(codes, id, ex, m, vec8 != 0)
                       : CUDART_INF_F;
      ids_s[j] = id;
    }
  }
};

struct BinDist {
  static constexpr int kBlock = kThreadBlock, kMinBlocks = kThreadMinBlocks;
  const unsigned int* q;       // (Q, nw)
  const unsigned int* codes;   // (n, nw)
  int nw;
  __device__ void stage(float* ex, int qi) const {
    unsigned int* qs = reinterpret_cast<unsigned int*>(ex);
    for (int k = threadIdx.x; k < nw; k += blockDim.x)
      qs[k] = q[(size_t)qi * nw + k];
  }
  __device__ void score(const float* ex, const int* idrow, int C, float* out,
                        int* ids_s) const {
    __syncthreads();
    const unsigned int* qs = reinterpret_cast<const unsigned int*>(ex);
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const int id = idrow[j];
      out[j] = id >= 0 ? kbest::thread_hamming(codes, id, qs, nw)
                       : CUDART_INF_F;
      ids_s[j] = id;
    }
  }
};

// ---- the shared epilogue ----
// Expansions w = w0, w0 + step, ...: one warp each, the minimum of its M
// entries and the count of earlier entries equal to it.
__device__ __forceinline__ void expansion_stats(const float* un, int M, int W,
                                                int w0, int step, int lane,
                                                float* best_out,
                                                int* ties_out) {
  for (int w = w0; w < W; w += step) {
    float best = CUDART_INF_F;
    for (int j = w * M + lane; j < (w + 1) * M; j += 32)
      best = fminf(best, un[j]);
    for (int off = 16; off > 0; off >>= 1)
      best = fminf(best, __shfl_xor_sync(kFull, best, off));
    int ties = 0;
    for (int j0 = 0; j0 < w * M; j0 += 32) {
      const int j = j0 + lane;
      ties += __popc(__ballot_sync(kFull, j < w * M && un[j] == best));
    }
    if (lane == 0) {
      best_out[w] = best;
      ties_out[w] = ties;
    }
  }
}

// (distance, position) as one 64-bit key in the pairs' order: the float
// bits made order-preserving as a u32 (-0.0 first made +0.0), then the
// position.
__device__ __forceinline__ unsigned long long sort_key(float v, int pos) {
  unsigned int b = __float_as_uint(v);
  if ((b << 1) == 0u) b = 0u;
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) |
         static_cast<unsigned int>(pos);
}

// One warp: the C <= 128 distances as keys i = lane*4 + r (padded with
// +inf at positions >= C), a bitonic sort in registers, the first T out.
__device__ __forceinline__ void warp_sort_block(const float* un,
                                                const int* ids_s, int C,
                                                int T, int lane, float* od,
                                                int* oi) {
  constexpr int E = kSortLane;
  unsigned long long k[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = lane * E + r;
    k[r] = sort_key(i < C ? un[i] : CUDART_INF_F, i);
  }
  constexpr int kLogP = 7;       // 32 * E = 128 keys
  static_assert(32 * E == 1 << kLogP, "one warp's keys");
#pragma unroll
  for (int lk = 1; lk <= kLogP; ++lk) {
    const int kk = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j < E) {               // both keys in this lane
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int rp = r ^ j;
          if (rp > r) {
            const bool up = ((lane * E + r) & kk) == 0;
            const unsigned long long a = k[r], b = k[rp];
            const bool swap = up ? b < a : a < b;
            k[r] = swap ? b : a;
            k[rp] = swap ? a : b;
          }
        }
      } else {                   // the partner key is in lane ^ (j / E)
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int i = lane * E + r;
          const unsigned long long o = __shfl_xor_sync(kFull, k[r], j / E);
          const bool keep_min = ((i & j) == 0) == ((i & kk) == 0);
          k[r] = keep_min ? (o < k[r] ? o : k[r]) : (o < k[r] ? k[r] : o);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int t = lane * E + r;
    if (t < T) {
      const int p = static_cast<int>(k[r] & 0xffffffffu);
      const float v = un[p];
      od[t] = v;
      oi[t] = isfinite(v) ? ids_s[p] : -1;
    }
  }
}

template <class Dist>
__global__ void __launch_bounds__(Dist::kBlock, Dist::kMinBlocks)
expand_kernel(Dist dist, const int* __restrict__ ids,
              float* __restrict__ out_d, int* __restrict__ out_i,
              float* __restrict__ out_best, int* __restrict__ out_ties,
              int C, int P, int T, int W, int ex_floats) {
  extern __shared__ __align__(16) float smem[];
  float* ex = smem;                                     // the functor's
  float* unsorted = ex + ex_floats;                     // C
  int* ids_s = reinterpret_cast<int*>(unsorted + C);    // C

  const int qi = blockIdx.x;
  const int* idrow = ids + (size_t)qi * C;
  dist.stage(ex, qi);
  dist.score(ex, idrow, C, unsorted, ids_s);
  __syncthreads();

  const int M = C / W;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* od = out_d + (size_t)qi * T;
  int* oi = out_i + (size_t)qi * T;
  float* ob = out_best + (size_t)qi * W;
  int* ot = out_ties + (size_t)qi * W;
  if (C <= kWarpSortC) {
    if (warp == 0)
      warp_sort_block(unsorted, ids_s, C, T, lane, od, oi);
    else
      expansion_stats(unsorted, M, W, warp - 1, Dist::kBlock / 32 - 1, lane,
                      ob, ot);
    return;
  }

  // ---- C > 128: bitonic sort of (key, position) in shared memory ----
  float* keys = reinterpret_cast<float*>(ids_s + C);    // P
  int* pos = reinterpret_cast<int*>(keys + P);          // P
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    keys[j] = j < C ? unsorted[j] : CUDART_INF_F;
    pos[j] = j;
  }
  expansion_stats(unsorted, M, W, warp, Dist::kBlock / 32, lane, ob, ot);
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const float ka = keys[i], kb = keys[ixj];
          const int pa = pos[i], pb = pos[ixj];
          const bool up = (i & k) == 0;
          const bool swap = up ? pair_less(kb, pb, ka, pa)
                               : pair_less(ka, pa, kb, pb);
          if (swap) {
            keys[i] = kb; keys[ixj] = ka;
            pos[i] = pb; pos[ixj] = pa;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const float v = keys[t];
    od[t] = v;
    oi[t] = isfinite(v) ? ids_s[pos[t]] : -1;
  }
}

// One step's operands besides the functor's.
struct Step {
  const void* ids;
  void* out_d;
  void* out_i;
  void* out_best;
  void* out_ties;
  int Q, C, T, W;
  void* stream;
};

template <class Dist>
int launch(const Dist& dist, size_t extra_floats, const Step& s) {
  if (s.Q == 0) return 0;
  int P = 1;
  while (P < s.C) P <<= 1;
  const size_t ex_floats = (extra_floats + 3) & ~static_cast<size_t>(3);
  size_t smem = (ex_floats + 2 * (size_t)s.C) * sizeof(float);
  if (s.C > kWarpSortC) smem += (size_t)P * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      expand_kernel<Dist>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<Dist><<<s.Q, Dist::kBlock, smem,
                        static_cast<cudaStream_t>(s.stream)>>>(
      dist, static_cast<const int*>(s.ids), static_cast<float*>(s.out_d),
      static_cast<int*>(s.out_i), static_cast<float*>(s.out_best),
      static_cast<int*>(s.out_ties), s.C, P, s.T, s.W,
      static_cast<int>(ex_floats));
  return static_cast<int>(cudaGetLastError());
}

template <int V, int U>
int launch_f32(const float* q, const float* db, int d, int metric,
               const Step& s) {
  if (metric == 0)
    return launch(F32Dist<V, U, false>{q, db, d}, d, s);
  return launch(F32Dist<V, U, true>{q, db, d}, d, s);
}

template <int UB>
int launch_sq(const float* q, const unsigned char* codes, const float* scale,
              const float* zero, int d, int metric, const Step& s) {
  if (metric == 0)
    return launch(SqDist<UB, false>{q, codes, scale, zero, d}, 3 * (size_t)d,
                  s);
  return launch(SqDist<UB, true>{q, codes, scale, zero, d}, 3 * (size_t)d, s);
}

bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<size_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" int fused_expand_f32(const void* q, const void* db, const void* ids,
                                void* out_d, void* out_i, void* out_best,
                                void* out_ties, int Q, int C, int T, int W,
                                int d, int metric, void* stream) {
  const Step s{ids, out_d, out_i, out_best, out_ties, Q, C, T, W, stream};
  const float* qf = static_cast<const float*>(q);
  const float* dbf = static_cast<const float*>(db);
  if (d % 4 != 0 || !aligned(db, 16))
    return launch_f32<4, 1>(qf, dbf, d, metric, s);
  if (d > 96)                       // d = 100, 128; 200 in two passes
    return launch_f32<4, 4>(qf, dbf, d, metric, s);
  return launch_f32<3, 4>(qf, dbf, d, metric, s);
}

extern "C" int fused_expand_sq_u8(const void* q, const void* codes,
                                  const void* scale, const void* zero,
                                  const void* ids, void* out_d, void* out_i,
                                  void* out_best, void* out_ties, int Q, int C,
                                  int T, int W, int d, int metric,
                                  void* stream) {
  const Step s{ids, out_d, out_i, out_best, out_ties, Q, C, T, W, stream};
  const float* qf = static_cast<const float*>(q);
  const unsigned char* c = static_cast<const unsigned char*>(codes);
  const float* sf = static_cast<const float*>(scale);
  const float* zf = static_cast<const float*>(zero);
  if (d % 16 == 0 && aligned(codes, 16))
    return launch_sq<16>(qf, c, sf, zf, d, metric, s);
  if (d % 8 == 0 && aligned(codes, 8))
    return launch_sq<8>(qf, c, sf, zf, d, metric, s);
  if (d % 4 == 0 && aligned(codes, 4))
    return launch_sq<4>(qf, c, sf, zf, d, metric, s);
  return launch_sq<1>(qf, c, sf, zf, d, metric, s);
}

extern "C" int fused_expand_pq_u8(const void* lut, const void* codes,
                                  const void* ids, void* out_d, void* out_i,
                                  void* out_best, void* out_ties, int Q, int C,
                                  int T, int W, int m, int K, void* stream) {
  const Step s{ids, out_d, out_i, out_best, out_ties, Q, C, T, W, stream};
  const float* lf = static_cast<const float*>(lut);
  const unsigned char* c = static_cast<const unsigned char*>(codes);
  if (m % 16 == 0 && aligned(codes, 16))
    return launch(PqDist<true>{lf, c, m, K}, 0, s);
  return launch(PqDist<false>{lf, c, m, K}, 0, s);
}

extern "C" int fused_expand_pq4_u8(const void* lut, const void* codes,
                                   const void* ids, void* out_d, void* out_i,
                                   void* out_best, void* out_ties, int Q,
                                   int C, int T, int W, int m, void* stream) {
  int vec8 = (m % 16 == 0) && aligned(codes, 8);
  Pq4Dist dist{static_cast<const float*>(lut),
               static_cast<const unsigned char*>(codes), m, vec8};
  return launch(dist, (size_t)m * 16,
                Step{ids, out_d, out_i, out_best, out_ties, Q, C, T, W,
                     stream});
}

extern "C" int fused_expand_bin_u32(const void* qcodes, const void* codes,
                                    const void* ids, void* out_d, void* out_i,
                                    void* out_best, void* out_ties, int Q,
                                    int C, int T, int W, int nw,
                                    void* stream) {
  BinDist dist{static_cast<const unsigned int*>(qcodes),
               static_cast<const unsigned int*>(codes), nw};
  return launch(dist, (size_t)nw,
                Step{ids, out_d, out_i, out_best, out_ties, Q, C, T, W,
                     stream});
}
