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
// bytes; 1 KB for PQ4). A batch of up to 1,056 queries is resident in one
// wave (__launch_bounds__), so a step takes its launch, one query's
// dependent chain (the ids, the rows, the sort) and, for f32 rows and PQ
// tables, the bytes at the card's memory rate. For PQ4 and bin the
// bytes are far below the launch: on the H100 (Q=1000, C=96) a launch
// takes 0.0014 ms and the bin_dist gather on ids that are all -1 0.0019,
// against a bound of 0.0014-0.0015 for either step.
//
// Design, PQ4 and bin at C <= 128 (every preset; PQ4 also m <= 192): a
// warp a query, kStepWarps warps a block, no block barrier
// (warp_step_kernel).
// 1. Lane l owns positions 4l .. 4l+3 (one int4 of ids where C % 4 == 0;
//    -1 at positions >= C). bin loads the query's words beside the ids,
//    then every word of its 4 rows at once; PQ4 copies the query's 1 KB
//    table into the warp's slice of shared memory by cp.async beside the
//    ids, loads its 4 code rows, waits for its copies and the warp
//    (__syncwarp), then loads every table entry of a chunk of its 4 rows
//    before any add (distances.cuh, thread_adc4_rows). Each distance is
//    kept as a u32 rank in the distances' order.
// 2. Minima and tie counts from the same registers: per expansion a lane
//    minimum of the ranks, __reduce_min_sync, and __reduce_add_sync of the
//    earlier entries of equal rank (rank equality is float ==; the ranks
//    of PQ4 sums, never -0.0, are a bijection).
// 3. The sort: 128 32-bit keys (rank above the 7-bit position: bin's
//    counts whole, PQ4's ranks cut to their top 25 bits) by a bitonic
//    network in registers, each compare-exchange a compare and a select
//    (bitonic_lanes); for PQ4 one check of every adjacent pair on the
//    full (rank, position) pairs, and odd-even transposition passes in
//    the rare block where distinct ranks shared a key's bits (fix_order).
//    The keys are distinct, so the order is exactly the stable sort of
//    jax.lax.sort(is_stable=True). Ranks and ids come back by position
//    from the warp's slice of shared memory; lane l writes ranks 4l ..
//    4l+3 (one float4 and one int4 where T % 4 == 0). On the H100 this
//    took PQ4 from 0.0070 to 0.0049 ms and bin from 0.0064 to 0.0039
//    (0.0042 and 0.0032 on ids that are all -1); 64-bit keys, lookups from
//    device memory and 1, 2 or 8 warps a block were no faster.
//
// Design, the f32, SQ and PQ steps, and PQ4 and bin at C > 128: one block
// per query (expand_kernel), in three parts.
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
//    and m=12 over K=64 (the bulk copy) ran faster, by 5%. The PQ4 step
//    at C > 128 or m > 192 and the bin step at C > 128 run blocks of 256
//    threads (at most 32 registers) and score one candidate a thread from
//    their staged table or query words.
// 2. Minima and tie counts: one warp per expansion, a warp min over its M
//    entries and a ballot count over the earlier expansions' entries.
// 3. The sort, of (distance, original position) pairs: for C <= 128 one
//    warp sorts 128 64-bit keys in registers, 4 a lane, by a bitonic
//    network of register and __shfl_xor_sync compare-exchanges, with no
//    block barrier, while the other warps do part 2. A key is an
//    order-preserving u32 of the distance (-0.0 taken as +0.0, as the
//    float compare and jax.lax.sort take it) above the position, so every
//    key is distinct and the network's result is exactly the stable sort;
//    the written distance is the original value. Larger C, up to 4096,
//    sorts (distance, position) pairs padded to a power of two P >= C
//    with (+inf, position >= C) by a bitonic network in shared memory.
// Shared memory: the functor's staging (d*4, d*12, m*16*4 or nw*4 bytes;
// none for PQ), C distances and C ids, plus P*8 bytes when C > 128;
// cudaFuncSetAttribute is called only where a launch needs more than 48
// KB, once a size a device. The warp-resident steps: 1 KB of ranks and
// ids a warp, and PQ4's m*64 bytes of table.
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
// The warp-resident PQ4 and bin steps (C <= 128): queries a block (a warp
// each) and the blocks an SM must hold, 8 warps an SM, so a batch of up to
// 1,056 queries is resident in one wave at any register count up to 255;
// the subspaces of each of a lane's 4 candidates whose PQ4 table entries
// are loaded before any is added; the words a pass of the general bin
// path.
constexpr int kStepWarps = 4;
constexpr int kStepMinBlocks = 8 / kStepWarps;
constexpr int kPq4Chunk = 16;
constexpr int kBinWords = 8;
// bin's rank of an invalid candidate: above every count, and with 7
// position bits below it a 32-bit key
constexpr unsigned kBinInvalid = (1u << 25) - 1;
// the shared memory a block may take without cudaFuncSetAttribute
constexpr size_t kDefaultSmem = 48 * 1024;
// devices whose dynamic shared memory setting launch() remembers
constexpr int kMaxDevices = 64;

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

// A float as an order-preserving u32 (-0.0 first made +0.0, as the float
// compare and jax.lax.sort take it), and back (exact for every float but
// -0.0).
__device__ __forceinline__ unsigned int float_rank(float v) {
  unsigned int b = __float_as_uint(v);
  if ((b << 1) == 0u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float rank_float(unsigned int r) {
  return __uint_as_float((r & 0x80000000u) ? (r & 0x7fffffffu) : ~r);
}

// (distance, position) as one 64-bit key in the pairs' order: the
// distance's rank, then the position.
__device__ __forceinline__ unsigned long long sort_key(float v, int pos) {
  return (static_cast<unsigned long long>(float_rank(v)) << 32) |
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

// ---- the warp-resident PQ4 and bin steps (C <= 128) ----
// Lane l's candidates: positions 4l .. 4l+3 (id -1 at positions >= C),
// loaded as one int4 where vec (C % 4 == 0, 16-byte aligned ids).
__device__ __forceinline__ void lane_ids(const int* __restrict__ idrow,
                                         int C, bool vec, int lane,
                                         int (&id)[kSortLane]) {
  constexpr int E = kSortLane;
  if (vec) {
    const int4 v = lane * E < C
                       ? __ldg(reinterpret_cast<const int4*>(idrow) + lane)
                       : make_int4(-1, -1, -1, -1);
    id[0] = v.x; id[1] = v.y; id[2] = v.z; id[3] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r)
      id[r] = lane * E + r < C ? __ldg(idrow + lane * E + r) : -1;
  }
}

// The 16- or 4-byte asynchronous copy of a global word to shared memory
// (cp.async, not waited on), and the wait for all of a thread's copies.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned int>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned int>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Scorers of a lane's 4 candidates: ranks(qi, idrow, C, vec, lane, tab,
// id, rk) loads the ids and gives each candidate's distance as a u32
// rank, ordered as the distances and equal exactly where they are equal
// (+inf's rank for id -1); value(rank) is the distance; kTop25 whether
// the sort key holds only the rank's top 25 bits (make_key); tab is the
// warp's m*16 floats of shared memory where PQ4 stages its table.
// PQ4: the warp first copies its query's (m, 16) table into tab by
// cp.async (16-byte copies where the tables are 16-byte aligned, lut16),
// loads the ids and the code rows while the copy flies, then waits for
// its own copies and the warp (__syncwarp: no block barrier) and loads
// every entry of a chunk of every candidate from shared memory before any
// add (thread_adc4_rows). Reading the entries from device memory instead
// ran 0.0002-0.0003 ms slower at m=16 on the H100, 0.0020 on codes at a
// 1-byte offset. The sum runs from +0.0, and x + (-x) and +0.0 + -0.0 are
// +0.0, so it is never -0.0: float_rank is then a bijection and value()
// gives back the very sum.
template <bool V8>
struct Pq4WarpDist {
  static constexpr bool kTop25 = true;
  const float* lut;            // (Q, m, 16)
  const unsigned char* codes;  // (n, m/2), two codes a byte
  int m;
  bool lut16;
  __device__ static float value(unsigned int r) { return rank_float(r); }
  __device__ void ranks(int qi, const int* idrow, int C, bool vec, int lane,
                        float* tab, int (&id)[kSortLane],
                        unsigned int (&rk)[kSortLane]) const {
    const float* lrow = lut + (size_t)qi * m * 16;
    if (lut16) {
      for (int k = lane * 4; k < m * 16; k += 128)
        copy_async16(tab + k, lrow + k);
    } else {
      for (int k = lane; k < m * 16; k += 32) copy_async4(tab + k, lrow + k);
    }
    lane_ids(idrow, C, vec, lane, id);
    float d[kSortLane];
    auto ready = [] {
      copy_async_wait();
      __syncwarp();
    };
    kbest::thread_adc4_rows<kSortLane, kPq4Chunk, V8>(codes, id, tab, m,
                                                      ready, d);
#pragma unroll
    for (int r = 0; r < kSortLane; ++r)
      rk[r] = float_rank(id[r] >= 0 ? d[r] : CUDART_INF_F);
  }
};

// bin: the query's words loaded beside the ids, then every word of the 4
// rows at once (NW words a row at NW = 3, 4, 7; else kBinWords a pass);
// the rank is the Hamming count itself, kBinInvalid for id -1.
template <int NW>
struct BinWarpDist {
  static constexpr bool kTop25 = false;
  const unsigned int* q;       // (Q, nw)
  const unsigned int* codes;   // (n, nw)
  int nw;
  __device__ static float value(unsigned int r) {
    return r == kBinInvalid ? CUDART_INF_F : static_cast<float>(r);
  }
  __device__ void ranks(int qi, const int* idrow, int C, bool vec, int lane,
                        float*, int (&id)[kSortLane],
                        unsigned int (&rk)[kSortLane]) const {
    constexpr int E = kSortLane;
    constexpr int kW = NW > 0 ? NW : kBinWords;
    const int n = NW > 0 ? NW : nw;
    const unsigned int* qrow = q + (size_t)qi * n;
    unsigned int qv[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w)
      qv[w] = NW > 0 || w < n ? __ldg(qrow + w) : 0u;
    lane_ids(idrow, C, vec, lane, id);
    int acc[E] = {};
    for (int w0 = 0; w0 < n; w0 += kW) {     // one pass when NW > 0
      if (w0 > 0) {
#pragma unroll
        for (int w = 0; w < kW; ++w)
          qv[w] = w0 + w < n ? __ldg(qrow + w0 + w) : 0u;
      }
      unsigned int rw[E][kW];
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const unsigned int* row = codes + (size_t)(id[r] < 0 ? 0 : id[r]) * n;
#pragma unroll
        for (int w = 0; w < kW; ++w)
          rw[r][w] = id[r] >= 0 && (NW > 0 || w0 + w < n)
                         ? __ldg(row + w0 + w) : 0u;
      }
#pragma unroll
      for (int r = 0; r < E; ++r) {
#pragma unroll
        for (int w = 0; w < kW; ++w) acc[r] += __popc(qv[w] ^ rw[r][w]);
      }
    }
#pragma unroll
    for (int r = 0; r < E; ++r)
      rk[r] = id[r] >= 0 ? static_cast<unsigned int>(acc[r]) : kBinInvalid;
  }
};

// One warp's 128 distinct 32-bit keys, key i = lane*4 + r in k[r], sorted
// ascending in registers by a bitonic network of register and
// __shfl_xor_sync compare-exchanges, each a compare and a select: a
// stage's direction is a bit of the lane (or, within a lane, of r), taken
// once a lane.
__device__ __forceinline__ void bitonic_lanes(unsigned int (&k)[kSortLane],
                                              int lane) {
  using K = unsigned int;
  constexpr int E = kSortLane;
  constexpr int kLogP = 7;       // 32 * E = 128 keys
  static_assert(32 * E == 1 << kLogP, "one warp's keys");
  const int base = lane * E;
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
            const bool up = kk < E ? (r & kk) == 0 : (base & kk) == 0;
            const K a = k[r], b = k[rp];
            const bool swap = (b < a) == up;
            k[r] = swap ? b : a;
            k[rp] = swap ? a : b;
          }
        }
      } else {                   // the partner key is in lane ^ (j / E)
        const bool keep_min = ((base & j) == 0) == ((base & kk) == 0);
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const K o = __shfl_xor_sync(kFull, k[r], j / E);
          k[r] = (o < k[r]) == keep_min ? o : k[r];
        }
      }
    }
  }
}

// A candidate's 32-bit sort key from its rank and position (the low 7
// bits): rank << 7 where every rank is below 2^25 (bin's counts: exact);
// with kTop25 the rank's top 25 bits (PQ4: exact but for distinct ranks
// that share those bits, which fix_order puts right). A 64-bit key
// (rank << 32 | position) needs no fix_order, but twice the shuffles and
// three times the compare and select instructions: it ran 0.0003-0.0004
// ms slower on the H100 (Q=1000, C=96), for PQ4 and for bin.
template <bool kTop25>
__device__ __forceinline__ unsigned int make_key(unsigned int rank, int pos) {
  return (kTop25 ? rank & ~127u : rank << 7) | static_cast<unsigned int>(pos);
}

// The warp's 128 (rank, position) pairs, pair t = lane*4 + r, sorted by
// their top-25-bit keys, put in the order of the full pairs: a check of
// every adjacent pair (one vote), and while one is out of order a pass of
// odd-even transposition (its even pairs, then its odd ones), whose
// passes sort any input; the keys differ only within runs of ranks that
// share their top 25 bits, so one pass is rare and more rarer.
__device__ __forceinline__ void fix_order(unsigned int (&rank)[kSortLane],
                                          int (&pos)[kSortLane], int lane) {
  constexpr int E = kSortLane;
  unsigned long long f[E];
#pragma unroll
  for (int r = 0; r < E; ++r)
    f[r] = (static_cast<unsigned long long>(rank[r]) << 32) |
           static_cast<unsigned int>(pos[r]);
  auto exchange = [](unsigned long long& a, unsigned long long& b) {
    const unsigned long long lo = a < b ? a : b, hi = a < b ? b : a;
    a = lo;
    b = hi;
  };
  while (true) {
    const unsigned long long next = __shfl_down_sync(kFull, f[0], 1);
    bool sorted = lane == 31 || f[E - 1] < next;
#pragma unroll
    for (int r = 0; r + 1 < E; ++r) sorted = sorted && f[r] < f[r + 1];
    if (__all_sync(kFull, sorted)) break;
#pragma unroll
    for (int r = 0; r + 1 < E; r += 2) exchange(f[r], f[r + 1]);
#pragma unroll
    for (int r = 1; r + 1 < E; r += 2) exchange(f[r], f[r + 1]);
    const unsigned long long nxt = __shfl_down_sync(kFull, f[0], 1);
    const unsigned long long prv = __shfl_up_sync(kFull, f[E - 1], 1);
    if (lane < 31) f[E - 1] = f[E - 1] < nxt ? f[E - 1] : nxt;
    if (lane > 0) f[0] = f[0] < prv ? prv : f[0];
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    rank[r] = static_cast<unsigned int>(f[r] >> 32);
    pos[r] = static_cast<int>(f[r] & 0xffffffffu);
  }
}

// One warp a query, no block barrier: the lane's 4 ranks, then each
// expansion's minimum (a lane minimum, __reduce_min_sync) and the count of
// earlier entries of equal rank (__reduce_add_sync), from the same
// registers; the keys (rank, position) sorted in registers (and put in
// the full pairs' order where a key holds only a rank's top 25 bits); the
// first T written, lane l ranks 4l .. 4l+3 (one float4 and one int4 where
// vec_out), each rank and id read back from the warp's rk_w and ids_w by
// its position.
template <class Dist>
__global__ void __launch_bounds__(32 * kStepWarps, kStepMinBlocks)
warp_step_kernel(Dist dist, const int* __restrict__ ids,
                 float* __restrict__ out_d, int* __restrict__ out_i,
                 float* __restrict__ out_best, int* __restrict__ out_ties,
                 int Q, int C, int T, int W, int tab_floats, bool vec_ids,
                 bool vec_out) {
  constexpr int E = kSortLane;
  __shared__ __align__(16) int ids_s[kStepWarps][kWarpSortC];
  __shared__ __align__(16) unsigned int rk_s[kStepWarps][kWarpSortC];
  extern __shared__ __align__(16) float tabs[];   // tab_floats a warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kStepWarps + warp;
  if (qi >= Q) return;
  int id[E];
  unsigned int rk[E];
  dist.ranks(qi, ids + (size_t)qi * C, C, vec_ids, lane,
             tabs + (size_t)warp * tab_floats, id, rk);
  int* ids_w = ids_s[warp];
  unsigned int* rk_w = rk_s[warp];
  reinterpret_cast<int4*>(ids_w)[lane] = make_int4(id[0], id[1], id[2],
                                                   id[3]);
  reinterpret_cast<uint4*>(rk_w)[lane] = make_uint4(rk[0], rk[1], rk[2],
                                                    rk[3]);

  const int M = C / W;
  float* ob = out_best + (size_t)qi * W;
  int* ot = out_ties + (size_t)qi * W;
  float keep_best = 0.f;
  unsigned int keep_ties = 0u;
  for (int w = 0; w < W; ++w) {
    const int lo = w * M, hi = lo + M;
    unsigned int best = 0xffffffffu;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int p = lane * E + r;
      if (p >= lo && p < hi) best = min(best, rk[r]);
    }
    best = __reduce_min_sync(kFull, best);
    unsigned int ties = 0u;
#pragma unroll
    for (int r = 0; r < E; ++r) ties += lane * E + r < lo && rk[r] == best;
    ties = __reduce_add_sync(kFull, ties);
    if ((w & 31) == lane) {      // lane w % 32 keeps expansion w's pair
      keep_best = Dist::value(best);
      keep_ties = ties;
    }
    if ((w & 31) == 31 || w == W - 1) {
      const int w0 = w & ~31;
      if (lane <= (w & 31)) {
        ob[w0 + lane] = keep_best;
        ot[w0 + lane] = static_cast<int>(keep_ties);
      }
    }
  }

  unsigned int k[E];
#pragma unroll
  for (int r = 0; r < E; ++r)
    k[r] = make_key<Dist::kTop25>(rk[r], lane * E + r);
  bitonic_lanes(k, lane);
  __syncwarp();                  // ids_w and rk_w written by every lane
  unsigned int sr[E];
  int sp[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    sp[r] = static_cast<int>(k[r] & 127u);
    sr[r] = rk_w[sp[r]];
  }
  if constexpr (Dist::kTop25) fix_order(sr, sp, lane);
  float v[E];
  int o[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    v[r] = Dist::value(sr[r]);
    o[r] = isfinite(v[r]) ? ids_w[sp[r]] : -1;
  }
  const int t0 = lane * E;
  float* od = out_d + (size_t)qi * T;
  int* oi = out_i + (size_t)qi * T;
  if (vec_out) {
    if (t0 < T) {
      reinterpret_cast<float4*>(od)[lane] = make_float4(v[0], v[1], v[2],
                                                        v[3]);
      reinterpret_cast<int4*>(oi)[lane] = make_int4(o[0], o[1], o[2], o[3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (t0 + r < T) {
        od[t0 + r] = v[r];
        oi[t0 + r] = o[r];
      }
    }
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

bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<size_t>(p) & (bytes - 1)) == 0;
}

// Lets expand_kernel<Dist> take `smem` bytes of dynamic shared memory on
// the current device: cudaFuncSetAttribute only where a launch needs more
// than the default 48 KB and more than was last set on that device, not
// on every launch (a host call the step's enqueue paid each time).
template <class Dist>
cudaError_t reserve_smem(size_t smem) {
  static int set_bytes[kMaxDevices] = {};
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= static_cast<size_t>(set_bytes[dev]))
    return cudaSuccess;
  err = cudaFuncSetAttribute(expand_kernel<Dist>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices)
    set_bytes[dev] = static_cast<int>(smem);
  return err;
}

template <class Dist>
int launch(const Dist& dist, size_t extra_floats, const Step& s) {
  if (s.Q == 0) return 0;
  int P = 1;
  while (P < s.C) P <<= 1;
  const size_t ex_floats = (extra_floats + 3) & ~static_cast<size_t>(3);
  size_t smem = (ex_floats + 2 * (size_t)s.C) * sizeof(float);
  if (s.C > kWarpSortC) smem += (size_t)P * (sizeof(float) + sizeof(int));
  const cudaError_t err = reserve_smem<Dist>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<Dist><<<s.Q, Dist::kBlock, smem,
                        static_cast<cudaStream_t>(s.stream)>>>(
      dist, static_cast<const int*>(s.ids), static_cast<float*>(s.out_d),
      static_cast<int*>(s.out_i), static_cast<float*>(s.out_best),
      static_cast<int*>(s.out_ties), s.C, P, s.T, s.W,
      static_cast<int>(ex_floats));
  return static_cast<int>(cudaGetLastError());
}

// The warp-resident step, C <= 128.
template <class Dist>
int launch_warps(const Dist& dist, const Step& s, size_t tab_floats) {
  if (s.Q == 0) return 0;
  const bool vec_ids = s.C % 4 == 0 && aligned(s.ids, 16);
  const bool vec_out = s.T % 4 == 0 && aligned(s.out_d, 16) &&
                       aligned(s.out_i, 16);
  const unsigned int blocks = (s.Q + kStepWarps - 1) / kStepWarps;
  warp_step_kernel<Dist><<<blocks, 32 * kStepWarps,
                           kStepWarps * tab_floats * sizeof(float),
                           static_cast<cudaStream_t>(s.stream)>>>(
      dist, static_cast<const int*>(s.ids), static_cast<float*>(s.out_d),
      static_cast<int*>(s.out_i), static_cast<float*>(s.out_best),
      static_cast<int*>(s.out_ties), s.Q, s.C, s.T, s.W,
      static_cast<int>(tab_floats), vec_ids, vec_out);
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
  const Step s{ids, out_d, out_i, out_best, out_ties, Q, C, T, W, stream};
  const float* lf = static_cast<const float*>(lut);
  const unsigned char* c = static_cast<const unsigned char*>(codes);
  const bool vec8 = (m % 16 == 0) && aligned(codes, 8);
  const bool lut16 = aligned(lut, 16);
  // the warp-resident step where its tables fit the default shared memory
  // of a block (m <= 192 at 4 warps a block)
  if (C <= kWarpSortC &&
      (size_t)kStepWarps * m * 16 * sizeof(float) <= kDefaultSmem)
    return vec8 ? launch_warps(Pq4WarpDist<true>{lf, c, m, lut16}, s,
                               (size_t)m * 16)
                : launch_warps(Pq4WarpDist<false>{lf, c, m, lut16}, s,
                               (size_t)m * 16);
  return launch(Pq4Dist{lf, c, m, vec8 ? 1 : 0}, (size_t)m * 16, s);
}

extern "C" int fused_expand_bin_u32(const void* qcodes, const void* codes,
                                    const void* ids, void* out_d, void* out_i,
                                    void* out_best, void* out_ties, int Q,
                                    int C, int T, int W, int nw,
                                    void* stream) {
  const Step s{ids, out_d, out_i, out_best, out_ties, Q, C, T, W, stream};
  const unsigned int* qw = static_cast<const unsigned int*>(qcodes);
  const unsigned int* cw = static_cast<const unsigned int*>(codes);
  // a count of 32 * nw bits stays below kBinInvalid
  if (C <= kWarpSortC && 32LL * nw < kBinInvalid) {
    switch (nw) {
      case 3: return launch_warps(BinWarpDist<3>{qw, cw, nw}, s, 0);
      case 4: return launch_warps(BinWarpDist<4>{qw, cw, nw}, s, 0);
      case 7: return launch_warps(BinWarpDist<7>{qw, cw, nw}, s, 0);
      default: return launch_warps(BinWarpDist<0>{qw, cw, nw}, s, 0);
    }
  }
  return launch(BinDist{qw, cw, nw}, (size_t)nw, s);
}
