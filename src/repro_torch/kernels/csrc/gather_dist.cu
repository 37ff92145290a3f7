// gather_dist and sq_gather_dist: per-(query, candidate) distance to a
// gathered database row, over f32 rows or over u8 SQ codes.
//
// gather_dist replaces the Pallas kernel `gather_dist` of the JAX package
// (src/repro/kernels/gather_dist.py), which gathers one row per grid step
// through a scalar-prefetched index map. Semantics:
//   out[q, j] = sum_k (db[ids[q, j], k] - q[k])^2        (metric 0, l2)
//   out[q, j] = -sum_k db[ids[q, j], k] * q[k]            (metric 1, ip)
//   out[q, j] = +inf where ids[q, j] < 0 (no row is loaded).
// sq_gather_dist replaces `sq_gather_dist` of the same file: the same,
// with each row dequantized as codes[id, k] * scale[k] + zero[k].
//
// Bound on this card: bytes, and the latency of a dependent chain. Each
// distance reads one row that lies anywhere in the database (d*4 bytes
// for f32, d bytes for SQ codes) and does 2*d flops (3*d for SQ) on it:
// 0.5 flop per byte for f32, 3 for SQ, both far below the H100's fp32
// balance point of 67 TFLOP/s over 3.35 TB/s = 20 flop per byte. A
// distance is two dependent trips to device memory (the id, then the
// row): at the traversal's sizes (Q*M = 8,000-24,000 pairs) a call is
// about one such chain plus the rows' transfer, and at re-rank depths
// (M = 640) the rows' transfer alone.
//
// Design: the Q*M (query, candidate) pairs laid flat, with no shared
// memory and no barrier. A group of kLanes lanes scores kCands
// consecutive candidates of one query (a work item); the items are laid
// over blocks, several queries a block, and each kernel's constants
// below make a batch of 1,000 queries at M=24 resident in one wave. A
// lane loads its items' ids and, in the same breath, the query values of
// the units it owns (SQ: with the scale and zero) through the read-only
// path: they do not depend on the ids, the 1,000 query rows stay in L2,
// and scale and zero in L1; a value serves all kCands candidates. Then it
// issues every row unit it owns, for every candidate, before its first
// FMA, so an item waits for one row trip; a segmented shuffle of
// log2(kLanes) steps ends each candidate. Rows are read in the widest
// unit their size and alignment allow (float4 for f32; for SQ 4-byte
// words, or single bytes where the codes are not 4-byte aligned, code
// bytes made floats exactly by a byte permute; distances.cuh), enough
// units a lane that a group covers a d=96 row in one pass; any other d or
// an unaligned row runs the same loop more times. With 8 lanes and the
// fused step's units, a candidate's f32 terms run in fused_expand's order
// (traverse_step.cu): a gathered f32 distance equals the fused step's bit
// for bit. Q*M beyond 2^31 - 1 is refused (cudaErrorInvalidValue).
#include "distances.cuh"

namespace {

// Per kernel: lanes a group (a power of two, at most 32), the candidates
// of one query a group scores, threads a block, and the blocks an SM must
// hold at once (__launch_bounds__). Chosen by sweeping them with
// benchmarks/torch_kernel_variants.py --source gather_dist.
constexpr int kF32Lanes = 8, kF32Cands = 2, kF32Threads = 256,
              kF32MinBlocks = 4;
constexpr int kSqLanes = 8, kSqCands = 2, kSqThreads = 64, kSqMinBlocks = 1;

constexpr bool lanes_ok(int g) {
  return g > 0 && g <= 32 && (g & (g - 1)) == 0;
}
static_assert(lanes_ok(kF32Lanes) && lanes_ok(kSqLanes),
              "lanes a group: a power of two, at most a warp");
static_assert(kF32Threads % 32 == 0 && kSqThreads % 32 == 0,
              "whole warps a block");
static_assert(kF32Cands >= 1 && kSqCands >= 1, "candidates a group");

// Units a lane loads a pass so that `lanes` lanes cover n units at once,
// at most cap.
constexpr int per_lane(int n, int lanes, int cap) {
  return (n + lanes - 1) / lanes < cap ? (n + lanes - 1) / lanes : cap;
}

__device__ __forceinline__ float4 ldg4(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// f32 rows: U floats a unit (4: d % 4 == 0 and 16-byte aligned rows;
// 1), V units a lane a pass. qvec: the query rows are 16-byte aligned.
template <int U, int V, bool IP>
struct F32Rows {
  using Unit = typename kbest::F32Unit<U>::T;
  static constexpr int kLanes = kF32Lanes, kCands = kF32Cands,
                       kThreads = kF32Threads, kMinBlocks = kF32MinBlocks;
  static constexpr bool kNegate = IP;
  const float* q;
  const float* db;
  int d, qvec;
  __device__ Unit query(const float* qrow, int u) const {
    if constexpr (U == 1) return __ldg(qrow + u);
    else return ldg4(qrow + 4 * u, qvec != 0);
  }
  // This lane's (gl's) share of each candidate's sum; no row is read for
  // an id < 0. A candidate's terms run over its units in order.
  __device__ void partial(const int (&id)[kCands], int qi, int gl,
                          float (&acc)[kCands]) const {
    const int nu = d / U;
    const float* qrow = q + (size_t)qi * d;
    for (int u0 = 0; u0 < nu; u0 += kLanes * V) {
      Unit qv[V], r[kCands][V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int u = u0 + gl + kLanes * v;
        qv[v] = u < nu ? query(qrow, u) : Unit{};
      }
#pragma unroll
      for (int b = 0; b < kCands; ++b) {
        const Unit* row =
            reinterpret_cast<const Unit*>(db + (size_t)id[b] * d);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int u = u0 + gl + kLanes * v;
          r[b][v] = id[b] >= 0 && u < nu ? __ldg(row + u) : Unit{};
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (u0 + gl + kLanes * v < nu) {
#pragma unroll
          for (int b = 0; b < kCands; ++b)
            kbest::f32_unit<IP>(r[b][v], qv[v], acc[b]);
        }
      }
    }
  }
};

// SQ codes: UB bytes a unit (4: d % 4 == 0 and 4-byte aligned rows, a
// code word; 1: a byte), V units a lane a pass. A lane loads the query,
// scale and zero values of a pass's units before its codes (they do not
// depend on the ids). fvec: query, scale and zero 16-byte aligned.
template <int UB, int V, bool IP>
struct SqRows {
  using Val = typename kbest::F32Unit<UB>::T;   // a unit's values
  static constexpr int kLanes = kSqLanes, kCands = kSqCands,
                       kThreads = kSqThreads, kMinBlocks = kSqMinBlocks;
  static constexpr bool kNegate = IP;
  const float* q;
  const unsigned char* codes;
  const float* scale;
  const float* zero;
  int d, fvec;
  __device__ Val ld(const float* p, int u) const {
    if constexpr (UB == 1) return __ldg(p + u);
    else return ldg4(p + 4 * u, fvec != 0);
  }
  __device__ void partial(const int (&id)[kCands], int qi, int gl,
                          float (&acc)[kCands]) const {
    const int nu = d / UB;
    const float* qrow = q + (size_t)qi * d;
    for (int u0 = 0; u0 < nu; u0 += kLanes * V) {
      Val qv[V], s[V], z[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int u = u0 + gl + kLanes * v;
        if (u < nu) {
          qv[v] = ld(qrow, u);
          s[v] = ld(scale, u);
          z[v] = ld(zero, u);
        }
      }
      unsigned int c[kCands][V];
#pragma unroll
      for (int b = 0; b < kCands; ++b) {
        const unsigned char* row = codes + (size_t)id[b] * d;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int u = u0 + gl + kLanes * v;
          const bool on = id[b] >= 0 && u < nu;
          if constexpr (UB == 1) c[b][v] = on ? __ldg(row + u) : 0u;
          else c[b][v] = on ? __ldg(reinterpret_cast<const unsigned int*>(
                                        row) + u)
                            : 0u;
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (u0 + gl + kLanes * v >= nu) continue;
#pragma unroll
        for (int b = 0; b < kCands; ++b) {
          if constexpr (UB == 1)
            kbest::sq_term(kbest::code_at(c[b][v], 0), s[v], z[v], qv[v],
                           IP ? 1 : 0, acc[b]);
          else
            kbest::sq_word<IP>(c[b][v], qv[v], s[v], z[v], acc[b]);
        }
      }
    }
  }
};

// One group of Rows::kLanes lanes a work item w: candidates j0 .. j0 +
// kCands - 1 (those < M) of query qi, where w = qi * MC + j0 / kCands and
// MC = ceil(M / kCands).
template <class Rows>
__global__ void __launch_bounds__(Rows::kThreads, Rows::kMinBlocks)
gather_kernel(const Rows rows, const int* __restrict__ ids,
              float* __restrict__ out, int items, int M, int MC) {
  constexpr int G = Rows::kLanes, R = Rows::kCands;
  const long long w =
      (long long)blockIdx.x * (Rows::kThreads / G) + threadIdx.x / G;
  if (w >= items) return;
  const int qi = static_cast<int>(w) / MC;
  const int j0 = (static_cast<int>(w) - qi * MC) * R;
  const size_t base = (size_t)qi * M + j0;
  const int gl = threadIdx.x & (G - 1);
  int id[R];
  float acc[R];
#pragma unroll
  for (int b = 0; b < R; ++b) {
    id[b] = j0 + b < M ? __ldg(ids + base + b) : -1;
    acc[b] = 0.f;
  }
  rows.partial(id, qi, gl, acc);
  if constexpr (G > 1) {
    const unsigned mask = (G == 32 ? 0xffffffffu : (1u << G) - 1u)
                          << ((threadIdx.x & 31) & ~(G - 1));
#pragma unroll
    for (int b = 0; b < R; ++b) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        acc[b] += __shfl_xor_sync(mask, acc[b], off);
    }
  }
  if (gl == 0) {
#pragma unroll
    for (int b = 0; b < R; ++b)
      if (j0 + b < M)
        out[base + b] = id[b] < 0 ? CUDART_INF_F
                                  : (Rows::kNegate ? -acc[b] : acc[b]);
  }
}

template <class Rows>
int launch(const Rows& rows, const void* ids, void* out, int Q, int M,
           void* stream) {
  if (Q == 0 || M == 0) return 0;
  if ((long long)Q * M > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int MC = (M + Rows::kCands - 1) / Rows::kCands;
  const int items = Q * MC;
  constexpr int kItems = Rows::kThreads / Rows::kLanes;
  const unsigned int blocks =
      static_cast<unsigned int>(((long long)items + kItems - 1) / kItems);
  gather_kernel<Rows><<<blocks, Rows::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      rows, static_cast<const int*>(ids), static_cast<float*>(out), items, M,
      MC);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<size_t>(p) & (bytes - 1)) == 0;
}

template <int U, int V>
int launch_f32(const float* q, const float* db, int d, int metric,
               const void* ids, void* out, int Q, int M, void* stream) {
  const int qvec = aligned(q, 16);
  if (metric == 0)
    return launch(F32Rows<U, V, false>{q, db, d, qvec}, ids, out, Q, M,
                  stream);
  return launch(F32Rows<U, V, true>{q, db, d, qvec}, ids, out, Q, M, stream);
}

// A d=96 row in one pass: 96 / UB units over the group's lanes.
template <int UB>
int launch_sq(const float* q, const unsigned char* codes, const float* scale,
              const float* zero, int d, int metric, const void* ids,
              void* out, int Q, int M, void* stream) {
  constexpr int V = per_lane(96 / UB, kSqLanes, 96);
  const int fvec = aligned(q, 16) && aligned(scale, 16) && aligned(zero, 16);
  if (metric == 0)
    return launch(SqRows<UB, V, false>{q, codes, scale, zero, d, fvec}, ids,
                  out, Q, M, stream);
  return launch(SqRows<UB, V, true>{q, codes, scale, zero, d, fvec}, ids,
                out, Q, M, stream);
}

}  // namespace

extern "C" int gather_dist_f32(const void* q, const void* db, const void* ids,
                               void* out, int Q, int M, int d, int metric,
                               void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* dbf = static_cast<const float*>(db);
  constexpr int G = kF32Lanes;
  // as the fused step's units: float4 where d % 4 == 0 and the rows are
  // 16-byte aligned (one pass at d <= 96, 128 floats a pass above), else
  // floats, 96 a pass (12 a lane at most)
  if (d % 4 != 0 || !aligned(db, 16))
    return launch_f32<1, per_lane(96, G, 12)>(qf, dbf, d, metric, ids, out,
                                              Q, M, stream);
  if (d > 96)
    return launch_f32<4, per_lane(32, G, 32)>(qf, dbf, d, metric, ids, out,
                                              Q, M, stream);
  return launch_f32<4, per_lane(24, G, 24)>(qf, dbf, d, metric, ids, out, Q,
                                            M, stream);
}

extern "C" int sq_gather_dist_u8(const void* q, const void* codes,
                                 const void* scale, const void* zero,
                                 const void* ids, void* out, int Q, int M,
                                 int d, int metric, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const unsigned char* c = static_cast<const unsigned char*>(codes);
  const float* sf = static_cast<const float*>(scale);
  const float* zf = static_cast<const float*>(zero);
  // code words where d % 4 == 0 and the rows are 4-byte aligned (4-byte
  // words of 8 lanes beat 16-byte units of 2 lanes; PERF.md), else bytes
  if (d % 4 == 0 && aligned(codes, 4))
    return launch_sq<4>(qf, c, sf, zf, d, metric, ids, out, Q, M, stream);
  return launch_sq<1>(qf, c, sf, zf, d, metric, ids, out, Q, M, stream);
}
