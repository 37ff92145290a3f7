// fused_expand, fused_expand_sq, fused_expand_pq: one beam-search step's
// candidate block, gathered, scored, sorted and cut to the T = min(L, C)
// best, in one kernel, over f32 rows, SQ codes or PQ codes.
//
// Replaces the Pallas kernels `fused_expand`, `fused_expand_sq` and
// `fused_expand_pq` of the JAX package (src/repro/kernels/traverse_step.py,
// shared epilogue `_finalize`). For each query, over the C = W*M flat
// candidate ids (expansion w owns positions [w*M, (w+1)*M)):
//   d[j]      = the candidate's distance (gather_dist, sq_gather_dist or
//               pq_adc arithmetic), +inf where ids[j] < 0;
//   (sd, si)  = stable ascending sort of (d, ids), first T kept, ids -1
//               where sd is not finite;
//   bests[w]  = min over expansion w's M entries of the unsorted d;
//   ties[w]   = number of entries of expansions w' < w whose d == bests[w].
//
// Bound on this card: bytes. The gathered rows (Q*C*d*4 bytes for f32,
// Q*C*d for SQ, Q*C*m for PQ) and, for PQ, the query's (m, K) f32 LUT
// (16 KB a query at m=16, K=256: most of the PQ step's bytes); the sort is
// C*log^2(C) compare-exchanges in shared memory per query.
// Design: one block per query. A distance functor stages what the query
// needs in shared memory (its row; its row, scale and zero; its LUT) and
// scores the C candidates into shared memory: one warp a candidate for
// f32 and SQ, one thread a candidate for PQ (distances.cuh). One epilogue
// template, the same for every functor, then reads the minima and tie
// counts from the unsorted block and runs a bitonic sort over (distance,
// original position) pairs padded to a power of two P >= C with (+inf,
// position >= C). The position key makes every key distinct, so the
// network's result is exactly the stable sort of
// jax.lax.sort(is_stable=True). Shared memory: P*8 + C*4 bytes plus the
// functor's staging (d*4, d*12 or m*K*4 bytes); C may be up to 4096.
#include "distances.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool pair_less(float ka, int pa, float kb, int pb) {
  return ka < kb || (ka == kb && pa < pb);
}

// ---- distance functors: stage(ex, qi) then score(ex, idrow, C, out) ----
struct F32Dist {
  const float* q;
  const float* db;
  int d, metric, vec4;
  __device__ void stage(float* ex, int qi) const {
    const float* qrow = q + (size_t)qi * d;
    for (int k = threadIdx.x; k < d; k += blockDim.x) ex[k] = qrow[k];
  }
  __device__ void score(const float* ex, const int* idrow, int C,
                        float* out) const {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int j = warp; j < C; j += kWarps) {
      const int id = idrow[j];
      const float v = id >= 0 ? kbest::warp_dist_f32(db, id, ex, d, metric,
                                                      vec4 != 0, lane)
                              : CUDART_INF_F;
      if (lane == 0) out[j] = v;
    }
  }
};

struct SqDist {
  const float* q;
  const unsigned char* codes;
  const float* scale;
  const float* zero;
  int d, metric, vec4;
  __device__ void stage(float* ex, int qi) const {
    const float* qrow = q + (size_t)qi * d;
    for (int k = threadIdx.x; k < d; k += blockDim.x) {
      ex[k] = qrow[k];
      ex[d + k] = scale[k];
      ex[2 * d + k] = zero[k];
    }
  }
  __device__ void score(const float* ex, const int* idrow, int C,
                        float* out) const {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int j = warp; j < C; j += kWarps) {
      const int id = idrow[j];
      const float v = id >= 0 ? kbest::warp_dist_sq(codes, id, ex, ex + d,
                                                     ex + 2 * d, d, metric,
                                                     vec4 != 0, lane)
                              : CUDART_INF_F;
      if (lane == 0) out[j] = v;
    }
  }
};

struct PqDist {
  const float* lut;            // (Q, m, K)
  const unsigned char* codes;  // (n, m)
  int m, K, vec16;
  __device__ void stage(float* ex, int qi) const {
    const float* lrow = lut + (size_t)qi * m * K;
    for (int k = threadIdx.x; k < m * K; k += blockDim.x) ex[k] = lrow[k];
  }
  __device__ void score(const float* ex, const int* idrow, int C,
                        float* out) const {
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const int id = idrow[j];
      out[j] = id >= 0 ? kbest::thread_adc(codes, id, ex, m, K, vec16 != 0)
                       : CUDART_INF_F;
    }
  }
};

// ---- the shared epilogue: minima, tie counts, bitonic sort, top T ----
template <class Dist>
__global__ void expand_kernel(Dist dist, const int* __restrict__ ids,
                              float* __restrict__ out_d,
                              int* __restrict__ out_i,
                              float* __restrict__ out_best,
                              int* __restrict__ out_ties,
                              int C, int P, int T, int W) {
  extern __shared__ float smem[];
  float* keys = smem;                                   // P
  int* pos = reinterpret_cast<int*>(keys + P);          // P
  float* unsorted = reinterpret_cast<float*>(pos + P);  // C
  float* ex = unsorted + C;                             // the functor's

  const int qi = blockIdx.x;
  const int* idrow = ids + (size_t)qi * C;
  dist.stage(ex, qi);
  __syncthreads();
  dist.score(ex, idrow, C, unsorted);
  __syncthreads();
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    keys[j] = j < C ? unsorted[j] : CUDART_INF_F;
    pos[j] = j;
  }
  __syncthreads();

  // ---- per-expansion minima and earlier-expansion tie counts ----
  const int M = C / W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    float best = CUDART_INF_F;
    for (int j = w * M; j < (w + 1) * M; ++j) best = fminf(best, unsorted[j]);
    int ties = 0;
    for (int j = 0; j < w * M; ++j) ties += unsorted[j] == best;
    out_best[(size_t)qi * W + w] = best;
    out_ties[(size_t)qi * W + w] = ties;
  }

  // ---- bitonic sort of (key, position), ascending ----
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
    out_d[(size_t)qi * T + t] = v;
    out_i[(size_t)qi * T + t] = isfinite(v) ? idrow[pos[t]] : -1;
  }
}

template <class Dist>
int launch(const Dist& dist, size_t extra_floats, const void* ids,
           void* out_d, void* out_i, void* out_best, void* out_ties, int Q,
           int C, int T, int W, void* stream) {
  if (Q == 0) return 0;
  int P = 1;
  while (P < C) P <<= 1;
  size_t smem = (size_t)P * (sizeof(float) + sizeof(int)) +
                ((size_t)C + extra_floats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      expand_kernel<Dist>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<Dist><<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dist, static_cast<const int*>(ids), static_cast<float*>(out_d),
      static_cast<int*>(out_i), static_cast<float*>(out_best),
      static_cast<int*>(out_ties), C, P, T, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_expand_f32(const void* q, const void* db, const void* ids,
                                void* out_d, void* out_i, void* out_best,
                                void* out_ties, int Q, int C, int T, int W,
                                int d, int metric, void* stream) {
  // the query row follows P keys, P positions and C floats: 16-byte
  // aligned whenever C % 4 == 0 (P is a power of two >= 4 then)
  int vec4 = (d % 4 == 0) && (C % 4 == 0) &&
             ((reinterpret_cast<size_t>(db) & 15) == 0);
  F32Dist dist{static_cast<const float*>(q), static_cast<const float*>(db), d,
               metric, vec4};
  return launch(dist, d, ids, out_d, out_i, out_best, out_ties, Q, C, T, W,
                stream);
}

extern "C" int fused_expand_sq_u8(const void* q, const void* codes,
                                  const void* scale, const void* zero,
                                  const void* ids, void* out_d, void* out_i,
                                  void* out_best, void* out_ties, int Q, int C,
                                  int T, int W, int d, int metric,
                                  void* stream) {
  int vec4 = (d % 4 == 0) && ((reinterpret_cast<size_t>(codes) & 3) == 0);
  SqDist dist{static_cast<const float*>(q),
              static_cast<const unsigned char*>(codes),
              static_cast<const float*>(scale),
              static_cast<const float*>(zero), d, metric, vec4};
  return launch(dist, 3 * (size_t)d, ids, out_d, out_i, out_best, out_ties, Q,
                C, T, W, stream);
}

extern "C" int fused_expand_pq_u8(const void* lut, const void* codes,
                                  const void* ids, void* out_d, void* out_i,
                                  void* out_best, void* out_ties, int Q, int C,
                                  int T, int W, int m, int K, void* stream) {
  int vec16 = (m % 16 == 0) && ((reinterpret_cast<size_t>(codes) & 15) == 0);
  PqDist dist{static_cast<const float*>(lut),
              static_cast<const unsigned char*>(codes), m, K, vec16};
  return launch(dist, (size_t)m * K, ids, out_d, out_i, out_best, out_ties, Q,
                C, T, W, stream);
}
