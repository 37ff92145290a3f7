// fused_expand: one beam-search step's candidate block, gathered, scored,
// sorted and cut to the T = min(L, C) best, in one kernel.
//
// Replaces the Pallas kernel `fused_expand` of the JAX package
// (src/repro/kernels/traverse_step.py, epilogue `_finalize`). For each
// query, over the C = W*M flat candidate ids (expansion w owns positions
// [w*M, (w+1)*M)):
//   d[j]      = gather_dist distance of ids[j], +inf where ids[j] < 0;
//   (sd, si)  = stable ascending sort of (d, ids), first T kept, ids -1
//               where sd is not finite;
//   bests[w]  = min over expansion w's M entries of the unsorted d;
//   ties[w]   = number of entries of expansions w' < w whose d == bests[w].
//
// Bound on this card: bytes, as for gather_dist (Q*C*d*4 gathered bytes;
// the sort is C*log^2(C) compare-exchanges in shared memory per query).
// Design: one block per query. Its warps compute the C distances into
// shared memory (one warp per candidate, 16-byte lane loads, shuffle
// reduction), then the block runs a bitonic sort over (distance, original
// position) pairs padded to a power of two P >= C with (+inf, position >=
// C). The position key makes every key distinct, so the network's result
// is exactly the stable sort of jax.lax.sort(is_stable=True). The minima
// and tie counts are read from the unsorted copy before the sort. C may be
// up to 4096 (P*8 + C*4 + d*4 bytes of shared memory).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool pair_less(float ka, int pa, float kb, int pb) {
  return ka < kb || (ka == kb && pa < pb);
}

__global__ void fused_expand_kernel(const float* __restrict__ q,
                                    const float* __restrict__ db,
                                    const int* __restrict__ ids,
                                    float* __restrict__ out_d,
                                    int* __restrict__ out_i,
                                    float* __restrict__ out_best,
                                    int* __restrict__ out_ties,
                                    int C, int P, int T, int W, int d,
                                    int metric, int vec4) {
  extern __shared__ float smem[];
  float* keys = smem;                                   // P
  int* pos = reinterpret_cast<int*>(keys + P);          // P
  float* unsorted = reinterpret_cast<float*>(pos + P);  // C
  float* qs = unsorted + C;                             // d

  const int qi = blockIdx.x;
  const int* idrow = ids + (size_t)qi * C;
  const float* qrow = q + (size_t)qi * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = qrow[k];
  __syncthreads();

  // ---- distances: one warp per candidate ----
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = warp; j < C; j += kWarps) {
    const int id = idrow[j];
    float acc = 0.f;
    if (id >= 0) {
      const float* row = db + (size_t)id * d;
      if (vec4) {
        const float4* r4 = reinterpret_cast<const float4*>(row);
        const float4* q4 = reinterpret_cast<const float4*>(qs);
        for (int k = lane; k < (d >> 2); k += 32) {
          float4 r = __ldg(r4 + k);
          float4 v = q4[k];
          if (metric == 0) {
            float a = r.x - v.x, b = r.y - v.y, c = r.z - v.z, e = r.w - v.w;
            acc += a * a + b * b + c * c + e * e;
          } else {
            acc += r.x * v.x + r.y * v.y + r.z * v.z + r.w * v.w;
          }
        }
      } else {
        for (int k = lane; k < d; k += 32) {
          float r = __ldg(row + k);
          if (metric == 0) {
            float a = r - qs[k];
            acc += a * a;
          } else {
            acc += r * qs[k];
          }
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      float v = id >= 0 ? (metric == 0 ? acc : -acc) : CUDART_INF_F;
      unsorted[j] = v;
      keys[j] = v;
      pos[j] = j;
    }
  }
  for (int j = C + threadIdx.x; j < P; j += blockDim.x) {
    keys[j] = CUDART_INF_F;
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

}  // namespace

extern "C" int fused_expand_f32(const void* q, const void* db, const void* ids,
                                void* out_d, void* out_i, void* out_best,
                                void* out_ties, int Q, int C, int T, int W,
                                int d, int metric, void* stream) {
  if (Q == 0) return 0;
  int P = 1;
  while (P < C) P <<= 1;
  size_t smem = (size_t)P * (sizeof(float) + sizeof(int)) +
                (size_t)C * sizeof(float) + (size_t)d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the query row follows P keys, P positions and C floats: 16-byte
  // aligned whenever C % 4 == 0 (P is a power of two >= 4 then)
  int vec4 = (d % 4 == 0) && (C % 4 == 0) &&
             ((reinterpret_cast<size_t>(db) & 15) == 0);
  fused_expand_kernel<<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(db),
      static_cast<const int*>(ids), static_cast<float*>(out_d),
      static_cast<int*>(out_i), static_cast<float*>(out_best),
      static_cast<int*>(out_ties), C, P, T, W, d, metric, vec4);
  return static_cast<int>(cudaGetLastError());
}
