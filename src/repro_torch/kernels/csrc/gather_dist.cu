// gather_dist and sq_gather_dist: per-(query, candidate) distance to a
// gathered database row, over f32 rows or over u8 SQ codes.
//
// gather_dist replaces the Pallas kernel `gather_dist` of the JAX package
// (src/repro/kernels/gather_dist.py), which gathers one row per grid step
// through a scalar-prefetched index map. Semantics:
//   out[q, j] = sum_k (db[ids[q, j], k] - q[k])^2        (metric 0, l2)
//   out[q, j] = -sum_k db[ids[q, j], k] * q[k]            (metric 1, ip)
//   out[q, j] = +inf where ids[q, j] < 0 (nothing is loaded).
// sq_gather_dist replaces `sq_gather_dist` of the same file: the same,
// with each row dequantized as codes[id, k] * scale[k] + zero[k].
//
// Bound on this card: bytes. Each distance reads one row that lies
// anywhere in the database (d*4 bytes for f32, d bytes for SQ codes) and
// does 2*d flops (3*d for SQ) on it: 0.5 flop per byte for f32, 3 for SQ,
// both far below the H100's fp32 balance point of 67 TFLOP/s over
// 3.35 TB/s = 20 flop per byte.
// Design: one warp per (query, candidate) (distances.cuh). For f32 the
// lanes stride over the row with 16-byte loads, so a 96-float row is one
// coalesced 384-byte request; for SQ with 4-byte loads, so a 96-byte code
// row is one 96-byte request, dequantized in registers (nvcc fuses
// code * scale + zero into one FMA). A shuffle reduction ends each. The
// block's 8 warps serve 8 candidates of one query, whose row (and the SQ
// scale and zero) stays in shared memory. Many warps in flight (Q*M of
// them) hide the latency of the random row reads.
#include "distances.cuh"

namespace {

constexpr int kWarps = 8;

template <bool kVec4>
__global__ void gather_dist_kernel(const float* __restrict__ q,
                                   const float* __restrict__ db,
                                   const int* __restrict__ ids,
                                   float* __restrict__ out,
                                   int M, int d, int metric) {
  extern __shared__ float qs[];
  const int qi = blockIdx.x;
  const float* qrow = q + (size_t)qi * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = qrow[k];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.y * kWarps + warp;
  if (j >= M) return;
  const int id = ids[(size_t)qi * M + j];
  const float v = id >= 0 ? kbest::warp_dist_f32(db, id, qs, d, metric, kVec4,
                                                  lane)
                          : CUDART_INF_F;
  if (lane == 0) out[(size_t)qi * M + j] = v;
}

__global__ void sq_gather_dist_kernel(const float* __restrict__ q,
                                      const unsigned char* __restrict__ codes,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ zero,
                                      const int* __restrict__ ids,
                                      float* __restrict__ out,
                                      int M, int d, int metric, int vec4) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ss = qs + d;
  float* zs = ss + d;
  const int qi = blockIdx.x;
  const float* qrow = q + (size_t)qi * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    qs[k] = qrow[k];
    ss[k] = scale[k];
    zs[k] = zero[k];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.y * kWarps + warp;
  if (j >= M) return;
  const int id = ids[(size_t)qi * M + j];
  const float v = id >= 0 ? kbest::warp_dist_sq(codes, id, qs, ss, zs, d,
                                                 metric, vec4 != 0, lane)
                          : CUDART_INF_F;
  if (lane == 0) out[(size_t)qi * M + j] = v;
}

}  // namespace

extern "C" int gather_dist_f32(const void* q, const void* db, const void* ids,
                               void* out, int Q, int M, int d, int metric,
                               void* stream) {
  if (Q == 0 || M == 0) return 0;
  dim3 grid(Q, (M + kWarps - 1) / kWarps);
  dim3 block(kWarps * 32);
  size_t smem = (size_t)d * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool vec = (d % 4 == 0) && ((reinterpret_cast<size_t>(db) & 15) == 0);
  if (vec) {
    gather_dist_kernel<true><<<grid, block, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(db),
        static_cast<const int*>(ids), static_cast<float*>(out), M, d, metric);
  } else {
    gather_dist_kernel<false><<<grid, block, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(db),
        static_cast<const int*>(ids), static_cast<float*>(out), M, d, metric);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sq_gather_dist_u8(const void* q, const void* codes,
                                 const void* scale, const void* zero,
                                 const void* ids, void* out, int Q, int M,
                                 int d, int metric, void* stream) {
  if (Q == 0 || M == 0) return 0;
  dim3 grid(Q, (M + kWarps - 1) / kWarps);
  dim3 block(kWarps * 32);
  size_t smem = 3 * (size_t)d * sizeof(float);
  int vec4 = (d % 4 == 0) && ((reinterpret_cast<size_t>(codes) & 3) == 0);
  sq_gather_dist_kernel<<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const unsigned char*>(codes),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<const int*>(ids), static_cast<float*>(out), M, d, metric,
      vec4);
  return static_cast<int>(cudaGetLastError());
}
