// gather_dist: per-(query, candidate) distance to a gathered database row.
//
// Replaces the Pallas kernel `gather_dist` of the JAX package
// (src/repro/kernels/gather_dist.py), which gathers one row per grid step
// through a scalar-prefetched index map. Semantics:
//   out[q, j] = sum_k (db[ids[q, j], k] - q[k])^2        (metric 0, l2)
//   out[q, j] = -sum_k db[ids[q, j], k] * q[k]            (metric 1, ip)
//   out[q, j] = +inf where ids[q, j] < 0 (nothing is loaded).
//
// Bound on this card: bytes. Each distance reads one d-float row that
// lies anywhere in the (n, d) database (Q*M*d*4 bytes gathered), and does
// 2*d flops on it (0.5 flop per byte), far below the H100's fp32 balance
// point of 67 TFLOP/s over 3.35 TB/s = 20 flop per byte.
// Design: one warp per (query, candidate). The lanes stride over the row
// with 16-byte loads (d % 4 == 0) so a 96-float row is one coalesced
// 384-byte request, then a shuffle reduction. The block's 8 warps serve 8
// candidates of one query, whose row stays in shared memory. Many warps in
// flight (Q*M of them) hide the latency of the random row reads.
#include <cuda_runtime.h>
#include <math_constants.h>

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
  float acc = 0.f;
  if (id >= 0) {
    const float* row = db + (size_t)id * d;
    if (kVec4) {
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
    float v = metric == 0 ? acc : -acc;
    out[(size_t)qi * M + j] = id >= 0 ? v : CUDART_INF_F;
  }
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
