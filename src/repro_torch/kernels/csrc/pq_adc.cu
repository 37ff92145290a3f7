// pq_adc: PQ asymmetric distance of gathered codes against each query's
// lookup table.
//
// Replaces the Pallas kernel `pq_adc` of the JAX package
// (src/repro/kernels/pq_adc.py). Semantics, for (Q, m, K) f32 tables,
// (n, m) u8 codes and (Q, B) int32 ids:
//   out[q, b] = sum_j lut[q, j, codes[ids[q, b], j]]     (j = 0 .. m-1)
//   out[q, b] = +inf where ids[q, b] < 0 (nothing is loaded).
// The TPU kernel turns the table walk into a one-hot contraction on its
// matrix unit; that is a TPU layout and does not carry over. Here the
// table is read from shared memory by index.
//
// Bound on this card: bytes. Each query's table is m*K*4 bytes (16 KB at
// m=16, K=256) and is read once; each candidate adds its m code bytes.
// At the graph search's B = 8..24 candidates a query the tables are
// nearly all of the bytes moved (16.4 MB of 17 MB at Q=1000, B=24): the
// first thing a faster version has to cut.
// Design: one block per query. Its 256 threads stage the query's table in
// shared memory with coalesced loads, then each thread scores one
// candidate: one 16-byte load of its codes at m=16 and m table reads from
// shared memory (distances.cuh, thread_adc). Shared memory: m*K*4 bytes.
#include "distances.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void pq_adc_kernel(const float* __restrict__ lut,
                              const unsigned char* __restrict__ codes,
                              const int* __restrict__ ids,
                              float* __restrict__ out, int B, int m, int K,
                              int vec16) {
  extern __shared__ float ls[];
  const int qi = blockIdx.x;
  const float* lrow = lut + (size_t)qi * m * K;
  for (int k = threadIdx.x; k < m * K; k += blockDim.x) ls[k] = lrow[k];
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int id = ids[(size_t)qi * B + b];
    out[(size_t)qi * B + b] =
        id >= 0 ? kbest::thread_adc(codes, id, ls, m, K, vec16 != 0)
                : CUDART_INF_F;
  }
}

}  // namespace

extern "C" int pq_adc_u8(const void* lut, const void* codes, const void* ids,
                         void* out, int Q, int B, int m, int K, void* stream) {
  if (Q == 0 || B == 0) return 0;
  size_t smem = (size_t)m * K * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pq_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int vec16 = (m % 16 == 0) && ((reinterpret_cast<size_t>(codes) & 15) == 0);
  pq_adc_kernel<<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const unsigned char*>(codes),
      static_cast<const int*>(ids), static_cast<float*>(out), B, m, K, vec16);
  return static_cast<int>(cudaGetLastError());
}
