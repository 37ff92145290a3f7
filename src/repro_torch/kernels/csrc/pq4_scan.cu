// pq4_adc: 4-bit PQ asymmetric distance of gathered nibble-packed codes
// against each query's (m, 16) lookup table.
//
// Replaces the Pallas kernel `pq4_adc` of the JAX package
// (src/repro/kernels/pq4_scan.py). Semantics, for (Q, m, 16) f32 tables,
// (n, m/2) u8 codes (byte b: subspace 2b in the low nibble, 2b+1 in the
// high one) and (Q, B) int32 ids:
//   out[q, b] = sum_j lut[q, j, code(ids[q, b], j)]     (j = 0 .. m-1)
//   out[q, b] = +inf where ids[q, b] < 0 (nothing is loaded).
// The TPU kernel keeps the table resident in VMEM and turns the walk into
// a 16-wide one-hot contraction; here the table is read from shared
// memory by index.
//
// Bound on this card: bytes. A query's table is m*16*4 bytes (1 KB at
// m=16, a sixteenth of PQ8's), each candidate's code row m/2 bytes (8 B,
// one 32-byte sector). At the graph search's B = 8..24 candidates a query
// the table sectors the codes hit and the code sectors are of one size.
// Design: one block of 64 threads per query stages its table in shared
// memory (four coalesced loads a thread at m=16), then each thread scores
// one candidate: one 8-byte load of its codes and m table reads
// (distances.cuh, thread_adc4). Shared memory: m*16*4 bytes.
#include "distances.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void pq4_adc_kernel(const float* __restrict__ lut,
                               const unsigned char* __restrict__ codes,
                               const int* __restrict__ ids,
                               float* __restrict__ out, int B, int m,
                               int vec8) {
  extern __shared__ float ls[];
  const int qi = blockIdx.x;
  const float* lrow = lut + (size_t)qi * m * 16;
  for (int k = threadIdx.x; k < m * 16; k += blockDim.x) ls[k] = lrow[k];
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int id = ids[(size_t)qi * B + b];
    out[(size_t)qi * B + b] =
        id >= 0 ? kbest::thread_adc4(codes, id, ls, m, vec8 != 0)
                : CUDART_INF_F;
  }
}

}  // namespace

extern "C" int pq4_adc_u8(const void* lut, const void* codes, const void* ids,
                          void* out, int Q, int B, int m, void* stream) {
  if (Q == 0 || B == 0) return 0;
  size_t smem = (size_t)m * 16 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pq4_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int vec8 = (m % 16 == 0) && ((reinterpret_cast<size_t>(codes) & 7) == 0);
  pq4_adc_kernel<<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const unsigned char*>(codes),
      static_cast<const int*>(ids), static_cast<float*>(out), B, m, vec8);
  return static_cast<int>(cudaGetLastError());
}
