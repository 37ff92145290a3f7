// pq_adc: PQ asymmetric distance of gathered codes against each query's
// lookup table.
//
// Replaces the Pallas kernel `pq_adc` of the JAX package
// (src/repro/kernels/pq_adc.py). Semantics, for (Q, m, K) f32 tables,
// (n, m) u8 codes and (Q, B) int32 ids:
//   out[q, b] = sum_j lut[q, j, codes[ids[q, b], j]]     (j = 0 .. m-1)
//   summed from +0.0 in order, as the plain version sums;
//   out[q, b] = +inf where ids[q, b] < 0 (nothing is loaded).
// The TPU kernel turns the table walk into a one-hot contraction on its
// matrix unit; that is a TPU layout and does not carry over. Here each
// table entry a code hits is read from device memory by index.
//
// Bound on this card: bytes, and the latency of a dependent chain. Each
// valid id needs its m code bytes (one 32-byte sector at m=16) and, per
// subspace, the table sector its code hits: about 265 of a query's 512
// table sectors at B=24, m=16, K=256 (8.5 of 16 KB). A distance is three
// dependent trips to device memory (id, then code row, then entries).
// Design: one thread a (query, candidate) pair, the Q*B pairs laid flat
// over blocks of kThreads (no thread idles for any B, several queries a
// block, no barrier). A thread loads its id, its code row (one 16-byte
// load per 16 subspaces when rows are 16-byte aligned, bytes otherwise),
// then issues every table load of a group of kChunk subspaces through the
// read-only path before it adds any (distances.cuh, thread_adc_ldg). No
// table is staged: only the sectors the codes hit are read, and nothing
// bounds m*K. A bulk prefetch of the block's whole tables to L2 beside
// the id and code loads measured slower (it reads every sector; PERF.md §6).
#include "distances.cuh"

namespace {

constexpr int kThreads = 64;   // (query, candidate) pairs a block
constexpr int kChunk = 16;     // subspaces whose table loads are in flight

__global__ void __launch_bounds__(kThreads) pq_adc_kernel(
    const float* __restrict__ lut, const unsigned char* __restrict__ codes,
    const int* __restrict__ ids, float* __restrict__ out, int total, int B,
    int m, int K, int vec16) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int id = __ldg(ids + i);
  const float* lrow = lut + (size_t)(i / B) * m * K;
  out[i] = id >= 0 ? kbest::thread_adc_ldg<kChunk>(codes, id, lrow, m, K,
                                                   vec16 != 0)
                   : CUDART_INF_F;
}

}  // namespace

extern "C" int pq_adc_u8(const void* lut, const void* codes, const void* ids,
                         void* out, int Q, int B, int m, int K, void* stream) {
  if (Q == 0 || B == 0) return 0;
  if ((long long)Q * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = Q * B;
  int vec16 = (m % 16 == 0) && ((reinterpret_cast<size_t>(codes) & 15) == 0);
  pq_adc_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const unsigned char*>(codes),
      static_cast<const int*>(ids), static_cast<float*>(out), total, B, m, K,
      vec16);
  return static_cast<int>(cudaGetLastError());
}
