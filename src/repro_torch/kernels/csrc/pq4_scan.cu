// pq4_adc: 4-bit PQ asymmetric distance of gathered nibble-packed codes
// against each query's (m, 16) lookup table.
//
// Replaces the Pallas kernel `pq4_adc` of the JAX package
// (src/repro/kernels/pq4_scan.py). Semantics, for (Q, m, 16) f32 tables,
// (n, m/2) u8 codes (byte b: subspace 2b in the low nibble, 2b+1 in the
// high one) and (Q, B) int32 ids:
//   out[q, b] = sum_j lut[q, j, code(ids[q, b], j)]     (j = 0 .. m-1)
//   summed from +0.0 in order, as the plain version sums;
//   out[q, b] = +inf where ids[q, b] < 0 (nothing is loaded).
// The TPU kernel keeps the table resident in VMEM and turns the walk into
// a 16-wide one-hot contraction; here each entry is read by index.
//
// Bound on this card: bytes, and the latency of a dependent chain. A
// query's table is m*16*4 bytes (1 KB at m=16, a sixteenth of PQ8's),
// each candidate's code row m/2 bytes (8 B, one 32-byte sector); at the
// graph search's B = 8..24 candidates a query the codes hit nearly every
// table sector. A distance is the chain id -> code row -> entries.
// Design: one thread a (query, candidate) pair, the Q*B pairs laid flat
// over blocks of kThreads (no thread idles for any B, several queries a
// block, no barrier). A thread loads its id, its code row (one 8-byte
// load per 16 subspaces when rows are 8-byte aligned, bytes otherwise),
// then every table entry of a chunk of kChunk subspaces through the
// read-only path before it adds any (distances.cuh, thread_adc4_ldg). A
// query's table is reused by its B candidates from L1 and L2. Staging the
// block's tables in shared memory by cp.async beside the id and code
// loads, or prefetching them to L2, measured no faster (PERF.md §6).
#include "distances.cuh"

namespace {

constexpr int kThreads = 64;   // (query, candidate) pairs a block
constexpr int kChunk = 16;     // subspaces whose table loads are in flight

__global__ void __launch_bounds__(kThreads) pq4_adc_kernel(
    const float* __restrict__ lut, const unsigned char* __restrict__ codes,
    const int* __restrict__ ids, float* __restrict__ out, int total, int B,
    int m, int vec8) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int id = __ldg(ids + i);
  const float* lrow = lut + (size_t)(i / B) * m * 16;
  out[i] = id >= 0 ? kbest::thread_adc4_ldg<kChunk>(codes, id, lrow, m,
                                                    vec8 != 0)
                   : CUDART_INF_F;
}

}  // namespace

extern "C" int pq4_adc_u8(const void* lut, const void* codes, const void* ids,
                          void* out, int Q, int B, int m, void* stream) {
  if (Q == 0 || B == 0) return 0;
  if ((long long)Q * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = Q * B;
  int vec8 = (m % 16 == 0) && ((reinterpret_cast<size_t>(codes) & 7) == 0);
  pq4_adc_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const unsigned char*>(codes),
      static_cast<const int*>(ids), static_cast<float*>(out), total, B, m,
      vec8);
  return static_cast<int>(cudaGetLastError());
}
