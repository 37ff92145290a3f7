// bin_dist: Hamming distance of gathered 1-bit sign codes to each query's
// code, popcount(q XOR code) over nw 32-bit words, as an exact f32 count.
//
// Replaces the Pallas kernel `bin_dist` of the JAX package
// (src/repro/kernels/bin_hamming.py). Semantics, for (Q, nw) query words,
// (n, nw) code words (bit b of word w is rotated dimension 32w + b; tail
// bits zero on both sides) and (Q, B) int32 ids:
//   out[q, b] = sum_w popcount(qcodes[q, w] ^ codes[ids[q, b], w])
//   out[q, b] = +inf where ids[q, b] < 0 (nothing is loaded).
// The TPU kernel counts bits with a SWAR shift-and-mask ladder on its
// vector unit; here each word is one __popc.
//
// Bound on this card: bytes. A candidate's row is nw*4 bytes (12 B at
// d=96: one 32-byte sector, two where the row straddles a sector
// boundary), its id 4 and its distance 4 more; the integer work is three
// operations a word.
// Design: no staging and no block per query: one thread per (query,
// candidate) pair, 256 to a block, each reading its query's words (shared
// by the B threads of one query, so served from L1) and its candidate's
// row through the read-only path (distances.cuh, thread_hamming).
#include "distances.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void bin_dist_kernel(const unsigned int* __restrict__ qcodes,
                                const unsigned int* __restrict__ codes,
                                const int* __restrict__ ids,
                                float* __restrict__ out, long long total,
                                int B, int nw) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int id = ids[i];
  const unsigned int* qw = qcodes + (i / B) * nw;
  out[i] = id >= 0 ? kbest::thread_hamming(codes, id, qw, nw) : CUDART_INF_F;
}

}  // namespace

extern "C" int bin_dist_u32(const void* qcodes, const void* codes,
                            const void* ids, void* out, int Q, int B, int nw,
                            void* stream) {
  const long long total = (long long)Q * B;
  if (total == 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  bin_dist_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned int*>(qcodes),
      static_cast<const unsigned int*>(codes), static_cast<const int*>(ids),
      static_cast<float*>(out), total, B, nw);
  return static_cast<int>(cudaGetLastError());
}
