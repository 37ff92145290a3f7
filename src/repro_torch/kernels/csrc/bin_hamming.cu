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
// vector unit; here each word is one __popc, counted in an int and
// converted once.
//
// Bound on this card: bytes in principle, a fixed chain in practice. A
// candidate's row is nw*4 bytes (12 B at d=96: one 32-byte sector, two
// where the row straddles a sector boundary), its id 4 and its distance 4
// more: 0.0003 ms for a batch of 1,000 at B=24. On the H100 a one-element
// kernel replayed in a CUDA graph takes 0.0013-0.0014 ms, this kernel on
// ids that are all -1 (the launch, the id trip, the store) 0.0020, and
// with 5% -1 0.0019-0.0022: the row trip adds about 0.0002.
// Design: one thread a (query, candidate) pair, the Q*B pairs laid flat
// over blocks of kThreads, no shared memory and no barrier. A thread
// loads its id and its query's words together, then every word of its
// row at once: nw is a template argument at nw = 3, 4 and 7 (d = 96, 128,
// 200), and other nw run chunks of kWords words, each load predicated on
// nw. So a distance is one id trip and one row trip, whatever nw. 128
// threads a block were the fastest or tied at every phase-2 shape; 32 to
// 256 threads, and items of 2 candidates of one query a thread (their ids
// as one int2), were within 0.0003 ms; items of 4 were slower (fewer
// threads in flight, more registers).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;   // threads (pairs) a block
constexpr int kWords = 8;       // words a pass of the general path

// NW > 0: exactly NW words a row; NW = 0: nw words, kWords a pass.
template <int NW>
__global__ void __launch_bounds__(kThreads) bin_dist_kernel(
    const unsigned int* __restrict__ qcodes,
    const unsigned int* __restrict__ codes, const int* __restrict__ ids,
    float* __restrict__ out, long long total, int B, int nw) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int id = __ldg(ids + i);
  constexpr int kW = NW > 0 ? NW : kWords;
  const int n = NW > 0 ? NW : nw;
  const unsigned int* qrow = qcodes + (i / B) * n;
  const unsigned int* row = codes + (size_t)max(id, 0) * n;
  int acc = 0;
  for (int w0 = 0; w0 < n; w0 += kW) {    // one pass when NW > 0
    unsigned int q[kW], r[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const bool on = NW > 0 || w0 + w < n;
      q[w] = on ? __ldg(qrow + w0 + w) : 0u;
      r[w] = on && id >= 0 ? __ldg(row + w0 + w) : 0u;
    }
#pragma unroll
    for (int w = 0; w < kW; ++w) acc += __popc(q[w] ^ r[w]);
  }
  out[i] = id >= 0 ? static_cast<float>(acc) : CUDART_INF_F;
}

template <int NW>
int launch(const void* qcodes, const void* codes, const void* ids, void* out,
           long long total, int B, int nw, void* stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  bin_dist_kernel<NW><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned int*>(qcodes),
      static_cast<const unsigned int*>(codes), static_cast<const int*>(ids),
      static_cast<float*>(out), total, B, nw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bin_dist_u32(const void* qcodes, const void* codes,
                            const void* ids, void* out, int Q, int B, int nw,
                            void* stream) {
  const long long total = (long long)Q * B;
  if (total == 0) return 0;
  switch (nw) {
    case 3: return launch<3>(qcodes, codes, ids, out, total, B, nw, stream);
    case 4: return launch<4>(qcodes, codes, ids, out, total, B, nw, stream);
    case 7: return launch<7>(qcodes, codes, ids, out, total, B, nw, stream);
    default: return launch<0>(qcodes, codes, ids, out, total, B, nw, stream);
  }
}
