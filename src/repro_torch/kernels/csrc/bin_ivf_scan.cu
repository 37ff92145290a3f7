// bin_ivf_scan: the IVF list scan by Hamming distance. For each (query,
// probe) pair, every slot of inverted list probe_ids[q, p] gets the
// Hamming distance between its nw sign words and the query's, slots whose
// id is -1 (and every slot of a probe outside [0, nlist)) count as +inf,
// and the list is cut to its own L best in the stable order (distance,
// then slot), ids -1 where the distance is +inf.
//
// Replaces the Pallas kernel `bin_ivf_scan` (src/repro/kernels/
// bin_hamming.py); its semantic spec is `bin_ivf_scan_ref` in
// src/repro/kernels/ref.py (and kernels/ref.py here).
//
// Bound on this card: bytes. The probed lists' ids and sign words (4 + 12
// B a slot at nw=3) and the (Q, P, L) outputs, 8 B an entry, which are
// most of it (590 of 611 MB at Q=1,000, P=96, L=768); the integer work is
// three operations a word.
//
// Design: a stable counting sort, one block per (query, probe). A Hamming
// distance over nw words takes one of V = 32*nw + 2 values (0 .. 32*nw,
// and V-1 for +inf), 98 at nw=3, so:
// 1. one pass over the list computes each slot's value once (a popcount
//    per word, the query's words staged in shared memory), keeps it as a
//    16-bit value in shared memory when the list fits there, and counts
//    it into a block histogram; lanes of a warp holding equal values are
//    grouped with __match_any_sync, so one atomic a group lands on the few
//    bins where Hamming values cluster;
// 2. an exclusive scan of the V counts gives each value's first output
//    position and the value T of the L-th slot;
// 3. one pass in slot order, blockDim slots at a time, places each slot of
//    value v < T, and each slot of value T while its rank is below L, at
//    the running position of v plus its rank among the equal values of
//    the lower warps of the chunk (per-warp counts, one byte per value)
//    and of the lower lanes of its warp (the match mask).
// No radix digits, no sort of pairs and no rounds, so any L <= max_len
// takes the same three steps. The placed (distance, id) pairs are
// gathered in shared memory when L fits there and written out coalesced,
// else written where they land. Values are recomputed (a popcount of the
// row) in step 3 when the list does not fit in shared memory. Blocks of
// 128 threads (16 to an SM) ran faster on the card than blocks of 256 or
// 64 (PERF.md).
#include <stdint.h>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool kCached, bool kStaged>
__global__ void __launch_bounds__(kThreads)
bin_scan_kernel(const unsigned int* __restrict__ qcodes,
                const unsigned int* __restrict__ codes,
                const int* __restrict__ list_ids,
                const int* __restrict__ probe_ids, float* __restrict__ out_d,
                int* __restrict__ out_i, int nlist, int max_len, int P, int L,
                int nw) {
  extern __shared__ uint4 smem[];
  const int V = 32 * nw + 2, kInf = V - 1, kNone = V;
  unsigned int* qw = reinterpret_cast<unsigned int*>(smem);   // nw
  int* pos = reinterpret_cast<int*>(qw + nw);                 // V
  int* wsum = pos + V;                                        // kWarps + 1
  unsigned char* cnt =
      reinterpret_cast<unsigned char*>(wsum + kWarps + 1);   // kWarps * V
  uint16_t* vals = reinterpret_cast<uint16_t*>(
      (reinterpret_cast<uintptr_t>(cnt + kWarps * V) + 15) & ~uintptr_t(15));
  float* st_d = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(vals + (kCached ? max_len : 0)) + 15) &
      ~uintptr_t(15));                                        // L if staged
  int* st_i = reinterpret_cast<int*>(st_d + L);

  const int b = blockIdx.x;
  const int qi = b / P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int list = probe_ids[b];
  const bool ok = list >= 0 && list < nlist;      // else: an empty list
  const int* lid = list_ids + (size_t)(ok ? list : 0) * max_len;
  const unsigned int* rows = codes + (size_t)(ok ? list : 0) * max_len * nw;

  for (int k = tid; k < nw; k += kThreads) qw[k] = qcodes[(size_t)qi * nw + k];
  for (int v = tid; v < V; v += kThreads) pos[v] = 0;
  for (int i = tid; i < kWarps * V; i += kThreads) cnt[i] = 0;
  __syncthreads();

  auto hamming = [&](int s) -> int {
    const unsigned int* row = rows + (size_t)s * nw;
    int h = 0;
#pragma unroll 4
    for (int w = 0; w < nw; ++w) h += __popc(qw[w] ^ __ldg(row + w));
    return h;
  };
  auto value = [&](int s) -> int {
    if (!ok || __ldg(lid + s) < 0) return kInf;
    return hamming(s);
  };

  // ---- 1. values and their histogram ----
  for (int s0 = 0; s0 < max_len; s0 += kThreads) {
    const int s = s0 + tid;
    int v = kNone;
    if (s < max_len) {
      v = value(s);
      if (kCached) vals[s] = static_cast<uint16_t>(v);
    }
    const unsigned grp = __match_any_sync(kFull, v);
    if (v != kNone && (grp & lower) == 0) atomicAdd(&pos[v], __popc(grp));
  }
  __syncthreads();

  // ---- 2. first position of each value (exclusive scan) and T ----
  {
    const int per = (V + kThreads - 1) / kThreads;
    const int lo = min(V, tid * per), hi = min(V, lo + per);
    int sum = 0;
    for (int v = lo; v < hi; ++v) sum += pos[v];
    int inc = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += n;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    int run = inc - sum;
    for (int w = 0; w < warp; ++w) run += wsum[w];
    for (int v = lo; v < hi; ++v) {
      const int h = pos[v];
      pos[v] = run;
      if (run < L && run + h >= L) wsum[kWarps] = v;
      run += h;
    }
  }
  __syncthreads();
  const int T = wsum[kWarps];

  // ---- 3. placement in slot order ----
  float* od = out_d + (size_t)b * L;
  int* oi = out_i + (size_t)b * L;
  for (int s0 = 0; s0 < max_len; s0 += kThreads) {
    const int s = s0 + tid;
    int v = kNone;
    if (s < max_len) v = kCached ? static_cast<int>(vals[s]) : value(s);
    const bool take = v <= T;
    const unsigned grp = __match_any_sync(kFull, v);
    const bool lead = (grp & lower) == 0;
    if (take && lead) cnt[warp * V + v] = static_cast<unsigned char>(__popc(grp));
    __syncthreads();
    int at = 0;
    if (take) {
      at = pos[v] + __popc(grp & lower);
      for (int w = 0; w < warp; ++w) at += cnt[w * V + v];
    }
    __syncthreads();
    if (take && lead) {
      atomicAdd(&pos[v], __popc(grp));
      cnt[warp * V + v] = 0;
    }
    __syncwarp();  // the reset lands before the warp's next count
    if (take && at < L) {
      const float dv = v == kInf ? CUDART_INF_F : static_cast<float>(v);
      const int id = v == kInf ? -1 : __ldg(lid + s);
      if (kStaged) {
        st_d[at] = dv;
        st_i[at] = id;
      } else {
        od[at] = dv;
        oi[at] = id;
      }
    }
  }
  if (kStaged) {
    __syncthreads();
    for (int k = tid; k < L; k += kThreads) {
      __stcs(od + k, st_d[k]);
      __stcs(oi + k, st_i[k]);
    }
  }
}

template <bool kCached, bool kStaged>
int go(size_t smem, const void* qcodes, const void* codes,
       const void* list_ids, const void* probe_ids, void* out_d, void* out_i,
       int Q, int P, int nlist, int max_len, int L, int nw, void* stream) {
  auto kernel = bin_scan_kernel<kCached, kStaged>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<Q * P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned int*>(qcodes),
      static_cast<const unsigned int*>(codes),
      static_cast<const int*>(list_ids), static_cast<const int*>(probe_ids),
      static_cast<float*>(out_d), static_cast<int*>(out_i), nlist, max_len,
      P, L, nw);
  return static_cast<int>(cudaGetLastError());
}

size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

}  // namespace

// Shared memory: the query's words, V positions, the warp sums and T, a
// byte per (warp, value); then, when they fit the block's opt-in limit,
// a 16-bit value per slot and the L staged (distance, id) pairs.
extern "C" int bin_ivf_scan_u32(const void* qcodes, const void* codes,
                                const void* list_ids, const void* probe_ids,
                                void* out_d, void* out_i, int Q, int P,
                                int nlist, int max_len, int L, int nw,
                                void* stream) {
  if (Q == 0 || P == 0) return 0;
  if (L < 1 || L > max_len || nw < 1 || 32 * nw + 2 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t V = 32 * (size_t)nw + 2;
  const size_t base =
      align16(((size_t)nw + V + kWarps + 1) * 4 + kWarps * V);
  const size_t cache = align16((size_t)max_len * 2);
  const size_t staged = (size_t)L * 8;
  const size_t lim = static_cast<size_t>(optin);
#define BIN_GO(c, s, bytes)                                                \
  return go<c, s>(bytes, qcodes, codes, list_ids, probe_ids, out_d, out_i, \
                  Q, P, nlist, max_len, L, nw, stream)
  if (base + cache + staged <= lim) BIN_GO(true, true, base + cache + staged);
  if (base + cache <= lim) BIN_GO(true, false, base + cache);
  if (base + staged <= lim) BIN_GO(false, true, base + staged);
  if (base <= lim) BIN_GO(false, false, base);
#undef BIN_GO
  return static_cast<int>(cudaErrorInvalidValue);
}
