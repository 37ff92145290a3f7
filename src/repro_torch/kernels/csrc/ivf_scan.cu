// ivf_scan, pq4_ivf_scan: the IVF list scans over PQ codes. For each
// (query, probe) pair, every slot of inverted list probe_ids[q, p] is
// scored, slots whose id is -1 count as +inf, and the list is cut to its
// own L best in the stable order (distance, then slot; -0.0 before +0.0),
// ids -1 where the distance is not finite. (The Hamming scan has a kernel
// of its own, bin_ivf_scan.cu.)
//
// Replaces the Pallas kernels `ivf_scan` (src/repro/kernels/ivf_scan.py)
// and `pq4_ivf_scan` (src/repro/kernels/pq4_scan.py); their semantic spec
// is `ivf_scan_ref` and `pq4_ivf_scan_ref` in src/repro/kernels/ref.py.
// The TPU's one-hot MXU product is its form of a table read and is not
// carried over: a slot's distance is the shared per-candidate code of
// distances.cuh (thread_adc, thread_adc4), summed over j = 0 .. m-1 in
// order.
//
// Bound on this card: bytes. The probed lists' ids and code rows (16 B a
// slot for PQ8 at m=16 and for PQ4 at m=32), the query's table (16 KB for
// PQ8 at m=16, 2 KB for PQ4 at m=32) and the (Q, P, L) outputs; a batch
// of 1,000 queries probes most lists, so a call reads each list about P
// times over from L2.
//
// Design: one block per (query, probe), one functor per code kind (as
// traverse_step.cu). The functor stages the query's table (its p-th one
// when Pl = P) in shared memory. The top-L is a radix select, not a sort
// of the list, because max_len follows the data (the longest list,
// padded) and may exceed what a block can sort: every slot's distance is
// mapped to an order-preserving 32-bit key, kept in shared memory when
// max_len fits there (recomputed on each pass otherwise), four 8-bit
// histogram passes find the key T of the L-th smallest, one ordered pass
// takes the keys below T and the first slots (in slot order) equal to T,
// and a bitonic sort of those (key, slot) pairs, all distinct, gives the
// stable order. L above kMaxSort is done in rounds of kMaxSort, each
// selecting above the last round's largest pair. So the result equals the
// stable sort for any max_len and any L <= max_len.
#include <stdint.h>

#include "distances.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;      // one 8-bit digit of a key
constexpr int kMaxSort = 4096;  // (key, slot) pairs a round sorts

// order-preserving image of a float: -0.0 before +0.0, +inf above all
// finite values, as sortable_keys in core/build.py orders them
__device__ __forceinline__ unsigned int sort_key(float d) {
  const unsigned int b = __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ---- functors: stage(ex, qi, pi, P) then dist(ex, row), row being
// list * max_len + slot, a row of the (nlist * max_len, width) codes ----
struct PqScan {
  const float* luts;            // (Q, Pl, m, K)
  const unsigned char* codes;   // (nlist, max_len, m)
  int m, K, per_probe, vec16;
  __device__ void stage(float* ex, int qi, int pi, int P) const {
    const size_t t = per_probe ? (size_t)qi * P + pi : (size_t)qi;
    const float* lut = luts + t * m * K;
    for (int k = threadIdx.x; k < m * K; k += blockDim.x) ex[k] = lut[k];
  }
  __device__ float dist(const float* ex, int row) const {
    return kbest::thread_adc(codes, row, ex, m, K, vec16 != 0);
  }
};

struct Pq4Scan {
  const float* luts;            // (Q, Pl, m, 16)
  const unsigned char* codes;   // (nlist, max_len, m/2), two codes a byte
  int m, per_probe, vec8;
  __device__ void stage(float* ex, int qi, int pi, int P) const {
    const size_t t = per_probe ? (size_t)qi * P + pi : (size_t)qi;
    const float* lut = luts + t * m * 16;
    for (int k = threadIdx.x; k < m * 16; k += blockDim.x) ex[k] = lut[k];
  }
  __device__ float dist(const float* ex, int row) const {
    return kbest::thread_adc4(codes, row, ex, m, vec8 != 0);
  }
};

// ---- the scan: one block per (query, probe) ----
template <class Dist, bool kCached>
__global__ void scan_kernel(Dist dist, const int* __restrict__ list_ids,
                            const int* __restrict__ probe_ids,
                            float* __restrict__ out_d,
                            int* __restrict__ out_i, int nlist, int max_len,
                            int P, int L, int staged) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* pairs = smem;  // kMaxSort at most
  const int cap = min(L, kMaxSort);
  int cap2 = 1;
  while (cap2 < cap) cap2 <<= 1;
  unsigned int* hist = reinterpret_cast<unsigned int*>(pairs + cap2);
  int* wcount = reinterpret_cast<int*>(hist + kBins);  // kWarps
  int* sel = wcount + kWarps;                          // 4 ints
  float* ex = reinterpret_cast<float*>(sel + 4);       // the functor's
  unsigned int* cache = reinterpret_cast<unsigned int*>(ex + staged);

  const int b = blockIdx.x;
  const int qi = b / P, pi = b - qi * P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int list = probe_ids[b];
  const bool ok = list >= 0 && list < nlist;      // else: an empty list
  const int* lid = list_ids + (size_t)(ok ? list : 0) * max_len;
  const int row0 = (ok ? list : 0) * max_len;

  dist.stage(ex, qi, pi, P);
  __syncthreads();
  auto compute = [&](int s) -> unsigned int {
    const int id = ok ? __ldg(lid + s) : -1;
    return sort_key(id >= 0 ? dist.dist(ex, row0 + s) : CUDART_INF_F);
  };
  if (kCached) {
    for (int s = threadIdx.x; s < max_len; s += blockDim.x)
      cache[s] = compute(s);
    __syncthreads();
  }
  auto key_of = [&](int s) -> unsigned int {
    return kCached ? cache[s] : compute(s);
  };

  float* od = out_d + (size_t)b * L;
  int* oi = out_i + (size_t)b * L;
  // the pairs already written lie at or below `prev`; candidates above it
  unsigned long long prev = 0;
  bool have_prev = false;
  for (int written = 0; written < L;) {
    const int want = min(cap, L - written);
    // ---- radix select: T, the key of the want-th smallest candidate ----
    unsigned int prefix = 0, mask = 0;
    int rank = want;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[i] = 0;
      __syncthreads();
      for (int s = threadIdx.x; s < max_len; s += blockDim.x) {
        const unsigned int k = key_of(s);
        const unsigned long long pk = ((unsigned long long)k << 32) | s;
        if ((!have_prev || pk > prev) && (k & mask) == prefix)
          atomicAdd(&hist[(k >> shift) & (kBins - 1)], 1u);
      }
      __syncthreads();
      if (warp == 0) {
        int c[kBins / 32];
        int sum = 0;
#pragma unroll
        for (int j = 0; j < kBins / 32; ++j) {
          c[j] = hist[lane * (kBins / 32) + j];
          sum += c[j];
        }
        int inc = sum;
        for (int off = 1; off < 32; off <<= 1) {
          const int n = __shfl_up_sync(0xffffffffu, inc, off);
          if (lane >= off) inc += n;
        }
        const unsigned int hit = __ballot_sync(0xffffffffu, inc >= rank);
        if (lane == __ffs(hit) - 1) {
          int acc = inc - sum;
          for (int j = 0; j < kBins / 32; ++j) {
            if (acc + c[j] >= rank) {
              sel[0] = lane * (kBins / 32) + j;
              sel[1] = rank - acc;
              break;
            }
            acc += c[j];
          }
        }
      }
      __syncthreads();
      prefix |= (unsigned int)sel[0] << shift;
      mask |= (unsigned int)(kBins - 1) << shift;
      rank = sel[1];
    }
    // ---- take the keys below T, then the first `rank` slots equal to T
    // in slot order (their order among themselves is the stable one) ----
    const unsigned int T = prefix;
    const int n_below = want - rank;
    if (threadIdx.x == 0) sel[2] = 0;
    __syncthreads();
    int eq_seen = 0;
    for (int base = 0; base < max_len; base += blockDim.x) {
      const int s = base + threadIdx.x;
      bool below = false, eq = false;
      unsigned long long pk = 0;
      if (s < max_len) {
        const unsigned int k = key_of(s);
        pk = ((unsigned long long)k << 32) | s;
        const bool cand = !have_prev || pk > prev;
        below = cand && k < T;
        eq = cand && k == T;
      }
      if (below) pairs[atomicAdd(&sel[2], 1)] = pk;
      const unsigned int bal = __ballot_sync(0xffffffffu, eq);
      if (lane == 0) wcount[warp] = __popc(bal);
      __syncthreads();
      int off = eq_seen, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) off += wcount[w];
        total += wcount[w];
      }
      const int r = off + __popc(bal & ((1u << lane) - 1u));
      if (eq && r < rank) pairs[n_below + r] = pk;
      eq_seen += total;
      __syncthreads();
    }
    // ---- bitonic sort of the `want` distinct pairs, padded with ~0 ----
    int w2 = 1;
    while (w2 < want) w2 <<= 1;
    for (int i = want + threadIdx.x; i < w2; i += blockDim.x)
      pairs[i] = ~0ull;
    __syncthreads();
    for (int k = 2; k <= w2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < w2; i += blockDim.x) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long a = pairs[i], c = pairs[ixj];
            if ((a > c) == ((i & k) == 0)) {
              pairs[i] = c;
              pairs[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int t = threadIdx.x; t < want; t += blockDim.x) {
      const unsigned long long pk = pairs[t];
      const float v = key_float((unsigned int)(pk >> 32));
      od[written + t] = v;
      oi[written + t] =
          isfinite(v) ? lid[(int)(pk & 0xffffffffu)] : -1;
    }
    prev = pairs[want - 1];
    have_prev = true;
    written += want;
    __syncthreads();
  }
}

template <class Dist, bool kCached>
int go(const Dist& dist, int staged, size_t smem, const void* list_ids,
       const void* probe_ids, void* out_d, void* out_i, int Q, int P,
       int nlist, int max_len, int L, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<Dist, kCached>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<Dist, kCached>
      <<<Q * P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          dist, static_cast<const int*>(list_ids),
          static_cast<const int*>(probe_ids), static_cast<float*>(out_d),
          static_cast<int*>(out_i), nlist, max_len, P, L, staged);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory: the sort's pairs, the histogram, the functor's staging
// (`staged` 4-byte words) and, when it all fits the block's opt-in limit,
// one key per slot.
template <class Dist>
int launch(const Dist& dist, int staged, const void* list_ids,
           const void* probe_ids, void* out_d, void* out_i, int Q, int P,
           int nlist, int max_len, int L, void* stream) {
  if (Q == 0 || P == 0) return 0;
  if (L < 1 || L > max_len) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int cap2 = 1;
  while (cap2 < min(L, kMaxSort)) cap2 <<= 1;
  const size_t base = (size_t)cap2 * sizeof(unsigned long long) +
                      (kBins + kWarps + 4 + (size_t)staged) * 4;
  const size_t cached = base + (size_t)max_len * 4;
  if (cached <= (size_t)optin)
    return go<Dist, true>(dist, staged, cached, list_ids, probe_ids, out_d,
                          out_i, Q, P, nlist, max_len, L, stream);
  if (base <= (size_t)optin)
    return go<Dist, false>(dist, staged, base, list_ids, probe_ids, out_d,
                           out_i, Q, P, nlist, max_len, L, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int ivf_scan_u8(const void* luts, const void* codes,
                           const void* list_ids, const void* probe_ids,
                           void* out_d, void* out_i, int Q, int P, int nlist,
                           int max_len, int L, int Pl, int m, int K,
                           void* stream) {
  int vec16 = (m % 16 == 0) && ((reinterpret_cast<size_t>(codes) & 15) == 0);
  PqScan dist{static_cast<const float*>(luts),
              static_cast<const unsigned char*>(codes), m, K, Pl != 1 ? 1 : 0,
              vec16};
  return launch(dist, m * K, list_ids, probe_ids, out_d, out_i, Q, P, nlist,
                max_len, L, stream);
}

extern "C" int pq4_ivf_scan_u8(const void* luts, const void* codes,
                               const void* list_ids, const void* probe_ids,
                               void* out_d, void* out_i, int Q, int P,
                               int nlist, int max_len, int L, int Pl, int m,
                               void* stream) {
  int vec8 = (m % 16 == 0) && ((reinterpret_cast<size_t>(codes) & 7) == 0);
  Pq4Scan dist{static_cast<const float*>(luts),
               static_cast<const unsigned char*>(codes), m, Pl != 1 ? 1 : 0,
               vec8};
  return launch(dist, m * 16, list_ids, probe_ids, out_d, out_i, Q, P, nlist,
                max_len, L, stream);
}
