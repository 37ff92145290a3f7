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
// order, one thread a slot.
//
// Bound on this card: bytes. The probed lists' ids and code rows (16 B a
// slot for PQ8 at m=16 and for PQ4 at m=32), the query's table (16 KB for
// PQ8 at m=16, 2 KB for PQ4 at m=32) and the (Q, P, L) outputs; a batch
// of 1,000 queries probes most lists, so a call reads each list about P
// times over from L2. Below that bound lies a floor of shared-memory
// wavefronts: every valid slot reads m table entries, and a warp's PQ8
// reads of one 256-entry row land about 3.5 to a bank (random codes).
//
// Design: a block walks kProbesPerBlock probes of one query, one after
// the other, so a table shared by the probes (Pl = 1) is staged once; with
// Pl = P each probe's table is staged in turn. Per probe, with the list's
// keys in shared memory and L <= kFastL (every served preset), six
// steps and no sort of the list:
// 1. one scoring pass: the warps take the list in chunks of
//    32 * kScoreBatch slots; a lane reads the ids of its kScoreBatch
//    slots, then sums their codes as independent chains (thread_adc_n,
//    each sum thread_adc's), so one warp waits for one round trip and one
//    sum's latency a chunk, not one a slot. Each distance becomes an
//    order-preserving 32-bit key, kept in shared memory; the keys below
//    +inf's (finite distances, -inf, negative NaNs) are counted by their
//    top kDigitBits bits, one shared-memory atomic a key (grouping a
//    warp's equal bins by __match_any_sync first ran slower on the H100,
//    PERF.md). Padding and hole slots (+inf) are not counted:
//    they are taken only when a list has fewer than L finite slots, and
//    then all give (+inf, -1);
// 2. a scan of that histogram (one barrier) finds the bin b1 holding the
//    L-th key;
// 3. one pass appends the keys of lower bins, as (key, slot) pairs, to the
//    survivors. When those bins and b1 hold at most kFastL keys, b1's keys
//    join them and step 4 is skipped (the sort keeps the first L); else
//    b1's go to a small candidate buffer (when they would be more than
//    kCandCap, the cached keys serve as the source);
// 4. 8-bit digits of the 64-bit (key, slot) pairs of bin b1 are counted
//    until the pairs to take are known, from below the bits all of them
//    share. The pairs are distinct, so equal keys go by slot, the stable
//    order. When b1's keys are all equal (a tie storm), its first slots in
//    slot order are taken by a count of each warp's share of the list;
// 5. the taken pairs of bin b1 join the survivors, and the next probe's
//    histogram, counters and table are made ready;
// 6. each warp sorts a run of 32 survivors in registers (a bitonic
//    network of __shfl_xor_sync exchanges), and a survivor's output place
//    is its place in its run plus a binary search in each other run; a
//    warp that has written its survivors starts on the next probe.
// The block's barriers: 5 a probe, and 2 more a refinement round.
// Larger L, lists too long for shared memory and lists shorter than L that
// hold NaN keys above +inf take the general path, a branch of the same
// kernel: four 8-bit histogram passes over every key find the key T of
// the L-th smallest, one ordered pass takes the keys below T and the
// first slots (in slot order) equal to T, and a bitonic sort in shared
// memory orders those pairs; L above kMaxSort is done in rounds of
// kMaxSort, each selecting above the last round's largest pair. So the
// result equals the stable sort for any max_len and any L <= max_len.
#include <stdint.h>

#include "distances.cuh"

namespace {

using u64 = unsigned long long;

// The design's choices (benchmarks/torch_kernel_variants.py sweeps them):
// threads a block; probes of one query a block walks; the slots a lane
// scores as independent sums; bits of the first digit; candidate pairs
// buffered; the blocks an SM must hold at once (__launch_bounds__, which
// caps a thread's registers).
constexpr int kThreads = 256;
constexpr int kProbesPerBlock = 4;
constexpr int kScoreBatch = 4;
constexpr int kDigitBits = 11;
constexpr int kCandCap = 256;
constexpr int kMinBlocks = 5;

constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;                   // an 8-bit digit
constexpr int kDigitBins = 1 << kDigitBits;
constexpr int kFastHist = kDigitBins + 3 * kBins;  // + 3 refinement rows
constexpr int kFastL = 256;                  // L of the fast path: 8 runs
constexpr int kMaxSort = 4096;               // (key, slot) pairs a round sorts
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kKeyInf = 0xff800000u;    // sort_key(+inf)
static_assert(kThreads % 32 == 0 && kThreads >= kBins && kFastL <= kThreads,
              "block shape: a warp a run of 32 survivors");
static_assert(kCandCap % 2 == 0, "16-byte aligned histogram");
static_assert(kDigitBits >= 8 && kDigitBins <= 32 * kThreads,
              "first digit: at most 32 bins a thread");

// order-preserving image of a float: -0.0 before +0.0, +inf above all
// finite values, as sortable_keys in core/build.py orders them
__device__ __forceinline__ unsigned int sort_key(float d) {
  const unsigned int b = __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ---- functors: stage(ex, t) the t-th (m, K) table, then dist(ex, row),
// row being list * max_len + slot, a row of the (nlist * max_len, width)
// codes; dist_n(ex, row, on, out) the same sums for U rows at once ----
struct PqScan {
  const float* luts;            // (Q, Pl, m, K)
  const unsigned char* codes;   // (nlist, max_len, m)
  int m, K, vec16;
  __device__ void stage(float* ex, size_t t) const {
    const float* lut = luts + t * m * K;
    for (int k = threadIdx.x; k < m * K; k += kThreads) ex[k] = lut[k];
  }
  __device__ float dist(const float* ex, int row) const {
    return kbest::thread_adc(codes, row, ex, m, K, vec16 != 0);
  }
  template <int U>
  __device__ void dist_n(const float* ex, const int (&row)[U],
                         const bool (&on)[U], float (&out)[U]) const {
    kbest::thread_adc_n<U>(codes, row, on, ex, m, K, vec16 != 0, out);
  }
};

struct Pq4Scan {
  const float* luts;            // (Q, Pl, m, 16)
  const unsigned char* codes;   // (nlist, max_len, m/2), two codes a byte
  int m, vec8;
  __device__ void stage(float* ex, size_t t) const {
    const float* lut = luts + t * m * 16;
    for (int k = threadIdx.x; k < m * 16; k += kThreads) ex[k] = lut[k];
  }
  __device__ float dist(const float* ex, int row) const {
    return kbest::thread_adc4(codes, row, ex, m, vec8 != 0);
  }
  template <int U>
  __device__ void dist_n(const float* ex, const int (&row)[U],
                         const bool (&on)[U], float (&out)[U]) const {
    kbest::thread_adc4_n<U>(codes, row, on, ex, m, vec8 != 0, out);
  }
};

__device__ __forceinline__ int warp_scan(int v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += n;
  }
  return v;
}

// Appends v of the lanes with `in` set to dst at *n, one atomic a warp.
// Every lane of the warp calls it.
__device__ __forceinline__ void append(u64* dst, int* n, u64 v, bool in,
                                       int lane, unsigned int lower) {
  const unsigned int bal = __ballot_sync(kFull, in);
  if (bal == 0) return;
  int at = 0;
  if (lane == 0) at = atomicAdd(n, __popc(bal));
  at = __shfl_sync(kFull, at, 0);
  if (in) dst[at + __popc(bal & lower)] = v;
}

struct Sel {
  int bin, below, count, total;
};

// The bin of a histogram of `nbins` counts (a power of two) that holds
// the rank-th smallest entry (rank >= 1): its number, the entries in lower
// bins, its count, and the total; bin = nbins when the total is below
// rank. Block-wide with one barrier; each warp reads the result from the
// thread sums itself, so every thread returns it. tsum (kThreads ints) and
// wsum (kWarps) are scratch, free again after the caller's next barrier.
__device__ Sel find_bin(const unsigned int* hist, int nbins, int rank,
                        int* tsum, int* wsum) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = nbins > kThreads ? nbins / kThreads : 1;
  int sum = 0;
  if (per % 4 == 0) {                 // 16-byte reads of a thread's bins
    for (int j = 0; j < per; j += 4) {
      const uint4 h4 = *reinterpret_cast<const uint4*>(hist + t * per + j);
      sum += static_cast<int>(h4.x + h4.y + h4.z + h4.w);
    }
  } else if (t < nbins) {
    for (int j = 0; j < per; ++j) sum += static_cast<int>(hist[t * per + j]);
  }
  tsum[t] = sum;
  const int inc = warp_scan(sum, lane);
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int total = 0, w_at = -1, w_below = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = wsum[w];
    if (w_at < 0 && total + c >= rank) {
      w_at = w;
      w_below = total;
    }
    total += c;
  }
  if (w_at < 0) return Sel{nbins, total, 0, total};
  const int v = tsum[w_at * 32 + lane];
  const int vi = warp_scan(v, lane);
  const int l_at = __ffs(__ballot_sync(kFull, w_below + vi >= rank)) - 1;
  const int t_below = w_below + __shfl_sync(kFull, vi - v, l_at);
  const int t_at = w_at * 32 + l_at;
  const int b = t_at * per + lane;
  const int h = lane < per && b < nbins ? static_cast<int>(hist[b]) : 0;
  const int hi = warp_scan(h, lane);
  const int j_at =
      __ffs(__ballot_sync(kFull, lane < per && t_below + hi >= rank)) - 1;
  const int cnt = __shfl_sync(kFull, h, j_at);
  return Sel{t_at * per + j_at, t_below + __shfl_sync(kFull, hi, j_at) - cnt,
             cnt, total};
}

// One warp: a bitonic sort of its 32 keys, one a lane, ascending by lane,
// in registers.
__device__ __forceinline__ u64 warp_sort32(u64 k, int lane) {
#pragma unroll
  for (int kk = 2; kk <= 32; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, k, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & kk) == 0);
      k = keep_min ? (o < k ? o : k) : (o < k ? k : o);
    }
  }
  return k;
}

// The general path for one probe: the top-L of the keys key_of(s), s <
// max_len, by radix select rounds of up to kMaxSort pairs (see the head of
// the file). pairs holds the round's pairs (a power of two >= min(L,
// kMaxSort)), hist kBins counts, wcount kWarps, sel 4 ints. Ends on a
// barrier.
template <class KeyOf>
__device__ void rounds_probe(const KeyOf& key_of, u64* pairs,
                             unsigned int* hist, int* wcount, int* sel,
                             const int* lid, float* od, int* oi, int max_len,
                             int L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cap = min(L, kMaxSort);
  // the pairs already written lie at or below `prev`; candidates above it
  u64 prev = 0;
  bool have_prev = false;
  for (int written = 0; written < L;) {
    const int want = min(cap, L - written);
    // ---- radix select: T, the key of the want-th smallest candidate ----
    unsigned int prefix = 0, mask = 0;
    int rank = want;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0;
      __syncthreads();
      for (int s = threadIdx.x; s < max_len; s += kThreads) {
        const unsigned int k = key_of(s);
        const u64 pk = (static_cast<u64>(k) << 32) | s;
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
        const int inc = warp_scan(sum, lane);
        const unsigned int hit = __ballot_sync(kFull, inc >= rank);
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
      prefix |= static_cast<unsigned int>(sel[0]) << shift;
      mask |= static_cast<unsigned int>(kBins - 1) << shift;
      rank = sel[1];
    }
    // ---- take the keys below T, then the first `rank` slots equal to T
    // in slot order (their order among themselves is the stable one) ----
    const unsigned int T = prefix;
    const int n_below = want - rank;
    if (threadIdx.x == 0) sel[2] = 0;
    __syncthreads();
    int eq_seen = 0;
    for (int base = 0; base < max_len; base += kThreads) {
      const int s = base + threadIdx.x;
      bool below = false, eq = false;
      u64 pk = 0;
      if (s < max_len) {
        const unsigned int k = key_of(s);
        pk = (static_cast<u64>(k) << 32) | s;
        const bool cand = !have_prev || pk > prev;
        below = cand && k < T;
        eq = cand && k == T;
      }
      if (below) pairs[atomicAdd(&sel[2], 1)] = pk;
      const unsigned int bal = __ballot_sync(kFull, eq);
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
    for (int i = want + threadIdx.x; i < w2; i += kThreads) pairs[i] = ~0ull;
    __syncthreads();
    for (int k = 2; k <= w2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < w2; i += kThreads) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const u64 a = pairs[i], c = pairs[ixj];
            if ((a > c) == ((i & k) == 0)) {
              pairs[i] = c;
              pairs[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int t = threadIdx.x; t < want; t += kThreads) {
      const u64 pk = pairs[t];
      const float v = key_float(static_cast<unsigned int>(pk >> 32));
      od[written + t] = v;
      oi[written + t] =
          isfinite(v) ? lid[static_cast<int>(pk & 0xffffffffu)] : -1;
    }
    prev = pairs[want - 1];
    have_prev = true;
    written += want;
    __syncthreads();
  }
}

// Shared memory: pairs (kFastL on the fast path, else a power of two
// >= min(L, kMaxSort)), the candidate buffer (fast path), the histogram
// (kFastHist or kBins counts), kThreads + kWarps + 8 ints of scratch, the
// functor's `staged` floats and, when cached, one key per slot.
size_t smem_bytes(bool fast, int npairs, int staged, int cached_slots) {
  return (static_cast<size_t>(npairs) + (fast ? kCandCap + 2 : 0)) *
             sizeof(u64) +
         (static_cast<size_t>(fast ? kFastHist : kBins) + kThreads + kWarps +
          8 + staged + cached_slots) * 4;
}

// ---- the scan: a block per (query, kProbesPerBlock probes) ----
template <class Dist, bool kCached, bool kFast>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_kernel(Dist dist, const int* __restrict__ list_ids,
            const int* __restrict__ probe_ids, float* __restrict__ out_d,
            int* __restrict__ out_i, int nlist, int max_len, int P, int L,
            int staged, int per_probe) {
  extern __shared__ u64 smem[];
  int npairs = kFastL;
  if (!kFast) {
    npairs = 1;
    while (npairs < min(L, kMaxSort)) npairs <<= 1;
  }
  u64* pairs = smem;
  u64* cand = pairs + npairs;                            // kFast only
  u64* bounds = cand + (kFast ? kCandCap : 0);           // 2, kFast only
  unsigned int* hist =
      reinterpret_cast<unsigned int*>(bounds + (kFast ? 2 : 0));
  int* tsum = reinterpret_cast<int*>(hist + (kFast ? kFastHist : kBins));
  int* wsum = tsum + kThreads;                           // kWarps
  int* ctr = wsum + kWarps;                              // 8
  float* ex = reinterpret_cast<float*>(ctr + 8);         // the functor's
  unsigned int* cache = reinterpret_cast<unsigned int*>(ex + staged);

  const int groups = (P + kProbesPerBlock - 1) / kProbesPerBlock;
  const int qi = blockIdx.x / groups;
  const int p0 = (blockIdx.x - qi * groups) * kProbesPerBlock;
  const int p1 = min(P, p0 + kProbesPerBlock);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned int lower = (1u << lane) - 1u;
  auto table = [&](int p) -> size_t {
    return per_probe ? (size_t)qi * P + p : (size_t)qi;
  };

  if (!kFast) {
    if (!per_probe) dist.stage(ex, table(p0));
    for (int p = p0; p < p1; ++p) {
      const int b = qi * P + p;
      const int list = probe_ids[b];
      const bool ok = list >= 0 && list < nlist;   // else: an empty list
      const int* lid = list_ids + (size_t)(ok ? list : 0) * max_len;
      const int row0 = (ok ? list : 0) * max_len;
      if (per_probe) dist.stage(ex, table(p));
      __syncthreads();
      auto compute = [&](int s) -> unsigned int {
        const int id = ok ? __ldg(lid + s) : -1;
        return id >= 0 ? sort_key(dist.dist(ex, row0 + s)) : kKeyInf;
      };
      if (kCached) {
        for (int s = tid; s < max_len; s += kThreads) cache[s] = compute(s);
        __syncthreads();
      }
      rounds_probe([&](int s) { return kCached ? cache[s] : compute(s); },
                   pairs, hist, tsum, ctr, lid, out_d + (size_t)b * L,
                   out_i + (size_t)b * L, max_len, L);
    }
    return;
  }

  // ---- the fast path. Shared state between probes: the histogram and
  // the counters are cleared, and a per-probe table staged, at the end of
  // the probe before, so that a warp done with probe p's sort starts on
  // probe p + 1 (the warps take its slots in chunks) ----
  constexpr int kChunk = 32 * kScoreBatch;        // slots a warp takes
  for (int i = tid; i < kFastHist; i += kThreads) hist[i] = 0;
  // ctr: 0 survivors, 4 a NaN above +inf, 5 chunks taken, 6 survivors and
  // candidates of step 3; bounds: the least and largest pair of bin b1
  if (tid < 8) ctr[tid] = 0;
  if (tid == 0) {
    bounds[0] = ~0ull;
    bounds[1] = 0;
  }
  dist.stage(ex, table(p0));
  __syncthreads();
  int rot = 0;                 // refinement rows used: row rot % 3 is clear
  for (int p = p0; p < p1; ++p) {
    const int b = qi * P + p;
    const int list = probe_ids[b];
    const bool ok = list >= 0 && list < nlist;     // else: an empty list
    const int* lid = list_ids + (size_t)(ok ? list : 0) * max_len;
    const int row0 = (ok ? list : 0) * max_len;
    float* od = out_d + (size_t)b * L;
    int* oi = out_i + (size_t)b * L;
    // clears the first-digit histogram and the counters, and stages the
    // next probe's table; the caller's barrier follows
    auto ready_next = [&]() {
      for (int i = tid; i < kDigitBins; i += kThreads) hist[i] = 0;
      if (tid == 0) {
        ctr[4] = 0;
        ctr[6] = 0;
        bounds[0] = ~0ull;
        bounds[1] = 0;
      }
      if (per_probe && p + 1 < p1) dist.stage(ex, table(p + 1));
    };

    // ---- 1. keys, and the first digits of those below +inf's: a warp
    // takes kChunk slots at a time, reads their ids, then scores its
    // lane's kScoreBatch slots as independent sums ----
    for (;;) {
      int chunk = 0;
      if (lane == 0) chunk = atomicAdd(&ctr[5], 1);
      const int s0 = __shfl_sync(kFull, chunk, 0) * kChunk;
      if (s0 >= max_len) break;
      int row[kScoreBatch];
      bool on[kScoreBatch];
#pragma unroll
      for (int u = 0; u < kScoreBatch; ++u) {
        const int s = s0 + u * 32 + lane;
        on[u] = ok && s < max_len && __ldg(lid + s) >= 0;
        row[u] = row0 + s;
      }
      float d[kScoreBatch];
      dist.dist_n(ex, row, on, d);
#pragma unroll
      for (int u = 0; u < kScoreBatch; ++u) {
        const int s = s0 + u * 32 + lane;
        const unsigned int key = on[u] ? sort_key(d[u]) : kKeyInf;
        if (s < max_len) cache[s] = key;
        if (key > kKeyInf) ctr[4] = 1;             // a NaN above +inf
        if (key < kKeyInf) atomicAdd(&hist[key >> (32 - kDigitBits)], 1u);
      }
    }
    __syncthreads();
    if (tid == 0) ctr[5] = 0;
    // ---- 2. b1, the bin of the L-th key below +inf's ----
    const Sel s1 = find_bin(hist, kDigitBins, L, tsum, wsum);
    const int n_low = s1.total;
    if (n_low < L && ctr[4]) {
      // the tail would hold +inf and NaN keys in key order: general path
      __syncthreads();
      rounds_probe([&](int s) { return cache[s]; }, pairs, hist, tsum, ctr,
                   lid, od, oi, max_len, L);
      ready_next();
      __syncthreads();
      continue;
    }
    // n_low < L: b1 = kDigitBins, every key below +inf's is taken. When
    // bin b1 and the bins below it hold at most kFastL keys, all of them
    // are sorted and the first L written: no refinement
    const int b1 = s1.bin;
    const bool whole = s1.below + s1.count <= kFastL;
    const int hcnt = whole ? 0 : s1.count;
    const int need = n_low < L ? 0 : L - s1.below;
    const bool buffered = hcnt <= kCandCap;
    // ---- 3. lower bins to the survivors, bin b1 to the candidates (one
    // atomic a chunk for both: survivors in the low half, candidates in
    // the high half of ctr[6]); when bin b1 is read from the cached keys,
    // its least and largest pair bound its refinement ----
    if (tid == 0) ctr[0] = s1.below;          // step 5 appends from here
    for (int s0 = warp * kChunk; s0 < max_len; s0 += kWarps * kChunk) {
      u64 e[kScoreBatch], lo = ~0ull, hi = 0;
      unsigned int bs[kScoreBatch], bg[kScoreBatch];
      bool sure[kScoreBatch], grp[kScoreBatch], in_b1 = false;
      int ns = 0, ng = 0;
#pragma unroll
      for (int u = 0; u < kScoreBatch; ++u) {
        const int s = s0 + u * 32 + lane;
        const unsigned int key = s < max_len ? cache[s] : kKeyInf;
        const unsigned int bin = key >> (32 - kDigitBits);
        const bool low = key < kKeyInf;
        const bool at_b1 = low && bin == static_cast<unsigned>(b1);
        e[u] = (static_cast<u64>(key) << 32) | static_cast<unsigned>(s);
        sure[u] = low && (bin < static_cast<unsigned>(b1) || (whole && at_b1));
        grp[u] = !whole && buffered && at_b1;
        if (!buffered && at_b1) {
          in_b1 = true;
          lo = min(lo, e[u]);
          hi = max(hi, e[u]);
        }
        bs[u] = __ballot_sync(kFull, sure[u]);
        bg[u] = __ballot_sync(kFull, grp[u]);
        ns += __popc(bs[u]);
        ng += __popc(bg[u]);
      }
      if (ns + ng > 0) {
        int at = 0;
        if (lane == 0) at = atomicAdd(&ctr[6], ns + (ng << 16));
        at = __shfl_sync(kFull, at, 0);
        int as = at & 0xffff, ag = at >> 16;
#pragma unroll
        for (int u = 0; u < kScoreBatch; ++u) {
          if (sure[u]) pairs[as + __popc(bs[u] & lower)] = e[u];
          if (grp[u]) cand[ag + __popc(bg[u] & lower)] = e[u];
          as += __popc(bs[u]);
          ag += __popc(bg[u]);
        }
      }
      if (!buffered && __any_sync(kFull, in_b1)) {
        for (int off = 16; off > 0; off >>= 1) {
          lo = min(lo, __shfl_xor_sync(kFull, lo, off));
          hi = max(hi, __shfl_xor_sync(kFull, hi, off));
        }
        if (lane == 0) {
          atomicMin(&bounds[0], lo);
          atomicMax(&bounds[1], hi);
        }
      }
    }
    __syncthreads();
    // bin b1's pairs: from the buffer, or from the cached keys
    auto for_group = [&](auto&& fn) {
      if (buffered) {
        for (int base = 0; base < hcnt; base += kThreads) {
          const int i = base + tid;
          fn(i < hcnt ? cand[i] : 0ull, i < hcnt);
        }
      } else {
        for (int base = 0; base < max_len; base += kThreads) {
          const int s = base + tid;
          const unsigned int key = s < max_len ? cache[s] : kKeyInf;
          fn((static_cast<u64>(key) << 32) | static_cast<unsigned>(s),
             key < kKeyInf &&
                 (key >> (32 - kDigitBits)) == static_cast<unsigned>(b1));
        }
      }
    };
    // ---- 4. 8-bit digits of bin b1's pairs until `need` are known: the
    // pairs at or below `prefix` on the bits from `st` up ----
    int st = 64 - kDigitBits, rank = whole ? 0 : need, group = hcnt;
    u64 prefix = static_cast<u64>(b1) << st;
    // bin b1 read from the cached keys: its keys all equal (a tie storm),
    // or the refinement starts below the bits all its pairs share
    const bool tied = !buffered && (bounds[0] >> 32) == (bounds[1] >> 32);
    if (!buffered) {
      st = min(st, 64 - __clzll(bounds[0] ^ bounds[1]));
      prefix = bounds[0] >> st << st;
    }
    for (; rank < group && !tied; ++rot) {
      const int sh = max(st - 8, 0);
      const unsigned int nb = 1u << (st - sh);
      unsigned int* h = hist + kDigitBins + kBins * (rot % 3);
      unsigned int* next = hist + kDigitBins + kBins * ((rot + 1) % 3);
      for (int i = tid; i < kBins; i += kThreads) next[i] = 0;
      const u64 want = prefix >> st;
      for_group([&](u64 e, bool in) {
        if (in && (e >> st) == want)
          atomicAdd(&h[static_cast<unsigned int>(e >> sh) & (nb - 1)], 1u);
      });
      __syncthreads();
      const Sel s2 = find_bin(h, static_cast<int>(nb), rank, tsum, wsum);
      prefix |= static_cast<u64>(s2.bin) << sh;
      rank -= s2.below;
      group = s2.count;
      st = sh;
    }
    // ---- 5. the taken pairs of bin b1 to the survivors ----
    if (tied) {
      // the first `need` of its slots in slot order: a warp counts its
      // share of the list, then takes its slots by their rank
      constexpr int kRows = 32 * kWarps;
      const int per = (max_len + kRows - 1) / kRows * 32;
      const int s_lo = warp * per, s_hi = min(max_len, s_lo + per);
      auto member = [&](int s) {
        const unsigned int key = s < s_hi ? cache[s] : kKeyInf;
        return key < kKeyInf &&
               (key >> (32 - kDigitBits)) == static_cast<unsigned>(b1);
      };
      int n = 0;
      for (int s0 = s_lo; s0 < s_hi; s0 += 32)
        n += __popc(__ballot_sync(kFull, member(s0 + lane)));
      if (lane == 0) tsum[warp] = n;
      __syncthreads();
      int at = s1.below;
      for (int w = 0; w < warp; ++w) at += tsum[w];
      for (int s0 = s_lo; s0 < s_hi && at < L; s0 += 32) {
        const int s = s0 + lane;
        const bool in = member(s);
        const unsigned int bal = __ballot_sync(kFull, in);
        const int r = at + __popc(bal & lower);
        if (in && r < L)
          pairs[r] = (static_cast<u64>(cache[s]) << 32) |
                     static_cast<unsigned>(s);
        at += __popc(bal);
      }
    } else if (hcnt > 0) {
      const u64 last = prefix >> st;
      for_group([&](u64 e, bool in) {
        append(pairs, ctr, e, in && (e >> st) <= last, lane, lower);
      });
    }
    ready_next();
    __syncthreads();
    // ---- 6. the survivors' order: a warp sorts each run of 32 in
    // registers, then a survivor's place is its place in its run plus the
    // count of smaller pairs in each other run (a binary search) ----
    const int cnt = whole ? s1.below + s1.count : L;
    const int runs = (cnt + 31) >> 5;
    u64 k = ~0ull;
    if (warp < runs) {
      const int i = warp * 32 + lane;
      k = warp_sort32(i < cnt ? pairs[i] : ~0ull, lane);
      pairs[i] = k;
    }
    __syncthreads();
    if (k != ~0ull) {
      const float v = key_float(static_cast<unsigned int>(k >> 32));
      const int id =
          isfinite(v) ? __ldg(lid + static_cast<int>(k & 0xffffffffu)) : -1;
      int at = lane;
      for (int r = 0; r < runs; ++r) {
        if (r == warp) continue;
        const u64* run = pairs + r * 32;
        int c = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (run[c + step - 1] < k) c += step;
        at += c + (run[c] < k);
      }
      if (at < L) {
        __stcs(od + at, v);
        __stcs(oi + at, id);
      }
    }
    for (int t = cnt + tid; t < L; t += kThreads) {   // fewer than L finite
      __stcs(od + t, CUDART_INF_F);
      __stcs(oi + t, -1);
    }
  }
}

template <class Dist, bool kCached, bool kFast>
int go(const Dist& dist, int staged, size_t smem, const void* list_ids,
       const void* probe_ids, void* out_d, void* out_i, int Q, int P,
       int nlist, int max_len, int L, int per_probe, void* stream) {
  auto kernel = scan_kernel<Dist, kCached, kFast>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (P + kProbesPerBlock - 1) / kProbesPerBlock;
  kernel<<<Q * groups, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dist, static_cast<const int*>(list_ids),
      static_cast<const int*>(probe_ids), static_cast<float*>(out_d),
      static_cast<int*>(out_i), nlist, max_len, P, L, staged, per_probe);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<size_t>(p) & (bytes - 1)) == 0;
}

// The fast path when L <= kFastL and the list's keys fit the block's
// opt-in shared memory with everything else; the general path otherwise,
// with the keys cached when they fit, recomputed on each pass when not.
template <class Dist>
int launch(const Dist& dist, int staged, const void* list_ids,
           const void* probe_ids, void* out_d, void* out_i, int Q, int P,
           int nlist, int max_len, int L, int Pl, void* stream) {
  if (Q == 0 || P == 0) return 0;
  if (L < 1 || L > max_len) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t lim = static_cast<size_t>(optin);
  const int per_probe = Pl != 1 ? 1 : 0;
#define SCAN_GO(cached, fast, bytes)                                      \
  return go<Dist, cached, fast>(dist, staged, bytes, list_ids, probe_ids, \
                                out_d, out_i, Q, P, nlist, max_len, L,    \
                                per_probe, stream)
  const size_t fast = smem_bytes(true, kFastL, staged, max_len);
  if (L <= kFastL && fast <= lim) SCAN_GO(true, true, fast);
  int cap2 = 1;
  while (cap2 < min(L, kMaxSort)) cap2 <<= 1;
  const size_t cached = smem_bytes(false, cap2, staged, max_len);
  const size_t base = smem_bytes(false, cap2, staged, 0);
  if (cached <= lim) SCAN_GO(true, false, cached);
  if (base <= lim) SCAN_GO(false, false, base);
#undef SCAN_GO
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int ivf_scan_u8(const void* luts, const void* codes,
                           const void* list_ids, const void* probe_ids,
                           void* out_d, void* out_i, int Q, int P, int nlist,
                           int max_len, int L, int Pl, int m, int K,
                           void* stream) {
  int vec16 = (m % 16 == 0) && aligned(codes, 16);
  PqScan dist{static_cast<const float*>(luts),
              static_cast<const unsigned char*>(codes), m, K, vec16};
  return launch(dist, m * K, list_ids, probe_ids, out_d, out_i, Q, P, nlist,
                max_len, L, Pl, stream);
}

extern "C" int pq4_ivf_scan_u8(const void* luts, const void* codes,
                               const void* list_ids, const void* probe_ids,
                               void* out_d, void* out_i, int Q, int P,
                               int nlist, int max_len, int L, int Pl, int m,
                               void* stream) {
  int vec8 = (m % 16 == 0) && aligned(codes, 8);
  Pq4Scan dist{static_cast<const float*>(luts),
               static_cast<const unsigned char*>(codes), m, vec8};
  return launch(dist, m * 16, list_ids, probe_ids, out_d, out_i, Q, P, nlist,
                max_len, L, Pl, stream);
}
