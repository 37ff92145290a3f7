// beam_filter: the candidate filter of one lockstep iteration of the beam
// traversal (core/search.py, span `search.iter.filter`), in one launch.
//
// Replaces no TPU kernel: the JAX package runs this stage as plain jnp
// ops (src/repro/core/search.py, the loop body's `nbrs` ... `in_queue_mask`
// lines; src/repro/core/queue.py `dedupe_ids`, `in_queue_mask`), and so did
// the port until this kernel, as some twenty eager tensor ops whose
// pairwise id tests wrote and reduced a (Q, C, L) bool tensor every
// iteration. Semantics, per query row q, over C = W*M flat positions in
// beam order (expansion w owns [w*M, (w+1)*M)):
//   1. id[c]  = graph[v[q, w], c - w*M] where v[q, w] >= 0, else -1;
//               every negative id is -1;
//   2. id[c]  = -1 where id[c] equals id[j] for some j < c (the first
//               occurrence of an id survives);
//   3. bitmap mode: id[c] = -1 where its bit of bitmap[q] was set before
//               this call, and the bits of the survivors are set (in
//               place; the survivors are distinct, so an atomicOr of each
//               equals the plain version's scatter-add);
//   4. n_new[q] = the count of survivors after 3;
//   5. flat[q, c] = -1 where id[c] is one of queue_ids[q, :L], else id[c].
//
// Bound on this card: the compares. The bytes are the W ids, the W
// adjacency rows (C*4 bytes), the queue row (L*4), the output (C*4 + 4)
// and in bitmap mode one 8-byte word a survivor: at the graph cell's
// shape (Q=10,000, W=4, M=24, L=320) about 20 MB, 6 us at 3.35 TB/s. The
// tests are C*(C-1)/2 + C*L id compares a row, 3.1e8 there, each a
// shared-memory read shared by a warp (a broadcast) and an integer compare.
//
// Design: one group of threads a row, chosen from C: a warp, kRowWarps rows
// a block, where C <= 32 (the build's search pass: W=1, M+M/4 ids); else a
// block of min(C rounded up to whole warps, kMaxThreads) threads, each
// thread owning positions t, t + G, ... (kPer of them at most). The group
// gathers its row's C ids straight from the W adjacency rows into shared
// memory beside the first tile of kTileL queue ids, and waits once. Each
// thread then tests its ids against the earlier positions (a loop over
// shared memory that every lane of a warp reads at the same address) and,
// in bitmap mode, sets its bit with one atomicOr whose old word says
// whether it was set before. The count is a barrier an owned position
// (__syncthreads_count; a ballot in a warp). The queue is read as int4s
// from shared memory, tile by tile, each tile a wait of the group, so no L
// is refused: padding past L holds -1, which no surviving id equals.
#include <cuda_runtime.h>

namespace {

// rows a block where a warp filters one row (C <= 32); the most threads a
// block where a block filters one row; queue ids staged a tile; the most
// ids a thread owns (kMaxThreads * kMaxPer = the wrapper's MAX_C)
constexpr int kRowWarps = 4, kMaxThreads = 1024, kTileL = 1024, kMaxPer = 4;
constexpr int kMaxC = kMaxThreads * kMaxPer;
static_assert(kTileL % 4 == 0, "the queue tile is read as int4s");

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

struct Filter {
  const int* v;                  // (Q, W)
  const int* graph;              // (n, M)
  const int* qids;               // (Q, L)
  unsigned long long* bitmap;    // (Q, nwords) or null (queue mode)
  int* flat;                     // (Q, C)
  int* n_new;                    // (Q,)
  int Q, W, M, L, nwords;
};

// A warp a row, kRowWarps rows a block.
struct WarpRows {
  int t, G, row, slot;
  __device__ WarpRows()
      : t(threadIdx.x & 31), G(32),
        row(blockIdx.x * kRowWarps + (threadIdx.x >> 5)),
        slot(threadIdx.x >> 5) {}
  __device__ void sync() const { __syncwarp(); }
  __device__ int count(bool p) const {
    return __popc(__ballot_sync(0xffffffffu, p));
  }
};

// A block a row.
struct BlockRows {
  int t, G, row, slot;
  __device__ BlockRows()
      : t(threadIdx.x), G(blockDim.x), row(blockIdx.x), slot(0) {}
  __device__ void sync() const { __syncthreads(); }
  __device__ int count(bool p) const { return __syncthreads_count(p); }
};

// Stage queue ids [base, base + cap) of row q into qt, -1 past L.
template <class Rows>
__device__ __forceinline__ void stage_queue(const Rows& g, const Filter& f,
                                            int* qt, int base, int cap) {
  const int* qrow = f.qids + (size_t)g.row * f.L;
  for (int l = g.t; l < cap; l += g.G)
    qt[l] = base + l < f.L ? __ldg(qrow + base + l) : -1;
}

template <class Rows, int kPer>
__global__ void __launch_bounds__(kMaxThreads) filter_kernel(Filter f) {
  extern __shared__ __align__(16) int smem[];
  const Rows g;
  if (g.row >= f.Q) return;      // a whole warp (WarpRows) or no thread
  const int C = f.W * f.M;
  const int cap = imin(align4(f.L), kTileL);
  int* qt = smem + (size_t)g.slot * (cap + align4(C));
  int* cand = qt + cap;

  // 1. the row's ids, gathered from its W adjacency rows; the first tile
  int id[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = g.t + k * g.G;
    id[k] = -1;
    if (c < C) {
      const int w = c / f.M;
      const int vid = __ldg(f.v + (size_t)g.row * f.W + w);
      if (vid >= 0) {
        const int x = __ldg(f.graph + (size_t)vid * f.M + (c - w * f.M));
        id[k] = x < 0 ? -1 : x;
      }
      cand[c] = id[k];
    }
  }
  stage_queue(g, f, qt, 0, cap);
  g.sync();

  // 2-4. the first occurrence survives; then the visited bits; the count
  unsigned long long* bm =
      f.bitmap == nullptr ? nullptr : f.bitmap + (size_t)g.row * f.nwords;
  int n = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = g.t + k * g.G;
    if (id[k] >= 0) {
      bool dup = false;
      for (int j = 0; j < c && !dup; ++j) dup = cand[j] == id[k];
      if (dup) {
        id[k] = -1;
      } else if (bm != nullptr) {
        const unsigned long long bit = 1ull << (id[k] & 31);
        if (atomicOr(bm + (id[k] >> 5), bit) & bit) id[k] = -1;
      }
    }
    n += g.count(id[k] >= 0);
  }
  if (g.t == 0) f.n_new[g.row] = n;

  // 5. the survivors already in the queue, tile by tile
  bool hit[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) hit[k] = false;
  for (int base = 0; base < f.L; base += cap) {
    if (base > 0) {
      g.sync();
      stage_queue(g, f, qt, base, cap);
      g.sync();
    }
    const int4* q4 = reinterpret_cast<const int4*>(qt);
    const int n4 = align4(imin(cap, f.L - base)) / 4;
#pragma unroll 4
    for (int i = 0; i < n4; ++i) {
      const int4 e = q4[i];
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        hit[k] |= (e.x == id[k]) | (e.y == id[k]) | (e.z == id[k]) |
                  (e.w == id[k]);
    }
  }
  int* out = f.flat + (size_t)g.row * C;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = g.t + k * g.G;
    if (c < C) out[c] = hit[k] ? -1 : id[k];
  }
}

}  // namespace

// v (Q, W), graph (n, M), queue_ids (Q, L) int32; bitmap (Q, nwords)
// int64 or null; outputs flat (Q, W*M) and n_new (Q,) int32. W*M beyond
// kMaxC is refused (cudaErrorInvalidValue).
extern "C" int beam_filter_i32(const void* v, const void* graph,
                               const void* queue_ids, void* bitmap,
                               void* flat, void* n_new, int Q, int W, int M,
                               int L, int nwords, void* stream) {
  if (Q <= 0) return 0;
  const long long C = (long long)W * M;
  if (W < 1 || M < 1 || C > kMaxC || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Filter f{static_cast<const int*>(v), static_cast<const int*>(graph),
                 static_cast<const int*>(queue_ids),
                 static_cast<unsigned long long*>(bitmap),
                 static_cast<int*>(flat), static_cast<int*>(n_new),
                 Q, W, M, L, nwords};
  const int slot = imin(align4(L), kTileL) + align4((int)C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 32) {
    filter_kernel<WarpRows, 1>
        <<<(Q + kRowWarps - 1) / kRowWarps, kRowWarps * 32,
           (size_t)kRowWarps * slot * sizeof(int), s>>>(f);
  } else {
    const int threads = imin((int)(C + 31) / 32 * 32, kMaxThreads);
    const size_t bytes = (size_t)slot * sizeof(int);
    if (C <= kMaxThreads)
      filter_kernel<BlockRows, 1><<<Q, threads, bytes, s>>>(f);
    else
      filter_kernel<BlockRows, kMaxPer><<<Q, threads, bytes, s>>>(f);
  }
  return static_cast<int>(cudaGetLastError());
}
