// batch_dist: the (Q, B) distance matrix between two row sets, in fp32.
//
// Replaces the Pallas kernel `batch_dist` of the JAX package
// (src/repro/kernels/batch_dist.py), an MXU contraction per (TQ, TB) tile
// with the L2 norm corrections fused. Semantics:
//   out[i, j] = max((|q_i|^2 + |x_j|^2) - 2 q_i.x_j, 0)   (metric 0, l2)
//   out[i, j] = -q_i.x_j                                 (metric 1, ip)
//
// Bound on this card: operations for the shapes the port gives it (2*Q*B*d
// fp32 flops against (Q+B)*d*4 bytes in and Q*B*4 out: at d=96 about 24
// flops per output byte, above the fp32 balance point of 67 TFLOP/s over
// 3.35 TB/s = 20). Full fp32 FMA, no TF32, so results agree with the
// reference to fp32 rounding; the 4 GB output of a 1000 x 1M call is 1.2
// ms of HBM writes by itself, so its stores have to overlap the products.
//
// Design: a register-tiled SIMT product on a persistent grid.
// - Each 256-thread block owns 128 (Q) x 256 (B) output tiles; a thread
//   keeps 8 x 16 sums in registers (rows ty + 16i, columns tx + 16j), so
//   each value it reads from shared memory feeds 8 or 16 FMAs: a step of
//   4 k reads a float4 run of d for each of its 8 rows and 16 columns (24
//   vector loads for 512 FMAs). The row stride S of the staged tiles has
//   S/4 odd, so the 8 lanes of a quarter-warp that read 8 neighbouring
//   rows hit 8 disjoint 4-bank groups, and the A rows are the same for 16
//   lanes (a broadcast). S is a compile-time constant for the usual
//   chunk, so every load is a base register plus an immediate offset.
// - Both operands stay row-major (d contiguous), so tiles go from device
//   memory to shared memory with 16-byte cp.async (4-byte ones, zero-
//   filling the ragged tail, when d % 4 != 0 or a base is not 16-byte
//   aligned), with no transposition in registers. d runs in chunks of at
//   most 64 (two at d=96); each step's tiles load into the second of two
//   buffers while the current one is multiplied, one barrier a step. The
//   Q tile is staged again only when d takes several chunks or the
//   block's next tile lies under another Q tile.
// - The grid is as many blocks as the SMs hold (one each: about 210
//   registers a thread and 210 KB of shared memory), walking tiles t =
//   block, block + grid, ... with the query tile fastest, so the Q tiles
//   that share a B tile run at once and read it from HBM once.
// - The epilogue fuses the norms, summed in fp32 from the staged tiles
//   (each B row's once per B tile, each Q row's once per staging), and
//   writes each output once; a warp's store covers two rows of 16
//   consecutive floats, whole 32-byte sectors, and is not waited for, so
//   the stores drain while the block multiplies its next tile.
// Choices measured on the card at 1000 x 1M x 96 (PERF.md): 128 x
// 256 tiles beat 128 x 128 ones (fewer shared loads per FMA); plain
// stores beat streaming (.cs) ones; register double-buffering of the
// fragments, two 128-thread blocks an SM and TMA bulk row copies in place
// of cp.async did not help.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256, kTile = 128, kTileN = 256, kMaxChunk = 64;
// each thread sums 8 rows (ty + 16i) by kCols columns (tx + 16j)
constexpr int kCols = kTileN / 16;
constexpr int stride_of(int chunk) {
  return chunk + (((chunk >> 2) & 1) ? 8 : 4);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// bytes = 0 zero-fills the destination and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// rows r0 .. r0+kRows-1 (of n) of the row-major (n, d) `src`, columns k0
// .. k0+kc-1 (kc a multiple of 4; zeros past d and past row n) into `buf`
// with row stride S
template <bool kVec, int kRows>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ src,
                                      long long r0, int n, int d, int k0,
                                      int kc, int S) {
  if (kVec) {
    const int per_row = kc >> 2;
    for (int e = threadIdx.x; e < kRows * per_row; e += kThreads) {
      const int r = e / per_row, c = (e - r * per_row) << 2;
      const bool ok = r0 + r < n;
      cp_async16(buf + r * S + c, src + (ok ? (r0 + r) * d + k0 + c : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kc; e += kThreads) {
      const int r = e / kc, c = e - r * kc;
      const bool ok = r0 + r < n && k0 + c < d;
      cp_async4(buf + r * S + c, src + (ok ? (r0 + r) * d + k0 + c : 0), ok);
    }
  }
}

__device__ __forceinline__ float row_norm(const float* p, int kc) {
  float s = 0.f;
  for (int k = 0; k < kc; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s;
}

// kS: the row stride when it is known at compile time, else 0 (S_arg)
template <bool kVec, int kS>
__global__ void __launch_bounds__(kThreads, 1)
batch_dist_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  float* __restrict__ out, int Q, int B, int d, int metric,
                  int chunk, int S_arg) {
  const int S = kS ? kS : S_arg;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // 2 x kTile x S
  float* Bs = As + 2 * kTile * S;                // 2 x kTileN x S
  float* qn = Bs + 2 * kTileN * S;               // kTile
  float* xn = qn + kTile;                        // kTileN

  // thread t sums the norms of B row t and, when staged, of Q row t
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int nqt = (Q + kTile - 1) / kTile;
  const long long tiles = (long long)nqt * ((B + kTileN - 1) / kTileN);
  const int nch = d > 0 ? (d + chunk - 1) / chunk : 1;
  if (blockIdx.x >= tiles) return;
  const long long nsteps =
      ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * (long long)nch;
  auto tile_of = [&](long long s) {
    return blockIdx.x + (s / nch) * (long long)gridDim.x;
  };
  auto kc_of = [&](int ch) {
    return (min(chunk, d - ch * chunk) + 3) & ~3;
  };

  // A is staged when d takes several chunks or the query tile changes,
  // always into the buffer the current step does not read
  int staged_qt = -1, a_buf = 1, a_next = 1;
  bool a_fresh = false, a_fresh_next = false;
  auto issue = [&](long long s) {
    const long long tl = tile_of(s);
    const int qt = static_cast<int>(tl % nqt);
    const long long bt = tl / nqt;
    const int ch = static_cast<int>(s % nch), kc = kc_of(ch);
    a_fresh_next = nch > 1 || qt != staged_qt;
    a_next = a_fresh_next ? a_buf ^ 1 : a_buf;
    if (a_fresh_next) {
      stage<kVec, kTile>(As + a_next * kTile * S, q, (long long)qt * kTile,
                         Q, d, ch * chunk, kc, S);
      staged_qt = qt;
    }
    stage<kVec, kTileN>(Bs + (s & 1) * kTileN * S, x, bt * kTileN, B, d,
                        ch * chunk, kc, S);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[8][kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  float xnorm = 0.f, qnorm = 0.f;

  issue(0);
  for (long long s = 0; s < nsteps; ++s) {
    a_buf = a_next;
    a_fresh = a_fresh_next;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // step s has landed; step s-1's buffers are free
    if (s + 1 < nsteps) issue(s + 1);
    const int ch = static_cast<int>(s % nch), kc = kc_of(ch);
    const float* Ab = As + a_buf * kTile * S;
    const float* Bb = Bs + (s & 1) * kTileN * S;
    if (metric == 0) {
      xnorm += row_norm(Bb + t * S, kc);
      if (a_fresh && t < kTile) qnorm += row_norm(Ab + t * S, kc);
    }
#pragma unroll 1
    for (int k = 0; k < kc; k += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(Ab + (ty + 16 * i) * S + k);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(Bb + (tx + 16 * j) * S + k);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = acc[i][j];
          v = fmaf(a[i].x, b.x, v);
          v = fmaf(a[i].y, b.y, v);
          v = fmaf(a[i].z, b.z, v);
          v = fmaf(a[i].w, b.w, v);
          acc[i][j] = v;
        }
      }
    }
    if (ch != nch - 1) continue;

    // ---- epilogue of the tile ----
    const long long tl = tile_of(s);
    const long long m0 = (tl % nqt) * kTile, n0 = (tl / nqt) * kTileN;
    if (metric == 0) {
      xn[t] = xnorm;
      if (a_fresh && t < kTile) qn[t] = qnorm;
      xnorm = qnorm = 0.f;
    }
    __syncthreads();
    const bool all_cols = n0 + tx + 16 * (kCols - 1) < B;
    if (metric == 0) {
      float xv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) xv[j] = xn[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 16 * i;
        const float qq = qn[r];
        float* orow = out + (m0 + r) * B + n0 + tx;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (m0 + r < Q && (all_cols || n0 + tx + 16 * j < B))
            orow[16 * j] = fmaxf((qq + xv[j]) - 2.0f * acc[i][j], 0.f);
          acc[i][j] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 16 * i;
        float* orow = out + (m0 + r) * B + n0 + tx;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (m0 + r < Q && (all_cols || n0 + tx + 16 * j < B))
            orow[16 * j] = -acc[i][j];
          acc[i][j] = 0.f;
        }
      }
    }
  }
}

}  // namespace

extern "C" int batch_dist_f32(const void* q, const void* x, void* out, int Q,
                              int B, int d, int metric, void* stream) {
  if (Q == 0 || B == 0) return 0;
  // the chunk of d staged at a time (a multiple of 4), and a row stride
  // with S/4 odd (conflict-free quarter-warp reads of 8 rows)
  const int d4 = (d + 3) & ~3;
  const int chunk = d == 0 ? 4 : (d4 < kMaxChunk ? d4 : kMaxChunk);
  const int S = stride_of(chunk);
  const size_t smem =
      (size_t)(2 * (kTile + kTileN) * S + kTile + kTileN) * sizeof(float);
  const bool vec = d % 4 == 0 &&
                   (reinterpret_cast<size_t>(q) & 15) == 0 &&
                   (reinterpret_cast<size_t>(x) & 15) == 0;
  constexpr int kS = stride_of(kMaxChunk);
  auto kernel = vec ? (S == kS ? batch_dist_kernel<true, kS>
                               : batch_dist_kernel<true, 0>)
                    : batch_dist_kernel<false, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (long long)((Q + kTile - 1) / kTile) *
                          ((B + kTileN - 1) / kTileN);
  const long long slots = (long long)sms * per_sm;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<float*>(out), Q, B, d, metric, chunk, S);
  return static_cast<int>(cudaGetLastError());
}
