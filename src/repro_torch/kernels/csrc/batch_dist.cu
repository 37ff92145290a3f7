// batch_dist: the (Q, B) distance matrix between two row sets, in fp32.
//
// Replaces the Pallas kernel `batch_dist` of the JAX package
// (src/repro/kernels/batch_dist.py), an MXU contraction per (TQ, TB) tile
// with the L2 norm corrections fused. Semantics:
//   out[i, j] = max(|q_i|^2 + |x_j|^2 - 2 q_i.x_j, 0)     (metric 0, l2)
//   out[i, j] = -q_i.x_j                                 (metric 1, ip)
//
// Bound on this card: operations for the shapes the port gives it (2*Q*B*d
// fp32 flops against (Q+B)*d*4 bytes in and Q*B*4 out: at d=96 about 24
// flops per output byte, above the fp32 balance point of 67 TFLOP/s over
// 3.35 TB/s = 20). Full fp32 FMA, no TF32, so results agree with the
// reference to fp32 rounding.
// Design: a plain SIMT tiled product. Each 256-thread block owns a 64x64
// output tile and walks d in steps of 16, staging both 64x16 input slices
// in shared memory (transposed, so the inner loop reads consecutive
// addresses); each thread keeps a 4x4 block of sums in registers at
// stride 16, so a warp's shared-memory reads are conflict-free. The row
// norms are summed from the same staged slices, and the epilogue writes
// the finished distances once.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

__global__ void __launch_bounds__(kThreads)
batch_dist_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  float* __restrict__ out, int Q, int B, int d, int metric) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  __shared__ float qn[BM];
  __shared__ float xn[BN];

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;

  float acc[4][4] = {};
  float norm = 0.f;  // threads 0..63: |q row|^2, 64..127: |x row|^2

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int r = e / BK, c = e % BK;
      const long long gm = m0 + r, gn = n0 + r;
      const int gk = k0 + c;
      As[c][r] = (gm < Q && gk < d) ? q[gm * d + gk] : 0.f;
      Bs[c][r] = (gn < B && gk < d) ? x[gn * d + gk] : 0.f;
    }
    __syncthreads();
    if (metric == 0) {
      if (t < BM) {
#pragma unroll
        for (int k = 0; k < BK; ++k) norm += As[k][t] * As[k][t];
      } else if (t < BM + BN) {
#pragma unroll
        for (int k = 0; k < BK; ++k) norm += Bs[k][t - BM] * Bs[k][t - BM];
      }
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (metric == 0) {
    if (t < BM) qn[t] = norm;
    else if (t < BM + BN) xn[t - BM] = norm;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const long long gm = m0 + r;
    if (gm >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const long long gn = n0 + c;
      if (gn >= B) continue;
      float v;
      if (metric == 0) {
        v = fmaxf((qn[r] + xn[c]) - 2.0f * acc[i][j], 0.f);
      } else {
        v = -acc[i][j];
      }
      out[gm * B + gn] = v;
    }
  }
}

}  // namespace

extern "C" int batch_dist_f32(const void* q, const void* x, void* out, int Q,
                              int B, int d, int metric, void* stream) {
  if (Q == 0 || B == 0) return 0;
  dim3 grid((B + BN - 1) / BN, (Q + BM - 1) / BM);
  batch_dist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<float*>(out), Q, B, d, metric);
  return static_cast<int>(cudaGetLastError());
}
