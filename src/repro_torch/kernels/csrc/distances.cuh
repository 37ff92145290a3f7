// distances.cuh: the per-candidate distance code shared by the gather
// kernels (gather_dist.cu, pq_adc.cu) and the fused beam steps
// (traverse_step.cu), so a gathered distance and the same distance inside
// a fused step are one piece of arithmetic.
//
//   warp_dist_f32  one warp, one f32 database row        (gather_dist)
//   warp_dist_sq   one warp, one u8 row dequantized as
//                  code * scale + zero                   (sq_gather_dist)
//   thread_adc     one thread, one m-byte PQ code:
//                  sum_j lut[j * K + code[j]]            (pq_adc)
//
// metric 0 is l2 (sum of squared differences), 1 the negated inner
// product. The query row, scale, zero and the LUT are read from shared
// memory, database rows and codes from device memory through the
// read-only path (__ldg).
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

namespace kbest {

__device__ __forceinline__ float warp_sum(float acc) {
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Every lane of the warp calls it with the same id >= 0; every lane gets
// the distance. vec4: d % 4 == 0 and 16-byte aligned rows and query.
__device__ __forceinline__ float warp_dist_f32(const float* __restrict__ db,
                                               int id,
                                               const float* __restrict__ qs,
                                               int d, int metric, bool vec4,
                                               int lane) {
  float acc = 0.f;
  const float* row = db + (size_t)id * d;
  if (vec4) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int k = lane; k < (d >> 2); k += 32) {
      float4 r = __ldg(r4 + k);
      float4 v = q4[k];
      if (metric == 0) {
        float a = r.x - v.x, b = r.y - v.y, c = r.z - v.z, e = r.w - v.w;
        acc += a * a + b * b + c * c + e * e;
      } else {
        acc += r.x * v.x + r.y * v.y + r.z * v.z + r.w * v.w;
      }
    }
  } else {
    for (int k = lane; k < d; k += 32) {
      float r = __ldg(row + k);
      if (metric == 0) {
        float a = r - qs[k];
        acc += a * a;
      } else {
        acc += r * qs[k];
      }
    }
  }
  acc = warp_sum(acc);
  return metric == 0 ? acc : -acc;
}

__device__ __forceinline__ void sq_term(float c, float s, float z, float qv,
                                        int metric, float& acc) {
  const float v = c * s + z;
  if (metric == 0) {
    const float a = v - qv;
    acc += a * a;
  } else {
    acc += v * qv;
  }
}

// As warp_dist_f32 over a u8 code row; ss/zs are the (d,) scale and zero.
// vec4: d % 4 == 0 and 4-byte aligned code rows (one 32-bit load a lane).
__device__ __forceinline__ float warp_dist_sq(
    const unsigned char* __restrict__ codes, int id,
    const float* __restrict__ qs, const float* __restrict__ ss,
    const float* __restrict__ zs, int d, int metric, bool vec4, int lane) {
  float acc = 0.f;
  const unsigned char* row = codes + (size_t)id * d;
  if (vec4) {
    const uchar4* r4 = reinterpret_cast<const uchar4*>(row);
    for (int k = lane; k < (d >> 2); k += 32) {
      const uchar4 c = __ldg(r4 + k);
      const int b = k << 2;
      sq_term(static_cast<float>(c.x), ss[b], zs[b], qs[b], metric, acc);
      sq_term(static_cast<float>(c.y), ss[b + 1], zs[b + 1], qs[b + 1],
              metric, acc);
      sq_term(static_cast<float>(c.z), ss[b + 2], zs[b + 2], qs[b + 2],
              metric, acc);
      sq_term(static_cast<float>(c.w), ss[b + 3], zs[b + 3], qs[b + 3],
              metric, acc);
    }
  } else {
    for (int k = lane; k < d; k += 32)
      sq_term(static_cast<float>(__ldg(row + k)), ss[k], zs[k], qs[k], metric,
              acc);
  }
  acc = warp_sum(acc);
  return metric == 0 ? acc : -acc;
}

// One thread, one code row (id >= 0), summed over j = 0 .. m-1 in order.
// vec16: m % 16 == 0 and 16-byte aligned code rows (one 16-byte load per
// 16 subspaces).
__device__ __forceinline__ float thread_adc(
    const unsigned char* __restrict__ codes, int id,
    const float* __restrict__ lut, int m, int K, bool vec16) {
  const unsigned char* row = codes + (size_t)id * m;
  float acc = 0.f;
  if (vec16) {
    for (int j0 = 0; j0 < m; j0 += 16) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + j0));
      const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const unsigned int c = (words[t >> 2] >> ((t & 3) * 8)) & 0xffu;
        acc += lut[(j0 + t) * K + c];
      }
    }
  } else {
    for (int j = 0; j < m; ++j) acc += lut[j * K + __ldg(row + j)];
  }
  return acc;
}

}  // namespace kbest
