// distances.cuh: the per-candidate distance code shared by the gather
// kernels (gather_dist.cu, pq_adc.cu, pq4_scan.cu), the
// list scans (ivf_scan.cu) and the fused beam steps (traverse_step.cu).
// A PQ, PQ4 or Hamming distance is one piece of arithmetic wherever it is
// computed. The f32 and SQ scorers of gather_dist.cu and traverse_step.cu
// split a row into units and a lane's share of a row into the terms of
// its units, in order, with the helpers below; where both give a row
// the same lanes and units (f32: 8 lanes, float4 or float units), a
// gathered distance equals the fused step's bit for bit.
//
//   F32Unit<U>     a row unit of U floats: float4 (U = 4) or float
//   f32_unit<IP>   the terms of one f32 unit, in order:
//                  (r - q)^2 (l2) or r * q (ip), fused multiply-adds
//   SqUnit<UB>     a code unit of UB bytes: uint4, uint2 or u32 words
//   word, code_at  word i of a unit; byte i of a word as a float, exactly
//   sq_term        one SQ term, the code dequantized as code*scale + zero
//   sq_word<IP>    the four terms of one code word, in order
//   thread_adc     one thread, one m-byte PQ code:
//                  sum_j lut[j * K + code[j]]            (pq_adc)
//   thread_adc4    one thread, one m/2-byte nibble-packed PQ4 code:
//                  sum_j lut[j * 16 + code[j]]           (pq4_adc)
//   thread_adc_n,  thread_adc and thread_adc4 over U rows at once, the
//   thread_adc4_n  same sums                             (the list scans)
//   thread_adc_ldg, thread_adc and thread_adc4 with the table in device
//   thread_adc4_ldg memory, a chunk's entries loaded before any is added,
//                  the same sums            (pq_adc, pq4_adc, the PQ step)
//   thread_adc4_rows thread_adc4 over U rows at once, the table in shared
//                  memory, the same sums           (the PQ4 step, C <= 128)
//   thread_hamming one thread, one nw-word sign code:
//                  sum_w popc(q[w] ^ code[w])  (the bin step, C > 128)
//
// metric 0 is l2 (sum of squared differences), 1 the negated inner
// product (the callers negate the sum). The fused f32, SQ and PQ4 steps,
// and the bin step at C > 128, read the query, scale, zero, LUT or query
// words from shared memory; the gathers, the fused PQ step and the bin
// step at C <= 128 from device memory through the read-only path;
// database rows and codes are read from device memory through the
// read-only path (__ldg).
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

namespace kbest {

template <int U> struct F32Unit { using T = float4; };
template <> struct F32Unit<1> { using T = float; };

template <bool IP>
__device__ __forceinline__ void f32_term(float r, float qv, float& acc) {
  if (IP) {
    acc = fmaf(r, qv, acc);
  } else {
    const float a = r - qv;
    acc = fmaf(a, a, acc);
  }
}

template <bool IP>
__device__ __forceinline__ void f32_unit(const float4& r, const float4& v,
                                         float& acc) {
  f32_term<IP>(r.x, v.x, acc);
  f32_term<IP>(r.y, v.y, acc);
  f32_term<IP>(r.z, v.z, acc);
  f32_term<IP>(r.w, v.w, acc);
}

template <bool IP>
__device__ __forceinline__ void f32_unit(float r, float v, float& acc) {
  f32_term<IP>(r, v, acc);
}

template <int UB> struct SqUnit { using T = unsigned int; };
template <> struct SqUnit<16> { using T = uint4; };
template <> struct SqUnit<8> { using T = uint2; };

__device__ __forceinline__ unsigned int word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned int word(const uint2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ unsigned int word(unsigned int v, int) {
  return v;
}

// Byte i of w as a float, exactly: 2^23 + byte built by a byte permute,
// less 2^23 (an integer-to-float conversion runs at a quarter of the rate).
__device__ __forceinline__ float code_at(unsigned int w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | i)) -
         8388608.f;
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

// The terms of the four code bytes of w, whose dimensions' query, scale
// and zero are qv, s and z, in order.
template <bool IP>
__device__ __forceinline__ void sq_word(unsigned int w, const float4& qv,
                                        const float4& s, const float4& z,
                                        float& acc) {
  constexpr int metric = IP ? 1 : 0;
  sq_term(code_at(w, 0), s.x, z.x, qv.x, metric, acc);
  sq_term(code_at(w, 1), s.y, z.y, qv.y, metric, acc);
  sq_term(code_at(w, 2), s.z, z.z, qv.z, metric, acc);
  sq_term(code_at(w, 3), s.w, z.w, qv.w, metric, acc);
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

// thread_adc's sum (from +0.0, j = 0 .. m-1 in order) with lut, the
// query's (m, K) table, in device memory: the code bytes of kChunk
// subspaces are loaded, then all of their table entries through the
// read-only path, before any is added, so a chunk's reads are in flight
// at once. vec16: m % 16 == 0 and 16-byte aligned code rows.
template <int kChunk>
__device__ __forceinline__ float thread_adc_ldg(
    const unsigned char* __restrict__ codes, int id,
    const float* __restrict__ lut, int m, int K, bool vec16) {
  static_assert(kChunk % 16 == 0, "kChunk: whole 16-byte code loads");
  const unsigned char* row = codes + (size_t)id * m;
  float acc = 0.f;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    unsigned int c[kChunk];
    if (vec16) {
#pragma unroll
      for (int g = 0; g < kChunk / 16; ++g) {
        const uint4 w = j0 + 16 * g < m
                            ? __ldg(reinterpret_cast<const uint4*>(
                                  row + j0 + 16 * g))
                            : make_uint4(0u, 0u, 0u, 0u);
        const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int t = 0; t < 16; ++t)
          c[16 * g + t] = (words[t >> 2] >> ((t & 3) * 8)) & 0xffu;
      }
    } else {
#pragma unroll
      for (int t = 0; t < kChunk; ++t)
        c[t] = j0 + t < m ? __ldg(row + j0 + t) : 0u;
    }
    float v[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t)
      v[t] = j0 + t < m ? __ldg(lut + (j0 + t) * K + c[t]) : 0.f;
#pragma unroll
    for (int t = 0; t < kChunk; ++t)
      if (j0 + t < m) acc += v[t];
  }
  return acc;
}

// thread_adc over U rows at once, each row's sum exactly thread_adc's (from
// +0.0, j = 0 .. m-1 in order); the U sums are independent chains, so
// their table reads overlap. Rows with on[u] false are not read (out[u]
// is then 0).
template <int U>
__device__ __forceinline__ void thread_adc_n(
    const unsigned char* __restrict__ codes, const int (&row)[U],
    const bool (&on)[U], const float* __restrict__ lut, int m, int K,
    bool vec16, float (&out)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) out[u] = 0.f;
  if (vec16) {
    for (int j0 = 0; j0 < m; j0 += 16) {
      uint4 w[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        w[u] = on[u] ? __ldg(reinterpret_cast<const uint4*>(
                           codes + (size_t)row[u] * m + j0))
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const unsigned int wd = t < 4 ? w[u].x : t < 8 ? w[u].y
                                  : t < 12 ? w[u].z : w[u].w;
          const unsigned int c = (wd >> ((t & 3) * 8)) & 0xffu;
          if (on[u]) out[u] += lut[(j0 + t) * K + c];
        }
      }
    }
  } else {
    for (int j = 0; j < m; ++j) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (on[u]) out[u] += lut[j * K + __ldg(codes + (size_t)row[u] * m + j)];
    }
  }
}

// One thread, one nibble-packed code row of m/2 bytes (id >= 0): byte b
// holds subspace 2b in its low nibble and 2b+1 in its high nibble; summed
// over j = 0 .. m-1 in order, lut being the (m, 16) table. vec8: m % 16
// == 0 and 8-byte aligned code rows (one 8-byte load per 16 subspaces).
__device__ __forceinline__ float thread_adc4(
    const unsigned char* __restrict__ codes, int id,
    const float* __restrict__ lut, int m, bool vec8) {
  const int mh = m >> 1;
  const unsigned char* row = codes + (size_t)id * mh;
  float acc = 0.f;
  if (vec8) {
    for (int b0 = 0; b0 < mh; b0 += 8) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(row + b0));
      const unsigned int words[2] = {w.x, w.y};
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const unsigned int c = (words[t >> 2] >> ((t & 3) * 8)) & 0xffu;
        const int j = 2 * (b0 + t);
        acc += lut[j * 16 + (c & 15u)];
        acc += lut[(j + 1) * 16 + (c >> 4)];
      }
    }
  } else {
    for (int b = 0; b < mh; ++b) {
      const unsigned int c = __ldg(row + b);
      acc += lut[2 * b * 16 + (c & 15u)];
      acc += lut[(2 * b + 1) * 16 + (c >> 4)];
    }
  }
  return acc;
}

// thread_adc4's sum (from +0.0, j = 0 .. m-1 in order) with lut, the
// query's (m, 16) table, in device memory, as thread_adc_ldg is
// thread_adc's: the code bytes of kChunk subspaces, then all of their
// table entries, before any is added. vec8: m % 16 == 0 and 8-byte
// aligned code rows.
template <int kChunk>
__device__ __forceinline__ float thread_adc4_ldg(
    const unsigned char* __restrict__ codes, int id,
    const float* __restrict__ lut, int m, bool vec8) {
  static_assert(kChunk % 16 == 0, "kChunk: whole 8-byte code loads");
  constexpr int kBytes = kChunk / 2;
  const int mh = m >> 1;
  const unsigned char* row = codes + (size_t)id * mh;
  float acc = 0.f;
  for (int b0 = 0; b0 < mh; b0 += kBytes) {
    unsigned int c[kBytes];
    if (vec8) {
#pragma unroll
      for (int g = 0; g < kBytes / 8; ++g) {
        const uint2 w = b0 + 8 * g < mh
                            ? __ldg(reinterpret_cast<const uint2*>(
                                  row + b0 + 8 * g))
                            : make_uint2(0u, 0u);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          c[8 * g + t] = ((t < 4 ? w.x : w.y) >> ((t & 3) * 8)) & 0xffu;
      }
    } else {
#pragma unroll
      for (int t = 0; t < kBytes; ++t)
        c[t] = b0 + t < mh ? __ldg(row + b0 + t) : 0u;
    }
    float v[kChunk];
#pragma unroll
    for (int t = 0; t < kBytes; ++t) {
      const int j = 2 * (b0 + t);
      v[2 * t] = b0 + t < mh ? __ldg(lut + j * 16 + (c[t] & 15u)) : 0.f;
      v[2 * t + 1] =
          b0 + t < mh ? __ldg(lut + (j + 1) * 16 + (c[t] >> 4)) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kBytes; ++t) {
      if (b0 + t < mh) {
        acc += v[2 * t];
        acc += v[2 * t + 1];
      }
    }
  }
  return acc;
}

// thread_adc4 over U rows at once, each row's sum exactly thread_adc4's
// (from +0.0, j = 0 .. m-1 in order), with lut the query's (m, 16) table
// in shared memory. The code bytes of 32 subspaces of every row are
// loaded at once (V8: m % 16 == 0 and 8-byte aligned rows, two 8-byte
// loads a row; else bytes), then ready() is called (once, before the
// first table read: the wait for the table being staged), then the table
// entries of kChunk subspaces of every row are loaded before any is
// added. Rows with id < 0 are not read (their out is 0).
template <int U, int kChunk, bool V8, class Ready>
__device__ __forceinline__ void thread_adc4_rows(
    const unsigned char* __restrict__ codes, const int (&id)[U],
    const float* lut, int m, Ready ready, float (&out)[U]) {
  constexpr int kCodeBytes = 16;           // 32 subspaces a pass
  constexpr int kBytes = kChunk / 2;
  static_assert(kChunk % 16 == 0 && kCodeBytes % kBytes == 0,
                "kChunk: 16 or 32 subspaces");
  const int mh = m >> 1;
#pragma unroll
  for (int u = 0; u < U; ++u) out[u] = 0.f;
  bool first = true;
  for (int b0 = 0; b0 < mh; b0 += kCodeBytes) {
    unsigned int c[U][kCodeBytes];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned char* row = codes + (size_t)(id[u] < 0 ? 0 : id[u]) * mh
                                 + b0;
      if constexpr (V8) {
#pragma unroll
        for (int g = 0; g < kCodeBytes / 8; ++g) {
          const uint2 w = id[u] >= 0 && b0 + 8 * g < mh
                              ? __ldg(reinterpret_cast<const uint2*>(
                                    row + 8 * g))
                              : make_uint2(0u, 0u);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            c[u][8 * g + t] = ((t < 4 ? w.x : w.y) >> ((t & 3) * 8)) & 0xffu;
        }
      } else {
#pragma unroll
        for (int t = 0; t < kCodeBytes; ++t)
          c[u][t] = id[u] >= 0 && b0 + t < mh ? __ldg(row + t) : 0u;
      }
    }
    if (first) {
      ready();
      first = false;
    }
#pragma unroll
    for (int s0 = 0; s0 < kCodeBytes; s0 += kBytes) {
      if (b0 + s0 >= mh) break;
      float v[U][kChunk];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int t = 0; t < kBytes; ++t) {
          const bool on = id[u] >= 0 && b0 + s0 + t < mh;
          const int j = 2 * (b0 + s0 + t);
          const unsigned int cb = c[u][s0 + t];
          const float* lo = lut + j * 16 + (cb & 15u);
          const float* hi = lut + (j + 1) * 16 + (cb >> 4);
          v[u][2 * t] = on ? *lo : 0.f;
          v[u][2 * t + 1] = on ? *hi : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int t = 0; t < kBytes; ++t) {
          if (b0 + s0 + t < mh) {
            out[u] += v[u][2 * t];
            out[u] += v[u][2 * t + 1];
          }
        }
      }
    }
  }
}

// thread_adc4 over U rows at once, as thread_adc_n is thread_adc's.
template <int U>
__device__ __forceinline__ void thread_adc4_n(
    const unsigned char* __restrict__ codes, const int (&row)[U],
    const bool (&on)[U], const float* __restrict__ lut, int m, bool vec8,
    float (&out)[U]) {
  const int mh = m >> 1;
#pragma unroll
  for (int u = 0; u < U; ++u) out[u] = 0.f;
  if (vec8) {
    for (int b0 = 0; b0 < mh; b0 += 8) {
      uint2 w[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        w[u] = on[u] ? __ldg(reinterpret_cast<const uint2*>(
                           codes + (size_t)row[u] * mh + b0))
                     : make_uint2(0u, 0u);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int j = 2 * (b0 + t);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const unsigned int c = ((t < 4 ? w[u].x : w[u].y) >> ((t & 3) * 8))
                                 & 0xffu;
          if (on[u]) {
            out[u] += lut[j * 16 + (c & 15u)];
            out[u] += lut[(j + 1) * 16 + (c >> 4)];
          }
        }
      }
    }
  } else {
    for (int b = 0; b < mh; ++b) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (on[u]) {
          const unsigned int c = __ldg(codes + (size_t)row[u] * mh + b);
          out[u] += lut[2 * b * 16 + (c & 15u)];
          out[u] += lut[(2 * b + 1) * 16 + (c >> 4)];
        }
      }
    }
  }
}

// One thread, one packed sign row of nw 32-bit words (id >= 0) against the
// query's words qw: the Hamming distance, counted exactly in an int and
// converted once, so equal counts give equal floats.
__device__ __forceinline__ float thread_hamming(
    const unsigned int* __restrict__ codes, int id,
    const unsigned int* __restrict__ qw, int nw) {
  const unsigned int* row = codes + (size_t)id * nw;
  int acc = 0;
  for (int w = 0; w < nw; ++w) acc += __popc(qw[w] ^ __ldg(row + w));
  return static_cast<float>(acc);
}

}  // namespace kbest
