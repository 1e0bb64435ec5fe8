// Pieces shared by the causal flash-attention kernels on the CUDA cores:
// the fp32 forward B11 (flash_attention.cu; its bf16 instance runs on the
// tensor cores, wgmma_common.cuh) and the backward, B11-dkv and B11-dq
// (flash_attention_bwd.cu). Each kernel stages 64-row tiles of q, k, v (and
// do) in shared memory as fp32 rows, with 16-byte global loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace onebit_flash {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // queries per CTA, keys per tile
constexpr int kPad = 4;    // floats of padding per staged row

// v rounded to T's precision, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes of T, stored to shared memory as floats.
template <typename T>
struct Convert;

template <>
struct Convert<float> {
  __device__ __forceinline__ static void store(float* dst, const uint4& r) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(__uint_as_float(r.x), __uint_as_float(r.y),
                    __uint_as_float(r.z), __uint_as_float(r.w));
  }
  __device__ __forceinline__ static void store4(float* dst, const float4& v) {
    *reinterpret_cast<float4*>(dst) = v;
  }
};

template <>
struct Convert<__nv_bfloat16> {
  // element 2w is the low half of word w (little-endian)
  __device__ __forceinline__ static void store(float* dst, const uint4& r) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(
        __uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
        __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
    reinterpret_cast<float4*>(dst)[1] = make_float4(
        __uint_as_float(r.z << 16), __uint_as_float(r.z & 0xffff0000u),
        __uint_as_float(r.w << 16), __uint_as_float(r.w & 0xffff0000u));
  }
  // 4 floats rounded to bf16, stored as 8 bytes
  __device__ __forceinline__ static void store4(__nv_bfloat16* dst,
                                                const float4& v) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pair(v.x, v.y),
                                                pair(v.z, v.w));
  }
  __device__ __forceinline__ static uint32_t pair(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
};

// Rows [r0, r0 + kTile) of one head, row r at base + r * row_stride, into
// shared rows of ld floats; rows at or past S are zeros. Every load of the
// tile is issued before any is stored.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* sm, int ld, const T* base,
                                          long long row_stride, int r0,
                                          int S) {
  constexpr int VEC = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int VPR = HD / VEC;                  // 16-byte loads per row
  constexpr int PER = kTile * VPR / kThreads;    // loads per thread
  static_assert(kTile * VPR % kThreads == 0, "tile loads");
  uint4 r[PER];
#pragma unroll
  for (int n = 0; n < PER; ++n) {
    const int idx = threadIdx.x + n * kThreads;
    const int row = r0 + idx / VPR;
    r[n] = make_uint4(0, 0, 0, 0);
    if (row < S)
      r[n] = __ldg(reinterpret_cast<const uint4*>(
          base + (long long)row * row_stride + (idx % VPR) * VEC));
  }
#pragma unroll
  for (int n = 0; n < PER; ++n) {
    const int idx = threadIdx.x + n * kThreads;
    Convert<T>::store(sm + (idx / VPR) * ld + (idx % VPR) * VEC, r[n]);
  }
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[a][c] += the dot products of shared rows A[ty + 16a] and B[tx + 16c]
// (a, c < 4) over HD columns; both row sets padded to ld floats, read as
// float4 (conflict-free with ld = HD + kPad).
template <int HD>
__device__ __forceinline__ void dot_4x4(float (&acc)[4][4], const float* A,
                                        const float* B, int ld, int ty,
                                        int tx) {
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 aa[4], bb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      aa[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * ld + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bb[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * ld + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[a][c] = fmaf(aa[a].x, bb[c].x, acc[a][c]);
        acc[a][c] = fmaf(aa[a].y, bb[c].y, acc[a][c]);
        acc[a][c] = fmaf(aa[a].z, bb[c].z, acc[a][c]);
        acc[a][c] = fmaf(aa[a].w, bb[c].w, acc[a][c]);
      }
  }
}

// acc[a][n][e] += sum over j < kTile of W[ty + 16a][j] * X[j][64n + 4tx + e]:
// W rows of ldw floats (read as float4 along j), X rows of ldx floats.
template <int HD>
__device__ __forceinline__ void matmul_rows(float (&acc)[4][HD / 64][4],
                                            const float* W, int ldw,
                                            const float* X, int ldx, int ty,
                                            int tx) {
  constexpr int NC = HD / 64;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 wa[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      wa[a] = *reinterpret_cast<const float4*>(W + (ty + 16 * a) * ldw + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 xx = *reinterpret_cast<const float4*>(
            X + (j + jj) * ldx + n * 64 + tx * 4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float w = comp(wa[a], jj);
          acc[a][n][0] = fmaf(w, xx.x, acc[a][n][0]);
          acc[a][n][1] = fmaf(w, xx.y, acc[a][n][1]);
          acc[a][n][2] = fmaf(w, xx.z, acc[a][n][2]);
          acc[a][n][3] = fmaf(w, xx.w, acc[a][n][3]);
        }
      }
    }
  }
}

}  // namespace onebit_flash
