// Pieces shared by the causal flash-attention kernels: the forward B11
// (flash_attention.cu) and its backward, B11-dkv and B11-dq
// (flash_attention_bwd.cu). The backward's fp32 instances run on the CUDA
// cores and stage 64-row tiles of q, k, v (and do) in shared memory as fp32
// rows, with 16-byte global loads. The bf16 instances and the forward's
// fp32 instance run on the tensor cores (wgmma_common.cuh): one warpgroup a
// CTA, 64-row bf16 tiles in 128-byte swizzled shared tiles, brought by TMA
// or, for the fp32 forward, split from fp32 in the kernel (the pieces at
// the end of this file).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace onebit_flash {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // queries per CTA, keys per tile
constexpr int kPad = 4;    // floats of padding per staged row

// The CUDA-core kernels (the backward's fp32 instances) are templates of
// their element type T, of which only float is instantiated.

// v rounded to T's precision, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

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

// ---- the bf16 instances: wgmma on the tensor cores ----

constexpr int kWgThreads = 128;   // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// A 64-row bf16 tile of HD columns in shared memory: HD / 64 swizzled
// blocks of [64 rows][128 bytes], each a TMA box.
template <int HD>
struct WgTile {
  static constexpr int kBytes = kTile * HD * 2;
  static constexpr int kBlock = kTile * 128;
};

// One thread: rows [r0, r0 + 64) of head n of row b of a [B, S, n, HD]
// tensor map into a swizzled tile at dst, one arrival on bar that expects
// the tile's bytes; rows at or past S arrive as zeros.
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int n, int r0, int b) {
  onebit_sm90::mbar_expect_tx(bar, WgTile<HD>::kBytes);
#pragma unroll
  for (int blk = 0; blk < HD / 64; ++blk)
    onebit_sm90::tma_load_4d(dst + blk * WgTile<HD>::kBlock, map, bar,
                             blk * 64, n, r0, b);
}

// d[HD / 2] += A (registers, a k16 fragment) . B, B a [k rows, HD] tile
// read as an MN-major operand through its descriptor (the transpose bit).
template <int HD>
__device__ __forceinline__ void mma_rs_mn(float (&d)[HD / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t desc);
template <>
__device__ __forceinline__ void mma_rs_mn<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  onebit_sm90::wgmma_rs_n64<1>(d, a, desc);
}
template <>
__device__ __forceinline__ void mma_rs_mn<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  onebit_sm90::wgmma_rs_n128<1>(d, a, desc);
}

// Descriptor of the k16 step kk of a K-major operand: a swizzled [64 rows,
// HD] tile at `tile` whose rows run along k (S = Q Kᵀ and its kin).
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return onebit_sm90::desc128(
      tile + (kk / 4) * WgTile<HD>::kBlock + (kk % 4) * 32, 16, 1024);
}
// Descriptor of the k16 step kk of an MN-major B: rows 16 kk.. + 15 of a
// swizzled [64 rows, HD] tile whose rows run along k (P V and its kin).
template <int HD>
__device__ __forceinline__ uint64_t mn_desc(uint32_t tile, int kk) {
  return onebit_sm90::desc128(tile + kk * 16 * 128, WgTile<HD>::kBlock,
                              1024);
}

// The 16 k-pairs of a 64 x 64 accumulator fragment (keys or queries along
// its columns) rounded to bf16 as the A operand of four k16 steps.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = onebit_sm90::bf16_pair(d[8 * kk + 2 * j],
                                        d[8 * kk + 2 * j + 1]);
}

// Host: a [B, S, n, HD] bf16 tensor at base, each row's [n, HD]
// contiguous, at batch and sequence strides sb and ss (elements), as a
// tensor map (innermost first) in boxes of 64 rows x 64 elements,
// 128-byte swizzled; a dimension of size 1 gets a stride it never steps.
inline bool make_rows_map(CUtensorMap* map, const void* base, int B, int S,
                          int n, int HD, long long sb, long long ss) {
  const long long row = S > 1 ? ss : (long long)n * HD;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)n, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)HD * 2, (cuuint64_t)row * 2,
                               (cuuint64_t)(B > 1 ? sb : row * S) * 2};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  return onebit_sm90::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                      4, base, dims, bytes, box,
                                      CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace onebit_flash
