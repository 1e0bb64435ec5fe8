// Pieces shared by the causal flash-attention kernels: the forward B11
// (flash_attention.cu) and its backward, B11-dkv and B11-dq
// (flash_attention_bwd.cu). Every instance runs on the tensor cores
// (wgmma_common.cuh) on 64-row bf16 tiles in 128-byte swizzled shared
// tiles: brought by TMA (the bf16 instances, one warpgroup a CTA) or, for
// the fp32 instances, split from fp32 in the kernel into three bf16 parts
// (split_pair, split_tile, split_a, split_product_ss at the end of this
// file).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace onebit_flash {

constexpr int kTile = 64;         // queries per CTA, keys per tile
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

// ---- fp32 operands as three bf16 parts (the fp32 instances) ----
//
// A float x is hi + mid + lo, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid), each difference exact in fp32, so the three parts
// carry x's 24 bits and every product of two parts is exact in fp32. An
// fp32 product A B runs as hi hi apart from the five small products (the
// terms at 2**-8 and 2**-16 of it, smallest first: mid mid, hi lo, lo hi,
// hi mid, mid hi), dropping those of 2**-24 and below; the two sums are
// joined on the CUDA cores, since the tensor cores' fp32 sums round toward
// zero (each add loses up to an ulp of the running sum, one way).

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// The bf16 parts of x (NP of hi, mid, lo) as bf16 pairs of (x0, x1).
template <int NP>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&w)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    w[p] = onebit_sm90::bits_of(h);
    const float2 hf = __bfloat1622float2(h);
    x0 -= hf.x;   // exact: the rounding error of a bf16 rounding
    x1 -= hf.y;
  }
}

// Rows [r0, r0 + 64) of one head (row r at base + r * ss, HD contiguous
// floats) split into NP bf16 parts, part p a swizzled tile at dst + p *
// the tile's bytes; rows at or past S are zeros. The NT threads of the CTA
// (threadIdx.x < NT) take 8-float chunks, up to four at a time in flight.
template <int HD, int NP, int NT = kWgThreads>
__device__ __forceinline__ void split_tile(uint32_t dst, const float* base,
                                           long long ss, int r0, int S) {
  constexpr int CPR = HD / 8;                      // chunks per row
  constexpr int PER = kTile * CPR / NT;            // chunks per thread
  constexpr int BATCH = PER < 4 ? PER : 4;
  static_assert(PER * NT == kTile * CPR && PER % BATCH == 0, "chunks");
#pragma unroll
  for (int n0 = 0; n0 < PER; n0 += BATCH) {
    float4 x[BATCH][2];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int idx = threadIdx.x + (n0 + j) * NT;
      const int r = idx / CPR, c = idx % CPR;
      x[j][0] = x[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < S) {
        const float4* src = reinterpret_cast<const float4*>(
            base + (long long)(r0 + r) * ss + 8 * c);
        x[j][0] = __ldg(src);
        x[j][1] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int idx = threadIdx.x + (n0 + j) * NT;
      const int r = idx / CPR, c = idx % CPR;
      uint32_t w[4][NP];
      split_pair<NP>(x[j][0].x, x[j][0].y, w[0]);
      split_pair<NP>(x[j][0].z, x[j][0].w, w[1]);
      split_pair<NP>(x[j][1].x, x[j][1].y, w[2]);
      split_pair<NP>(x[j][1].z, x[j][1].w, w[3]);
      const uint32_t off =
          (c / 8) * WgTile<HD>::kBlock + onebit_sm90::swizzle128(r, c % 8);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        st_shared_v4(dst + p * WgTile<HD>::kBytes + off, w[0][p], w[1][p],
                     w[2][p], w[3][p]);
    }
  }
}

// The 16 k-pairs of a 64 x 64 fp32 accumulator fragment (keys or queries
// along its columns) split into three bf16 parts, part p the A operand of
// four k16 steps in a[p].
__device__ __forceinline__ void split_a(uint32_t (&a)[3][4][4],
                                        const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t w[3];
      split_pair<3>(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1], w);
#pragma unroll
      for (int p = 0; p < 3; ++p) a[p][kk][j] = w[p];
    }
}

// d = A Bᵀ, 64 x 64 in fp32 on one warpgroup: A's and B's three part tiles
// at a + p TB and b + p TB ([64 rows, HD], K-major), hi hi summed apart
// from the five small products, the two joined here (S = Q Kᵀ and its kin
// in the fp32 instances).
template <int HD>
__device__ __forceinline__ void split_product_ss(float (&d)[32], uint32_t a,
                                                 uint32_t b) {
  using namespace onebit_sm90;
  constexpr int TB = WgTile<HD>::kBytes;
  float sm[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = sm[i] = 0.f;
  // the zeros in place before the fence (else ptxas sets them between the
  // products and injects a wait there)
  fence_regs(d);
  fence_regs(sm);
  wgmma_fence();
  auto small = [&](int ap, int bp) {   // A part ap times B part bp
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sm, kmajor_desc<HD>(a + ap * TB, kk),
                   kmajor_desc<HD>(b + bp * TB, kk));
  };
  small(1, 1);   // smallest first: mid mid, hi lo, lo hi, hi mid, mid hi
  small(0, 2);
  small(2, 0);
  small(0, 1);
  small(1, 0);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(d, kmajor_desc<HD>(a, kk), kmajor_desc<HD>(b, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(sm);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] += sm[i];
}

}  // namespace onebit_flash
