// Causal full-sequence attention: kernel B11 of the port.
//
// Replaces onebit_tpu/kernels/attention.py flash_causal_attention, which
// repeats K/V for GQA, transposes to [B, H, S, D] and calls the upstream
// Pallas TPU flash-attention kernel with causal=True. This kernel computes
// the same function on the projections' own layout, with no repeat and no
// transpose:
//   q [B, S, nh, HD], k/v [B, S, nkv, HD] (T = float or bf16), read through
//   their batch and sequence strides (the [nh, HD] of a row contiguous);
//   out [B, S, nh, HD] contiguous, in T.
//
// The function, per (row b, head h, query i), kv head h / G:
//   s_j = (q_i . k_j) * HD**-0.5 for keys j <= i: fp32 dots of T operands;
//   online fp32 softmax; P_j = exp(s_j - m) rounded to T before the PV
//   product, which accumulates in fp32; out = acc / l, l the sum of the
//   unrounded P, cast to T. Every query sees key 0, so no row is ever fully
//   masked. Keys above the diagonal contribute exact zeros in the masked
//   softmax of the plain version, so skipping them computes the same
//   function. When asked (lse != nullptr), the row's log-sum-exp of the
//   scaled scores, m + log l in fp32, goes to lse [B, nh, S]: the residual
//   the backward kernels (flash_attention_bwd.cu) recompute P from, as the
//   upstream kernel's l and m are.
//
// Bound on an H100: operations. The causal half costs 4 * B * nh * HD *
// S(S+1)/2 flops, which at llama2-7b's eval shape (4 x 2048 x 32 x 128) is
// 137 GFLOP per layer for 0.27 GB of q, k, v and out: about 500 flops per
// byte.
//
// The bf16 instance (forward's default dtype and every KD step) is bound by
// the 989 TFLOP/s bf16 tensor-core peak (0.139 ms a layer), so both
// products run on the tensor cores through wgmma (sm_90a):
//   * one warpgroup (128 threads) per query tile of 64, head and row,
//     launched longest rows first; it walks the key tiles of 64 only up to
//     the diagonal and masks j > i inside the diagonal tile;
//   * Q is staged once; K tiles through a ring of two, V through one tile,
//     all by TMA (one thread issues each tile: q, k and v as [B, S, n, HD]
//     tensor maps through their strides, rows past S zero-filled) into
//     128-byte swizzled tiles, each with an mbarrier the warpgroup waits
//     on, so the loop has no block barrier: the next K tile is in flight
//     during this tile's two products, the next V tile during the next S
//     and its softmax. 66 KB of shared memory at HD 128 and 128 registers:
//     three CTAs an SM;
//   * S = Q Kᵀ: wgmma m64n64k16 with both operands in shared memory,
//     K-major (a key's row is its k), fp32 accumulators in registers;
//   * the online softmax runs on the accumulator fragments, in base 2 (the
//     scale folded with log2(e) into one fma before exp2): each thread
//     holds 2 rows x 16 keys, the row max and sum meet by shuffles among
//     the 4 lanes that share a row; O is rescaled in registers;
//   * O += P V: P converted to bf16 in place (the rounding the function
//     asks for) is the register A operand of wgmma m64n{HD}k16, its
//     fragment layout that of the S accumulator; V is read from its
//     natural [keys, HD] tile as an MN-major B (the descriptor's transpose
//     bit).
// What holds it back (PERF.md): each CTA runs S, its softmax and PV one
// after another, and three CTAs an SM do not fill the gaps: 0.32 ms at the
// eval shape, 43% of the tensor cores' rate. Overlapping S(j + 1) with
// PV(j) inside a warpgroup needs a third K/V stage, which costs the third
// CTA; the next step is two consumer warpgroups per CTA sharing K/V.
// The fp32 instance (the eval dtype, held to 2e-4 logits) runs on the CUDA
// cores' fp32 FMA, not TF32, against the 67 TFLOP/s fp32 peak (2.05 ms a
// layer):
//   * one CTA of 256 threads per (query tile of 64, head, row), launched
//     longest rows first; it walks the key tiles of 64 only up to the
//     diagonal and masks j > i inside the diagonal tile;
//   * each K and V tile is staged in shared memory as fp32 with 16-byte
//     global loads, every load of the tile issued before any is stored
//     (4-8 in flight per thread); the Q tile is staged once;
//   * a 16 x 16 thread grid: thread (ty, tx) owns score rows ty + 16a and
//     columns tx + 16c (a, c < 4), reading Q and K rows as float4 from
//     rows padded by 4 floats (conflict-free); the row max and sum meet by
//     shuffles within the 16 lanes of a row; P is written over the K tile;
//   * the same thread owns output rows ty + 16a and columns 64n + 4tx..+3,
//     reading P and V as float4;
//   * every global offset is 64-bit.
#include <math.h>

#include <type_traits>

#include "flash_attention_common.cuh"
#include "wgmma_common.cuh"

namespace onebit_flash {

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K (P over K) padded, V unpadded
  return (size_t)(2 * kTile * (HD + kPad) + kTile * HD) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_causal(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int S, int nh, int G, long long q_sb,
             long long q_ss, long long k_sb, long long k_ss, long long v_sb,
             long long v_ss, float scale) {
  constexpr int LDK = HD + kPad;     // Q, K rows
  constexpr int LDP = kTile + kPad;  // P rows
  constexpr int NC = HD / 64;        // float4 column groups of out per thread
  static_assert(HD % 64 == 0, "head_dim");
  static_assert(kTile * LDP <= kTile * LDK, "P fits over K");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * LDK;
  float* Vs = Ks + kTile * LDK;
  float* Ps = Ks;                    // P is written over K once scored

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qt * kTile;

  load_tile<T, HD>(Qs, LDK, q + b * q_sb + (long long)h * HD, q_ss, q0, S);

  float acc[4][NC][4], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -1e30f;
    l[a] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
  }

  const T* kb = k + b * k_sb + (long long)hk * HD;
  const T* vb = v + b * v_sb + (long long)hk * HD;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    load_tile<T, HD>(Ks, LDK, kb, k_ss, k0, S);
    load_tile<T, HD>(Vs, HD, vb, v_ss, k0, S);
    __syncthreads();

    // ---- 1. scores of the thread's 4 x 4 cells
    float s[4][4] = {};
    dot_4x4<HD>(s, Qs, Ks, LDK, ty, tx);
    // only the diagonal tile holds keys above the diagonal; a query row
    // past S (the last tile's padding) sees zero keys and is never stored
    const bool diag = kt == qt;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[a][c] = (diag && tx + 16 * c > ty + 16 * a) ? -INFINITY
                                                      : s[a][c] * scale;
    __syncthreads();   // every thread is done with K: P goes over it

    // ---- 2. online softmax; the 16 lanes of a row meet by shuffles
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - m_new);   // 0 above the diagonal
        sum += p;
        Ps[(ty + 16 * a) * LDP + tx + 16 * c] = round_to<T>(p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[a] = l[a] * alpha + sum;
      m[a] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] *= alpha;
    }
    __syncthreads();

    // ---- 3. acc += P . V
    matmul_rows<HD>(acc, Ps, LDP, Vs, HD, ty, tx);
    __syncthreads();   // before the next tile's loads overwrite P and V
  }

  // ---- out = acc / l, in T
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= S) continue;
    T* o = out + (((size_t)b * S + i) * nh + h) * HD;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      Convert<T>::store4(o + n * 64 + tx * 4,
                         make_float4(acc[a][n][0] / l[a], acc[a][n][1] / l[a],
                                     acc[a][n][2] / l[a],
                                     acc[a][n][3] / l[a]));
  }
  // ---- the rows' log-sum-exp, for the backward (every lane of a row holds
  // the same m and l)
  if (lse != nullptr && tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
      if (i < S) lse[((size_t)b * nh + h) * S + i] = m[a] + logf(l[a]);
    }
  }
}

// ---- the bf16 instance: wgmma on the tensor cores ----

using bf16 = __nv_bfloat16;
using namespace onebit_sm90;

constexpr int kWgThreads = 128;   // one warpgroup

template <int HD>
struct WgLayout {
  // a 64-row tile: HD / 64 swizzled blocks of [64 rows][128 bytes]
  static constexpr int kTileBytes = kTile * HD * 2;
  static constexpr int kBlock = kTile * 128;
  // Q, two K tiles, one V tile, four mbarriers (Q, K even, K odd, V),
  // + alignment
  static constexpr int kBytes = 4 * kTileBytes + 4 * 8 + 1024;
};

// One thread: rows [r0, r0 + 64) of head n of row b of a [B, S, n, HD]
// tensor map into a swizzled tile at dst (HD / 64 boxes of 64 x 128
// bytes), its bytes counted on bar; rows at or past S arrive as zeros.
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int n, int r0, int b) {
  mbar_expect_tx(bar, WgLayout<HD>::kTileBytes);
#pragma unroll
  for (int blk = 0; blk < HD / 64; ++blk)
    tma_load_4d(dst + blk * WgLayout<HD>::kBlock, map, bar, blk * 64, n, r0,
                b);
}

template <int HD>
__device__ __forceinline__ void pv_mma(float (&o)[HD / 2],
                                       const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void pv_mma<64>(float (&o)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  wgmma_rs_n64<1>(o, a, desc);
}
template <>
__device__ __forceinline__ void pv_mma<128>(float (&o)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  wgmma_rs_n128<1>(o, a, desc);
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flash_causal_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   bf16* __restrict__ out, float* __restrict__ lse, int S,
                   int nh, int G, float scale) {
  using L = WgLayout<HD>;
  constexpr int KS = HD / 16;   // k16 steps of S = Q Kᵀ
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;
  // tiles: Q, K of even and of odd key tiles, V; then their mbarriers
  const uint32_t vs = qs + 3 * L::kTileBytes;
  const uint32_t bar_q = qs + 4 * L::kTileBytes, bar_v = bar_q + 24;
  auto kslot = [&](int j) { return qs + (1 + (j & 1)) * L::kTileBytes; };
  auto bar_k = [&](int j) { return bar_q + 8 + 8 * (j & 1); };

  const int tid = threadIdx.x, lane = tid & 31;
  const int row = (tid >> 5) * 16 + (lane >> 2);   // and row + 8
  const int col = 2 * (lane & 3);
  const int qt = gridDim.x - 1 - blockIdx.x;       // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qt * kTile;
  const float scale2 = scale * 1.4426950408889634f;   // log2(e)

  // one thread issues every copy (TMA); each tile's mbarrier says it is in
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bar_q + 8 * i, 1);
    mbar_init_fence();
    tma_tile<HD>(qs, &qmap, bar_q, h, q0, b);
    tma_tile<HD>(kslot(0), &kmap, bar_k(0), hk, 0, b);
    tma_tile<HD>(vs, &vmap, bar_v, hk, 0, b);
  }
  __syncthreads();
  mbar_wait(bar_q, 0);

  float o[HD / 2], m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    // the next K tile goes over the one S(kt - 1) read (the warpgroup
    // waited for it there)
    if (tid == 0 && kt < qt)
      tma_tile<HD>(kslot(kt + 1), &kmap, bar_k(kt + 1), hk,
                    (kt + 1) * kTile, b);
    mbar_wait(bar_k(kt), (kt >> 1) & 1);
    const uint32_t ks = kslot(kt);

    // ---- 1. s = Q Kᵀ (fp32)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk / 4) * L::kBlock + (kk % 4) * 32;
      wgmma_ss_n64(s, desc128(qs + off, 16, 1024),
                   desc128(ks + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // ---- 2. mask above the diagonal (only the diagonal tile has such
    // keys; a query row past S is never stored), online softmax in base 2:
    // m is the running max of s * scale * log2(e), P = 2**(s * that - m)
    if (kt == qt) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i / 4) + col + (i & 1) > row + 8 * ((i >> 1) & 1))
          s[i] = -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale2);
      alpha[r] = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[4 * i + 2 * r + e], scale2, -m_new));
          s[4 * i + 2 * r + e] = p;   // 0 where masked
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    mbar_wait(bar_v, kt & 1);   // V(kt) is in
    // ---- 3. O += P V: P in bf16 as the register A operand (k = keys)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = bf16_pair(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      pv_mma<HD>(o, pa[kk], desc128(vs + kk * 16 * 128, L::kBlock, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    // the next V tile over this one, in flight during S(kt + 1) and its
    // softmax
    if (tid == 0 && kt < qt)
      tma_tile<HD>(vs, &vmap, bar_v, hk, (kt + 1) * kTile, b);
  }

  // ---- out = O / l in bf16; the rows' log-sum-exp for the backward
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + row + 8 * r;
    if (i >= S) continue;
    const float inv = 1.f / l[r];
    bf16* orow = out + (((size_t)b * S + i) * nh + h) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c + col) =
          bf16_pair(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * nh + h) * S + i] =
          (m[r] + log2f(l[r])) * 0.6931471805599453f;   // ln(2)
  }
}

template <int HD>
int run_wgmma(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int S, int nh, int G,
              const long long* strides, float scale, cudaStream_t st) {
  constexpr int smem = WgLayout<HD>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_causal_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  // q, k, v as [B, S, n, HD] tensor maps (innermost first) in boxes of 64
  // rows x 64 elements, 128-byte swizzled; a dimension of size 1 gets a
  // stride it never steps
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const int heads[3] = {nh, nh / G, nh / G};
  for (int i = 0; i < 3; ++i) {
    const long long sb = strides[2 * i], ss = strides[2 * i + 1];
    const long long row = S > 1 ? ss : (long long)heads[i] * HD;
    const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads[i],
                                (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t bytes[3] = {(cuuint64_t)HD * 2, (cuuint64_t)row * 2,
                                 (cuuint64_t)(B > 1 ? sb : row * S) * 2};
    const cuuint32_t box[4] = {64, 1, kTile, 1};
    if (!make_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         bases[i], dims, bytes, box,
                         CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((S + kTile - 1) / kTile, nh, B);
  flash_causal_wgmma<HD><<<grid, kWgThreads, smem, st>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), lse, S, nh, G,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int run(const void* q, const void* k, const void* v, void* out, float* lse,
        int B, int S, int nh, int G, const long long* strides, float scale,
        cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return run_wgmma<HD>(q, k, v, out, lse, B, S, nh, G, strides, scale, st);
  } else {
    constexpr size_t smem = smem_bytes<HD>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_causal<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((S + kTile - 1) / kTile, nh, B);
    flash_causal<T, HD><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, S, nh, G,
        strides[0], strides[1], strides[2], strides[3], strides[4],
        strides[5], scale);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int by_head_dim(int hd, const void* q, const void* k, const void* v,
                void* out, float* lse, int B, int S, int nh, int G,
                const long long* strides, float scale, cudaStream_t st) {
  if (hd == 64)
    return run<T, 64>(q, k, v, out, lse, B, S, nh, G, strides, scale, st);
  if (hd == 128)
    return run<T, 128>(q, k, v, out, lse, B, S, nh, G, strides, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace onebit_flash

// q [B, S, nh, hd], k/v [B, S, nkv, hd] in one dtype (0 = float32,
// 1 = bfloat16), each row's [n, hd] contiguous, at batch and sequence
// strides (in elements) q_sb, q_ss, k_sb, k_ss, v_sb, v_ss; out [B, S, nh,
// hd] contiguous in the same dtype; lse [B, nh, S] fp32 contiguous, or null
// when not wanted; nh a multiple of nkv; hd 64 or 128.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int onebit_flash_causal_attention(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int nh, int nkv, int hd, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss, int dtype,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || nkv < 1 || nh % nkv)
    return (int)cudaErrorInvalidValue;
  const long long strides[6] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss};
  const int G = nh / nkv;
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return onebit_flash::by_head_dim<__nv_bfloat16>(
        hd, q, k, v, out, l, B, S, nh, G, strides, scale, st);
  return onebit_flash::by_head_dim<float>(hd, q, k, v, out, l, B, S, nh, G,
                                          strides, scale, st);
}
