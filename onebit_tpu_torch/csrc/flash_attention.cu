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
// The fp32 instance (the eval dtype and the fp32 KD step, held to 1e-4 of
// the plain fp32 version) also runs both products on the bf16 tensor cores,
// on operands split into bf16 parts, as K3's fp32 instance does
// (bitlinear_large_m.cu). A float x is hi + mid + lo, hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid), each difference exact in fp32, so
// the three parts carry x's 24 bits and every product of two parts is exact
// in fp32:
//   * S = Q Kᵀ needs about 2**-20 relative (a score error e moves the
//     context by about e * |v|, and the scores reach |25| at the eval
//     inputs): six products, Qhi Khi + (Qhi Kmid + Qmid Khi + Qmid Kmid +
//     Qhi Klo + Qlo Khi), dropping terms of 2**-24 and below;
//   * O += P V the same six, P (fp32, unrounded in this instance) split in
//     registers into the A fragments, V into three tiles read MN-major as
//     in the bf16 instance: the forward alone would pass with three (2**-17
//     on the output), but the backward's di = Σ o·do turns that into
//     gradient errors of 1.4e-4 where the gradient is zero (S = 1: P = 1,
//     and three products drop V's low part);
//   * the tensor cores' fp32 sums round toward zero, each add up to an ulp
//     of the running sum, one way: so the large product (8 k16 steps for S,
//     4 for a key tile's P V) sums apart from the five small ones (at 2**-8
//     of its size), the two joined on the CUDA cores; each key tile's P V
//     sums afresh and joins O, rescaled by alpha, on the CUDA cores, so O's
//     error does not grow with the number of key tiles; P V runs in two
//     halves of 64 columns to keep its four accumulators in registers;
//   * the splits are made in the kernel: the warpgroup reads each fp32 tile
//     with 16-byte loads (through L2: 32 query tiles read each K/V tile)
//     and writes its parts as 128-byte swizzled bf16 tiles, the layout TMA
//     gives the bf16 instance. Q's three parts stay (48 KB at HD 128); K's
//     three parts (48 KB) give way to V's once S is done, so a CTA holds
//     96 KB and two CTAs share an SM, one converting while the other
//     multiplies.
// Its bound is twelve bf16 products at the tensor cores' peak (0.834 ms at
// the eval shape); the old CUDA-core kernel's was the fp32 FMA rate (2.05
// ms).
#include <math.h>

#include <type_traits>

#include "flash_attention_common.cuh"
#include "wgmma_common.cuh"

namespace onebit_flash {

// ---- the bf16 instance: wgmma on the tensor cores ----

using bf16 = __nv_bfloat16;
using namespace onebit_sm90;

template <int HD>
struct WgLayout {
  // Q, two K tiles, one V tile, four mbarriers (Q, K even, K odd, V),
  // + alignment
  static constexpr int kBytes = 4 * WgTile<HD>::kBytes + 4 * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flash_causal_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   bf16* __restrict__ out, float* __restrict__ lse, int S,
                   int nh, int G, float scale) {
  constexpr int TB = WgTile<HD>::kBytes;
  constexpr int KS = HD / 16;   // k16 steps of S = Q Kᵀ
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;
  // tiles: Q, K of even and of odd key tiles, V; then their mbarriers
  const uint32_t vs = qs + 3 * TB;
  const uint32_t bar_q = qs + 4 * TB, bar_v = bar_q + 24;
  auto kslot = [&](int j) { return qs + (1 + (j & 1)) * TB; };
  auto bar_k = [&](int j) { return bar_q + 8 + 8 * (j & 1); };

  const int tid = threadIdx.x, lane = tid & 31;
  const int row = (tid >> 5) * 16 + (lane >> 2);   // and row + 8
  const int col = 2 * (lane & 3);
  const int qt = gridDim.x - 1 - blockIdx.x;       // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qt * kTile;
  const float scale2 = scale * kLog2e;

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
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(s, kmajor_desc<HD>(qs, kk), kmajor_desc<HD>(ks, kk));
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
    pack_a(pa, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_mn<HD>(o, pa[kk], mn_desc<HD>(vs, kk));
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

// ---- the fp32 instance: split operands on the bf16 tensor cores ----

// Q's three parts, then K's three (V's two over K's hi and mid), + alignment
template <int HD>
struct SplitLayout {
  static constexpr int kBytes = 6 * WgTile<HD>::kBytes + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_causal_split(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ lse, int S, int nh, int G,
                   long long q_sb, long long q_ss, long long k_sb,
                   long long k_ss, long long v_sb, long long v_ss,
                   float scale) {
  constexpr int TB = WgTile<HD>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ks = qs + 3 * TB;   // K hi, mid, lo; V hi, mid after S

  const int tid = threadIdx.x, lane = tid & 31;
  const int row = (tid >> 5) * 16 + (lane >> 2);   // and row + 8
  const int col = 2 * (lane & 3);
  const int qt = gridDim.x - 1 - blockIdx.x;       // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qt * kTile;

  split_tile<HD, 3>(qs, q + b * q_sb + (long long)h * HD, q_ss, q0, S);

  float o[HD / 2], m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  const float* kb = k + b * k_sb + (long long)hk * HD;
  const float* vb = v + b * v_sb + (long long)hk * HD;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();   // the last P V is done with V's parts
    split_tile<HD, 3>(ks, kb, k_ss, k0, S);
    fence_proxy_async();
    __syncthreads();

    // ---- 1. s = Qhi Khi + (the five small products), summed apart
    float s[32];
    split_product_ss<HD>(s, qs, ks);

    // ---- 2. scale, mask above the diagonal (only the diagonal tile has
    // such keys; a query row past S is never stored), online softmax
    const bool diag = kt == qt;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = (diag && 8 * (i / 4) + col + (i & 1) > row + 8 * ((i >> 1) & 1))
                 ? -INFINITY
                 : s[i] * scale;
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[4 * i + 2 * r + e] - m_new);
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

    // ---- 3. V's three parts over K's, once every warp's S is done
    __syncthreads();
    split_tile<HD, 3>(ks, vb, v_ss, k0, S);
    fence_proxy_async();
    __syncthreads();

    // ---- 4. O += Phi Vhi + (the five small products), for each 64
    // columns of V: two fresh accumulators joined into O on the CUDA cores
    uint32_t pa[3][4][4];   // P's hi, mid and lo as A fragments
    split_a(pa, s);
#pragma unroll
    for (int half = 0; half < HD / 64; ++half) {
      float big[32], sm2[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) big[i] = sm2[i] = 0.f;
      fence_regs(big);
      fence_regs(sm2);
      wgmma_fence();
      // P part pp times V part vp, V's 64 columns `half` (MN-major)
      auto pv = [&](float (&d)[32], int pp, int vp) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n64<1>(d, pa[pp][kk],
                          mn_desc<HD>(ks + vp * TB + half * WgTile<HD>::kBlock,
                                      kk));
      };
      pv(sm2, 1, 1);   // smallest first, as for S
      pv(sm2, 0, 2);
      pv(sm2, 2, 0);
      pv(sm2, 0, 1);
      pv(sm2, 1, 0);
      pv(big, 0, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(big);
      fence_regs(sm2);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[32 * half + i] += big[i] + sm2[i];
    }
  }

  // ---- out = O / l in fp32; the rows' log-sum-exp for the backward
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + row + 8 * r;
    if (i >= S) continue;
    float* orow = out + (((size_t)b * S + i) * nh + h) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c + col) =
          make_float2(o[4 * c + 2 * r] / l[r], o[4 * c + 2 * r + 1] / l[r]);
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * nh + h) * S + i] = m[r] + logf(l[r]);
  }
}

template <int HD>
int run_split(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int S, int nh, int G,
              const long long* strides, float scale, cudaStream_t st) {
  constexpr int smem = SplitLayout<HD>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_causal_split<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kTile - 1) / kTile, nh, B);
  flash_causal_split<HD><<<grid, kWgThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, nh, G,
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
      scale);
  return (int)cudaGetLastError();
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
  // q, k, v as [B, S, n, HD] tensor maps
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const int heads[3] = {nh, nh / G, nh / G};
  for (int i = 0; i < 3; ++i)
    if (!make_rows_map(&maps[i], bases[i], B, S, heads[i], HD,
                       strides[2 * i], strides[2 * i + 1]))
      return (int)cudaErrorInvalidValue;
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
  if constexpr (std::is_same<T, bf16>::value)
    return run_wgmma<HD>(q, k, v, out, lse, B, S, nh, G, strides, scale, st);
  else
    return run_split<HD>(q, k, v, out, lse, B, S, nh, G, strides, scale, st);
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

// The dynamic shared bytes a CTA of the forward asks for (0: no such
// instance).
extern "C" int onebit_flash_smem_bytes(int hd, int dtype) {
  using namespace onebit_flash;
  if (hd != 64 && hd != 128) return 0;
  if (dtype == 1)
    return hd == 64 ? WgLayout<64>::kBytes : WgLayout<128>::kBytes;
  return hd == 64 ? SplitLayout<64>::kBytes : SplitLayout<128>::kBytes;
}
