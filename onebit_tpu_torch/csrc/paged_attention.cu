// Decode attention through page tables: kernel B10 of the port.
//
// Replaces onebit_tpu/kernels/paged_attention.py paged_attention_flat (body
// _kernel): one query token per row against a flat multi-layer page pool.
// Two instances share this body: float pages (bf16 or f32, the dtype of q)
// and int8 pages with raw absmax scales.
//
// Layouts of one layer (the wrapper passes the layer slice's base pointers;
// every offset below is 64-bit, since a llama2-7b pool at the engine's
// defaults holds 32 x 1025 x 32 x 16 x 128 > 2**31 elements):
//   K, V  [P, nkv, ps, HD]   page p, head n: one contiguous [ps, HD] slab
//   Ks, Vs [P, nkv, ps] f32  raw absmax of (page, head, slot), int8 only
//   q [B, nkv * G, HD] (T), out [B, nkv * G, HD] f32
//   lengths [B], tables [B, mp] int32; page ids must lie in [0, P)
//
// The function (paged_attention.py:54-126): an int8 element dequantizes to
// q's dtype as (kq * (ks * (1 / 127.5))) rounded to T; scores are fp32 dots
// of T operands times HD**-0.5; positions >= lengths[b] are masked; the
// softmax is fp32, P = exp(s - m) is rounded to T before the PV sum, which
// accumulates in fp32; out = acc / max(l, 1e-30) with l the sum of the
// unrounded P.
//
// Bound on an H100: HBM bytes. Every K and V byte of the pages under
// ceil(length / ps) is read once for 4 flops per element and query head,
// far below the 295 flops per byte where bf16 compute would bound it. At
// llama2-7b batch 8 with rows near 2048 positions that is about 0.27 GB of
// bf16 pages, 80 us at 3.35 TB/s. The design reads each page byte once,
// with 16-byte loads, and keeps scores, P and the accumulator on chip:
//   * one CTA per (kv head n, row b) serves the G query heads of that kv
//     head, so each page byte is read by one CTA only;
//   * the CTA walks its row in tiles of 64 positions, only over positions
//     < length: a masked position adds an exact zero in the reference, so
//     skipping it is the same function; it reads each position's page id
//     from the table itself (the Pallas kernel's scalar prefetch);
//   * HD / 8 lanes cover one K or V row, 8 elements each (16 bytes of bf16,
//     32 of f32, 8 of int8), so a 128-thread CTA has 8 (HD = 128) or 16
//     (HD = 64) rows in flight per pass, and each thread issues 4 row loads
//     before their arithmetic;
//   * the q . k partial dots meet by warp shuffles within the row's lanes;
//     the online softmax runs one warp per query head; each thread keeps
//     G x 8 fp32 accumulators for its 8 columns; the row groups' partial
//     accumulators meet in shared memory at the end.
// Simple first: one serial walk per CTA (256 CTAs at 7B batch 8), no
// split-T, no cp.async/TMA pipelining, no tensor cores. The Pallas kernel's
// concat-convert slab and pages-per-block schedule exist for the TPU's VMEM
// and DMA queue and have no counterpart here.
//
// A row with length 0 gets out = 0 (finite; the Pallas kernel gives a
// uniform average there; the engine never reads one).
#include <type_traits>

#include "kv_attention_common.cuh"

namespace onebit_paged {

using onebit_kv::Row8;
using onebit_kv::round_to;
using onebit_kv::to_f32;
using onebit_kv::warp_max;
using onebit_kv::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // positions per tile
constexpr int kEpl = 8;    // elements of a K/V row per lane
constexpr int kBatch = 4;  // row loads a thread keeps in flight

template <typename T, typename P, int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_attention(const T* __restrict__ q, float* __restrict__ out,
                const P* __restrict__ kp, const float* __restrict__ ks,
                const P* __restrict__ vp, const float* __restrict__ vs,
                const int32_t* __restrict__ lengths,
                const int32_t* __restrict__ tables, int nkv, int ps, int mp,
                float hd_scale) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  constexpr int LPR = HD / kEpl;         // lanes per row: 16 or 8
  constexpr int NGRP = kThreads / LPR;   // rows in flight per pass
  constexpr int RPG = kTile / NGRP;      // rows of a tile per lane group
  static_assert(HD % (8 * kEpl) == 0 && LPR <= 32, "unsupported head_dim");
  static_assert(RPG % kBatch == 0, "row batches");

  __shared__ float s_s[G][kTile];              // scores of the tile
  __shared__ float p_s[G][kTile];              // P rounded to T
  __shared__ float red[NGRP][G][HD];           // partial accumulators
  __shared__ long long row_s[2][kTile];        // (page, head, slot) rows
  __shared__ float m_s[G], l_s[G], alpha_s[G];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x, b = blockIdx.y;
  const int grp = tid / LPR, li = tid % LPR, d0 = li * kEpl;
  const size_t bn = (size_t)b * nkv + n;
  const float inv_max = 1.0f / 127.5f;

  // this lane's 8 columns of the G query heads
  float qr[G][kEpl];
  const T* qb = q + bn * G * HD;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kEpl; ++e) qr[g][e] = to_f32(qb[g * HD + d0 + e]);
  if (tid < G) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }

  const int n_tok = max(0, min(lengths[b], mp * ps));
  const int32_t* tbl = tables + (size_t)b * mp;
  float acc[G][kEpl];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kEpl; ++e) acc[g][e] = 0.f;

  for (int t0 = 0, it = 0; t0 < n_tok; t0 += kTile, ++it) {
    // double-buffered: the next tile's writes cannot meet this tile's reads
    long long* rows_of = row_s[it & 1];
    const int rows = min(kTile, n_tok - t0);
    if (tid < kTile) {
      const int t = t0 + tid;
      rows_of[tid] = tid < rows
                         ? ((long long)tbl[t / ps] * nkv + n) * ps + t % ps
                         : 0;
    }
    __syncthreads();

    // ---- 1. scores: q . k over the row's lanes, times HD**-0.5
#pragma unroll
    for (int r0 = 0; r0 < RPG; r0 += kBatch) {
      Row8<P> kr[kBatch];
      float ksc[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = grp + (r0 + j) * NGRP;
        kr[j].zero();
        ksc[j] = 0.f;
        if (r < rows) {
          const long long row = rows_of[r];
          kr[j].load(kp + (size_t)row * HD + d0);
          if (QUANT) ksc[j] = ks[row] * inv_max;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = grp + (r0 + j) * NGRP;
        float dot[G];
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) {
          const float kv =
              QUANT ? round_to<T>(kr[j].get(e) * ksc[j]) : kr[j].get(e);
#pragma unroll
          for (int g = 0; g < G; ++g) dot[g] = fmaf(qr[g][e], kv, dot[g]);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
        if (li == 0) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            s_s[g][r] = r < rows ? dot[g] * hd_scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // ---- 2. online softmax, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = -1e30f;
      for (int col = lane; col < kTile; col += 32)
        mx = fmaxf(mx, s_s[g][col]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int col = lane; col < kTile; col += 32) {
        const float p = expf(s_s[g][col] - m_new);  // 0 past the length
        sum += p;
        p_s[g][col] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // ---- 3. acc = acc * alpha + P . V
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = alpha_s[g];
#pragma unroll
      for (int e = 0; e < kEpl; ++e) acc[g][e] *= a;
    }
#pragma unroll
    for (int r0 = 0; r0 < RPG; r0 += kBatch) {
      Row8<P> vr[kBatch];
      float vsc[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = grp + (r0 + j) * NGRP;
        vr[j].zero();
        vsc[j] = 0.f;
        if (r < rows) {
          const long long row = rows_of[r];
          vr[j].load(vp + (size_t)row * HD + d0);
          if (QUANT) vsc[j] = vs[row] * inv_max;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = grp + (r0 + j) * NGRP;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) {
          const float vv =
              QUANT ? round_to<T>(vr[j].get(e) * vsc[j]) : vr[j].get(e);
#pragma unroll
          for (int g = 0; g < G; ++g)
            acc[g][e] = fmaf(p_s[g][r], vv, acc[g][e]);
        }
      }
    }
    // no barrier here: the next tile writes row_s's other buffer first, and
    // s_s, p_s and alpha_s only after a barrier every thread reaches once
    // this pass is done
  }

  // ---- the row groups' partial accumulators meet; out = acc / l
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kEpl; ++e) red[grp][g][d0 + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < NGRP; ++r) s += red[r][g][d];
    out[bn * G * HD + i] = s / fmaxf(l_s[g], 1e-30f);
  }
}

// Host side: pick the instance for (q dtype, page kind, head_dim, group).
template <typename T, typename P>
struct Launch {
  template <int HD, int G>
  static int run(const void* q, void* out, const void* kp, const void* ks,
                 const void* vp, const void* vs, const void* lengths,
                 const void* tables, int B, int nkv, int ps, int mp,
                 float hd_scale, cudaStream_t st) {
    paged_attention<T, P, HD, G><<<dim3(nkv, B), kThreads, 0, st>>>(
        static_cast<const T*>(q), static_cast<float*>(out),
        static_cast<const P*>(kp), static_cast<const float*>(ks),
        static_cast<const P*>(vp), static_cast<const float*>(vs),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(tables), nkv, ps, mp, hd_scale);
    return (int)cudaGetLastError();
  }

  template <int HD>
  static int by_group(int g, const void* q, void* out, const void* kp,
                      const void* ks, const void* vp, const void* vs,
                      const void* lengths, const void* tables, int B, int nkv,
                      int ps, int mp, float hd_scale, cudaStream_t st) {
#define ONEBIT_PAGED_G(GV)                                                   \
  if (g == GV)                                                               \
    return run<HD, GV>(q, out, kp, ks, vp, vs, lengths, tables, B, nkv, ps, \
                       mp, hd_scale, st);
    ONEBIT_PAGED_G(1)
    ONEBIT_PAGED_G(2)
    ONEBIT_PAGED_G(4)
    ONEBIT_PAGED_G(8)
#undef ONEBIT_PAGED_G
    return (int)cudaErrorInvalidValue;
  }

  static int by_head_dim(int hd, int g, const void* q, void* out,
                         const void* kp, const void* ks, const void* vp,
                         const void* vs, const void* lengths,
                         const void* tables, int B, int nkv, int ps, int mp,
                         float hd_scale, cudaStream_t st) {
    if (hd == 64)
      return by_group<64>(g, q, out, kp, ks, vp, vs, lengths, tables, B, nkv,
                          ps, mp, hd_scale, st);
    if (hd == 128)
      return by_group<128>(g, q, out, kp, ks, vp, vs, lengths, tables, B,
                           nkv, ps, mp, hd_scale, st);
    return (int)cudaErrorInvalidValue;
  }
};

template <typename T>
int by_pages(int quant, int hd, int g, const void* q, void* out,
             const void* kp, const void* ks, const void* vp, const void* vs,
             const void* lengths, const void* tables, int B, int nkv, int ps,
             int mp, float hd_scale, cudaStream_t st) {
  if (quant)
    return Launch<T, int8_t>::by_head_dim(hd, g, q, out, kp, ks, vp, vs,
                                          lengths, tables, B, nkv, ps, mp,
                                          hd_scale, st);
  return Launch<T, T>::by_head_dim(hd, g, q, out, kp, ks, vp, vs, lengths,
                                   tables, B, nkv, ps, mp, hd_scale, st);
}

}  // namespace onebit_paged

// q [B, nkv * g, hd] (dtype 0 = float32, 1 = bfloat16), out [B, nkv * g, hd]
// f32; the layer's pages k/v [P, nkv, ps, hd] in q's dtype (quant = 0) or
// int8 with scales k_scales/v_scales [P, nkv, ps] f32 (quant = 1; null
// otherwise); lengths [B] and page_indices [B, mp] int32 on the device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int onebit_paged_attention(
    const void* q, void* out, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* lengths,
    const void* page_indices, int B, int nkv, int g, int hd, int ps, int mp,
    int dtype, int quant, float hd_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return onebit_paged::by_pages<__nv_bfloat16>(
        quant, hd, g, q, out, k_pages, k_scales, v_pages, v_scales, lengths,
        page_indices, B, nkv, ps, mp, hd_scale, st);
  return onebit_paged::by_pages<float>(
      quant, hd, g, q, out, k_pages, k_scales, v_pages, v_scales, lengths,
      page_indices, B, nkv, ps, mp, hd_scale, st);
}
