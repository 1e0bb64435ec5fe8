// Decode attention over the flat stacked KV pool: kernel B9 of the port.
//
// Replaces onebit_tpu/kernels/kv_attention.py kv_attention_decode (body
// _kernel): one query token per row against layer `layer` of the pools
// [L, B, T, nkv, HD] that batch generation decodes from (the dense KVCache,
// and the flat int8 QuantKVCache), read only; the caller writes the cache.
// Three instances share this body, each counted apart by the wrapper: int8
// pools with pre-divided fp32 scales (absmax / 127), and pools of q's dtype
// (bf16 or f32) with no scales.
//
// Layouts of one layer (the wrapper passes the layer slice's base pointers;
// every offset below is 64-bit: a llama2-7b pool at batch 8 and T 2048 holds
// 2**31 elements, and its byte offsets pass 2**32 at layer 31):
//   K, V  [B, T, nkv, HD]   position t of head n: HD contiguous elements,
//                           nkv * HD elements after position t - 1
//   Ks, Vs [B, T, nkv] f32  int8 pools only
//   q, out [B, nkv * G, HD] (T)
//   lengths, starts [B] int32; row b attends positions [starts[b], lengths[b])
//
// The function (kv_attention.py:52-124): scores are fp32 dots of q with K
// (int8 pools: times the position's K scale), times HD**-0.5; positions
// outside [start, length) are masked; the softmax is fp32; P = exp(s - m),
// times the position's V scale for int8 pools, is rounded to q's dtype
// before the PV sum, which accumulates in fp32; out = acc / max(l, 1e-30) in
// q's dtype, with l the sum of the unrounded P.
//
// Bound on an H100: HBM bytes. Every K and V byte (and scale) of a row's
// positions in [start, length) is read once for 4 flops per element and
// query head, far below the 295 flops per byte where bf16 compute would
// bound it. The design is B10's (paged_attention.cu) without the page
// table: it reads each pool byte once, with 8-byte (int8) or 16-byte loads,
// and keeps scores, P and the accumulator on chip:
//   * one CTA per (kv head n, row b) serves the G query heads of that kv
//     head, so each pool byte is read by one CTA only;
//   * the CTA walks its row in tiles of 64 positions from `start` up to
//     `length` (a masked position adds an exact zero in the reference, so
//     skipping it is the same function); the tiles start at the row's
//     first position, so a row's arithmetic depends on its positions
//     relative to `start` only: a left-padded batch (generate) and the
//     same prompts at position 0 (the serving engine) give the same bits;
//   * K is read the way kv_attention_common.cuh reads V: HD / 8 lanes cover
//     one position's row, 8 elements each, so a 128-thread CTA has 8
//     (HD = 128) or 16 (HD = 64) rows in flight per pass, and each thread
//     issues 4 row loads before their arithmetic;
//   * the q . k partial dots meet by warp shuffles within the row's lanes;
//     the online softmax runs one warp per query head; each thread keeps
//     G x 8 fp32 accumulators for its 8 columns; the row groups' partial
//     accumulators meet in shared memory at the end.
// Simple first: one serial walk per CTA (256 CTAs at 7B batch 8), no
// split-T, no cp.async/TMA pipelining, no tensor cores.
//
// A row with nothing to attend (length 0, or start >= length) gets out = 0
// (finite; the Pallas kernel gives a uniform average there; no caller reads
// it).
#include <type_traits>

#include "kv_attention_common.cuh"

namespace onebit_kv_decode {

using onebit_kv::from_f32;
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
kv_attention_decode(const T* __restrict__ q, T* __restrict__ out,
                    const P* __restrict__ kp, const float* __restrict__ ks,
                    const P* __restrict__ vp, const float* __restrict__ vs,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ starts, int nkv, int T_len,
                    float hd_scale) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  constexpr int LPR = HD / kEpl;         // lanes per row: 16 or 8
  constexpr int NGRP = kThreads / LPR;   // rows in flight per pass
  constexpr int RPG = kTile / NGRP;      // rows of a tile per lane group
  static_assert(HD % (8 * kEpl) == 0 && LPR <= 32, "unsupported head_dim");
  static_assert(RPG % kBatch == 0, "row batches");

  __shared__ float s_s[G][kTile];              // scores of the tile
  __shared__ float p_s[G][kTile];              // P (* v scale) rounded to T
  __shared__ float vs_s[kTile];                // V scales of the tile
  __shared__ float red[NGRP][G][HD];           // partial accumulators
  __shared__ float m_s[G], l_s[G], alpha_s[G];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x, b = blockIdx.y;
  const int grp = tid / LPR, li = tid % LPR, d0 = li * kEpl;
  const size_t bn = (size_t)b * nkv + n;
  const size_t stride = (size_t)nkv * HD;   // elements between positions
  const P* k_bn = kp + (size_t)b * T_len * stride + (size_t)n * HD + d0;
  const P* v_bn = vp + (size_t)b * T_len * stride + (size_t)n * HD + d0;
  const float* ks_bn = QUANT ? ks + (size_t)b * T_len * nkv + n : nullptr;
  const float* vs_bn = QUANT ? vs + (size_t)b * T_len * nkv + n : nullptr;

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

  const int length = min(lengths[b], T_len);
  const int start = starts != nullptr ? max(starts[b], 0) : 0;
  float acc[G][kEpl];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kEpl; ++e) acc[g][e] = 0.f;

  for (int t0 = start; t0 < length; t0 += kTile) {
    // ---- 1. scores: q . k over the row's lanes (times the K scale), times
    // HD**-0.5; and the tile's V scales
#pragma unroll
    for (int r0 = 0; r0 < RPG; r0 += kBatch) {
      Row8<P> kr[kBatch];
      float ksc[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int t = t0 + grp + (r0 + j) * NGRP;
        kr[j].zero();
        ksc[j] = 1.f;
        if (t >= start && t < length) {
          kr[j].load(k_bn + (size_t)t * stride);
          if (QUANT) ksc[j] = ks_bn[(size_t)t * nkv];
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = grp + (r0 + j) * NGRP, t = t0 + r;
        float dot[G];
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) {
          const float kv = kr[j].get(e);
#pragma unroll
          for (int g = 0; g < G; ++g) dot[g] = fmaf(qr[g][e], kv, dot[g]);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
        if (li == 0) {
          const bool valid = t >= start && t < length;
#pragma unroll
          for (int g = 0; g < G; ++g)
            s_s[g][r] = valid ? dot[g] * ksc[j] * hd_scale : -INFINITY;
        }
      }
    }
    if (QUANT) {
      for (int col = tid; col < kTile; col += kThreads) {
        const int t = t0 + col;
        vs_s[col] = t >= start && t < length ? vs_bn[(size_t)t * nkv] : 0.f;
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
        const float p = expf(s_s[g][col] - m_new);  // 0 when masked
        sum += p;
        p_s[g][col] = round_to<T>(QUANT ? p * vs_s[col] : p);
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
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int t = t0 + grp + (r0 + j) * NGRP;
        vr[j].zero();
        if (t >= start && t < length) vr[j].load(v_bn + (size_t)t * stride);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = grp + (r0 + j) * NGRP;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) {
          const float vv = vr[j].get(e);
#pragma unroll
          for (int g = 0; g < G; ++g)
            acc[g][e] = fmaf(p_s[g][r], vv, acc[g][e]);
        }
      }
    }
    // no barrier here: the next tile writes s_s and vs_s, which this pass
    // does not read, and p_s and alpha_s only after a barrier every thread
    // reaches once this pass is done
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
    out[bn * G * HD + i] = from_f32<T>(s / fmaxf(l_s[g], 1e-30f));
  }
}

// Host side: pick the instance for (q dtype, pool kind, head_dim, group).
template <typename T, typename P>
struct Launch {
  template <int HD, int G>
  static int run(const void* q, void* out, const void* kp, const void* ks,
                 const void* vp, const void* vs, const void* lengths,
                 const void* starts, int B, int nkv, int T_len,
                 float hd_scale, cudaStream_t st) {
    kv_attention_decode<T, P, HD, G><<<dim3(nkv, B), kThreads, 0, st>>>(
        static_cast<const T*>(q), static_cast<T*>(out),
        static_cast<const P*>(kp), static_cast<const float*>(ks),
        static_cast<const P*>(vp), static_cast<const float*>(vs),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(starts), nkv, T_len, hd_scale);
    return (int)cudaGetLastError();
  }

  template <int HD>
  static int by_group(int g, const void* q, void* out, const void* kp,
                      const void* ks, const void* vp, const void* vs,
                      const void* lengths, const void* starts, int B, int nkv,
                      int T_len, float hd_scale, cudaStream_t st) {
#define ONEBIT_KVD_G(GV)                                                     \
  if (g == GV)                                                               \
    return run<HD, GV>(q, out, kp, ks, vp, vs, lengths, starts, B, nkv,     \
                       T_len, hd_scale, st);
    ONEBIT_KVD_G(1)
    ONEBIT_KVD_G(2)
    ONEBIT_KVD_G(4)
    ONEBIT_KVD_G(8)
#undef ONEBIT_KVD_G
    return (int)cudaErrorInvalidValue;
  }

  static int by_head_dim(int hd, int g, const void* q, void* out,
                         const void* kp, const void* ks, const void* vp,
                         const void* vs, const void* lengths,
                         const void* starts, int B, int nkv, int T_len,
                         float hd_scale, cudaStream_t st) {
    if (hd == 64)
      return by_group<64>(g, q, out, kp, ks, vp, vs, lengths, starts, B, nkv,
                          T_len, hd_scale, st);
    if (hd == 128)
      return by_group<128>(g, q, out, kp, ks, vp, vs, lengths, starts, B,
                           nkv, T_len, hd_scale, st);
    return (int)cudaErrorInvalidValue;
  }
};

template <typename T>
int by_pool(int quant, int hd, int g, const void* q, void* out,
            const void* kp, const void* ks, const void* vp, const void* vs,
            const void* lengths, const void* starts, int B, int nkv,
            int T_len, float hd_scale, cudaStream_t st) {
  if (quant)
    return Launch<T, int8_t>::by_head_dim(hd, g, q, out, kp, ks, vp, vs,
                                          lengths, starts, B, nkv, T_len,
                                          hd_scale, st);
  return Launch<T, T>::by_head_dim(hd, g, q, out, kp, ks, vp, vs, lengths,
                                   starts, B, nkv, T_len, hd_scale, st);
}

}  // namespace onebit_kv_decode

// q/out [B, nkv * g, hd] (dtype 0 = float32, 1 = bfloat16); the layer's
// pools k/v [B, T, nkv, hd] in q's dtype (quant = 0) or int8 with scales
// k_s/v_s [B, T, nkv] f32 (quant = 1; null otherwise); lengths and starts
// (or null) [B] int32 on the device. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int onebit_kv_attention_decode(
    const void* q, void* out, const void* k, const void* k_s, const void* v,
    const void* v_s, const void* lengths, const void* starts, int B, int nkv,
    int g, int hd, int T, int dtype, int quant, float hd_scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return onebit_kv_decode::by_pool<__nv_bfloat16>(
        quant, hd, g, q, out, k, k_s, v, v_s, lengths, starts, B, nkv, T,
        hd_scale, st);
  return onebit_kv_decode::by_pool<float>(quant, hd, g, q, out, k, k_s, v,
                                          v_s, lengths, starts, B, nkv, T,
                                          hd_scale, st);
}
