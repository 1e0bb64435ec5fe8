// Fused decode attention over the quantized KT pools, with an optional
// append of this step's K/V: the body of kernels B5-B8 of the port; and the
// dtype helpers and warp reductions that B9 (kv_attention_decode.cu) and
// B10 (paged_attention.cu) share with it, and their shared-memory
// element loads (load_elems).
//
// Replaces, in onebit_tpu/kernels/kv_attention.py,
//   _kernel_append_kt  / _kernel_kt   (int8 pools, kv_attention_int8.cu)
//   _kernel_append_kt4 / _kernel_kt4  (int4 pools, kv_attention_int4.cu).
//
// Layouts of one layer (the wrapper passes the layer slice's base pointers;
// every offset below is 64-bit):
//   K  [B, nkv, HD, TB] int8, T contiguous   TB = T (int8) or T/2 (int4)
//   Ks [B, nkv, T] f32                       scale of (position, head)
//   V  [B, TB, nkv, HD] int8, HD contiguous
//   Vs [B, T, nkv] f32
// int4 pools are half-plane packed: byte column c holds position c in its
// low nibble and position T/2 + c in its high nibble, sign-extended.
// Scales are stored pre-divided (int8 absmax/127, int4 absmax/7), so a value
// is its integer times its scale.
//
// Bound on an H100: HBM bytes. At decode every pool byte up to a row's length
// is read once and used for a handful of flops (4 flops per K and V element
// per query head), far below the 295 flops per byte where bf16 compute would
// bound it. The design reads each byte exactly once, coalesced, and keeps
// every intermediate (scores, P, the accumulator) on chip:
//   * one CTA per (kv head n, row b), which serves the G = nh/nkv query heads
//     of that kv head, so each pool byte is read by one CTA only;
//   * the CTA walks its row in tiles of 128 byte columns, only over the
//     columns the row needs (positions < length), so a short row reads
//     little: masked positions give exact zeros in the reference, and
//     skipping them is the same function;
//   * K tile: each warp takes a quarter of HD; lane l loads 4 consecutive
//     bytes of a K row (a warp reads a 128-byte row segment in one
//     transaction) and keeps 4 (int8) or 8 (int4) positions x G partial
//     dot products in registers;
//   * online softmax in fp32, one warp per query head; P * v_scale is
//     rounded to q's dtype before the PV sum, as kv_attention.py:174 does;
//   * V tile: HD/4 lanes cover one V row (4 bytes each), so a warp reads one
//     (HD = 128) or two (HD = 64) whole rows per load, and each thread
//     keeps 8 row loads in flight before their FMAs (one load at a time
//     left a 128-row tile waiting on 32 memory latencies in a row: 0.28 ms
//     for B5 at llama2-7b on an H100 80GB HBM3 at 700 W, 13x its bound,
//     PERF.md); each thread keeps
//     G x 4 fp32 accumulators, rescaled by the softmax correction per tile;
//   * the row groups' partial accumulators meet in shared memory at the end;
//     out = acc / max(l, 1e-30) in q's dtype.
// Simple first: one serial walk over T per CTA (256 CTAs at 7B batch 8),
// no split-T, no cp.async/TMA pipelining, no tensor cores.
//
// Append (APPEND = true): the CTA that owns (b, n) first writes this step's
// K column, V row and both scales at pos[b] (int4: a read-modify-write of
// the live nibble that keeps the partner nibble bit for bit), then
// __syncthreads(), then attends over the pools as written. No other CTA
// touches head n of row b, so the writes cannot race. The pools are written
// even for an inactive row (length 0), as the reference does. Unlike the
// Pallas kernel, which recomputes the fresh column from k_new/v_new and adds
// its PV term in fp32, the fresh column is read back from the pool like any
// other, so its P * v_scale is rounded to q's dtype too (no difference for
// fp32 q).
//
// A row with no position in [start, length) gets ctx = 0 (finite; the
// Pallas kernel gives a uniform average there; neither is ever read).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace onebit_kv {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // byte columns per tile: 32 lanes x 4 bytes
constexpr int kVBatch = 8;  // V row loads a thread keeps in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A K/V element as a float.
__device__ __forceinline__ float elem_f32(float v) { return v; }
__device__ __forceinline__ float elem_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float elem_f32(int8_t v) { return (float)v; }

template <int BYTES>
struct Vec;
template <>
struct Vec<2> { using type = unsigned short; };
template <>
struct Vec<4> { using type = uint32_t; };
template <>
struct Vec<8> { using type = uint2; };
template <>
struct Vec<16> { using type = uint4; };

// N consecutive elements of a K/V row in shared memory (16-byte loads, or
// one load of N elements below 16 bytes) as floats: the warp tiles of B9
// (kv_attention_decode.cu) and B10 (paged_attention.cu).
template <typename P, int N>
__device__ __forceinline__ void load_elems(const P* p, float (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(P);
  constexpr int kLoad = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kLoad / (int)sizeof(P);
  using V = typename Vec<kLoad>::type;
#pragma unroll
  for (int i = 0; i < kBytes / kLoad; ++i) {
    const V raw = *reinterpret_cast<const V*>(p + i * kPer);
    const P* e = reinterpret_cast<const P*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[i * kPer + j] = elem_f32(e[j]);
  }
}

// Byte i of w as a sign-extended int.
__device__ __forceinline__ int byte_of(uint32_t w, int i) {
  return (int)(int8_t)(uint8_t)(w >> (8 * i));
}
// Low nibble of a sign-extended byte: (b << 28) >> 28.
__device__ __forceinline__ int low_nibble(int b) {
  return (int)((uint32_t)b << 28) >> 28;
}
// High nibble: the arithmetic shift of the sign-extended byte.
__device__ __forceinline__ int high_nibble(int b) { return b >> 4; }

// Four bytes src[0..3] as one word; bytes at or past `avail` read as 0.
// The word load needs 4-byte alignment, which holds when the row length in
// bytes is a multiple of 4 (the wrapper checks the base pointers).
__device__ __forceinline__ uint32_t load4(const int8_t* src, int avail,
                                          bool aligned) {
  if (aligned && avail >= 4) return *reinterpret_cast<const uint32_t*>(src);
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < avail) w |= (uint32_t)(uint8_t)src[i] << (8 * i);
  return w;
}

// The byte with nibble `hi` replaced by the low 4 bits of v, the other
// nibble kept.
__device__ __forceinline__ int8_t merge_nibble(int8_t old, int8_t v,
                                               bool hi) {
  const uint32_t o = (uint8_t)old, n = (uint32_t)v & 0xFu;
  const uint32_t m = hi ? (o & 0x0Fu) | (n << 4) : (o & 0xF0u) | n;
  return (int8_t)(uint8_t)m;
}

template <typename T, int HD, int G, bool APPEND, bool INT4>
__global__ void __launch_bounds__(kThreads)
kv_attention(const T* __restrict__ q, T* __restrict__ out, int8_t* kp,
             float* ks, int8_t* vp, float* vs,
             const int32_t* __restrict__ lengths,
             const int32_t* __restrict__ starts,
             const int32_t* __restrict__ pos,
             const int8_t* __restrict__ k_new,
             const float* __restrict__ k_snew,
             const int8_t* __restrict__ v_new,
             const float* __restrict__ v_snew, int nkv, int T_len,
             float hd_scale) {
  // pool pointers carry no __restrict__/const: with APPEND the CTA reads
  // back bytes it wrote, which the non-coherent read-only path may miss
  constexpr int NCOL = INT4 ? 2 * kTile : kTile;  // positions per tile
  constexpr int NV = INT4 ? 8 : 4;                // positions per lane
  constexpr int DW = HD / kWarps;                 // K rows per warp
  constexpr int LPR = HD / 4;                     // lanes per V row
  constexpr int NRG = kThreads / LPR;             // V rows in flight
  static_assert(HD % 16 == 0 && LPR <= kThreads, "unsupported head_dim");
  static_assert(NRG * G * HD <= kWarps * G * NCOL, "reduction buffer");
  static_assert((kTile / NRG) % kVBatch == 0, "V batches");

  __shared__ float q_s[G][HD];
  __shared__ float s_part[kWarps][G][NCOL];  // partial dots, then scores
  __shared__ float p_s[G][NCOL];             // P * v_scale, rounded to T
  __shared__ float vs_s[NCOL];
  __shared__ float m_s[G], l_s[G], alpha_s[G];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x, b = blockIdx.y;
  const int TB = INT4 ? T_len / 2 : T_len;  // bytes per pool row
  const size_t bn = (size_t)b * nkv + n;
  const size_t v_row = (size_t)nkv * HD;    // bytes between V rows
  int8_t* k_bn = kp + bn * HD * TB;          // [HD, TB]
  float* ks_bn = ks + bn * T_len;            // [T]
  int8_t* v_bn = vp + (size_t)b * TB * v_row + (size_t)n * HD;
  float* vs_bn = vs + (size_t)b * T_len * nkv + n;

  if (APPEND) {
    const int p = pos[b];
    if (p >= 0 && p < T_len) {
      const int8_t* kn = k_new + bn * HD;
      const int8_t* vn = v_new + bn * HD;
      const bool hi = INT4 && p >= TB;
      const int c = hi ? p - TB : p;
      for (int d = tid; d < HD; d += kThreads) {
        int8_t* kb = k_bn + (size_t)d * TB + c;
        int8_t* vb = v_bn + (size_t)c * v_row + d;
        *kb = INT4 ? merge_nibble(*kb, kn[d], hi) : kn[d];
        *vb = INT4 ? merge_nibble(*vb, vn[d], hi) : vn[d];
      }
      if (tid == 0) {
        ks_bn[p] = k_snew[bn];
        vs_bn[(size_t)p * nkv] = v_snew[bn];
      }
    }
  }

  for (int i = tid; i < G * HD; i += kThreads)
    q_s[i / HD][i % HD] = to_f32(q[(bn * G) * HD + i]);
  if (tid < G) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int length = min(lengths[b], T_len);
  const int start = starts != nullptr ? max(starts[b], 0) : 0;
  // byte columns the row needs: [c_lo, c_end)
  const int c_end = min(length, TB);
  const int c_lo = INT4 && length > TB ? 0 : start;
  const bool aligned = (TB & 3) == 0;

  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  const int d4 = tid % LPR, rg = tid / LPR;

  for (int c0 = (c_lo / kTile) * kTile; c0 < c_end; c0 += kTile) {
    // ---- 1. partial dots q . K over this warp's quarter of HD
    {
      float sacc[G][NV];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < NV; ++j) sacc[g][j] = 0.f;
      const int cb = c0 + 4 * lane;
      const int avail = c_end - cb;  // bytes of this lane the row needs
      if (avail > 0) {
        uint32_t w[DW];
#pragma unroll
        for (int dd = 0; dd < DW; ++dd)
          w[dd] = load4(k_bn + (size_t)(warp * DW + dd) * TB + cb,
                        min(avail, 4), aligned);
#pragma unroll
        for (int dd = 0; dd < DW; ++dd) {
          float kv[NV];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int bt = byte_of(w[dd], i);
            if (INT4) {
              kv[i] = (float)low_nibble(bt);
              kv[4 + i] = (float)high_nibble(bt);
            } else {
              kv[i] = (float)bt;
            }
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float qv = q_s[g][warp * DW + dd];
#pragma unroll
            for (int j = 0; j < NV; ++j) sacc[g][j] = fmaf(qv, kv[j],
                                                           sacc[g][j]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s_part[warp][g][4 * lane + i] = sacc[g][i];
          if (INT4) s_part[warp][g][kTile + 4 * lane + i] = sacc[g][4 + i];
        }
    }
    __syncthreads();

    // ---- 2. scores (dot * k_scale * hd^-0.5, masked) and v scales
    for (int col = tid; col < NCOL; col += kThreads) {
      const int c = c0 + (col % kTile);
      const int t = col < kTile ? c : TB + c;
      const bool valid = c < TB && t >= start && t < length;
      const float ksc = valid ? ks_bn[t] : 0.f;
      vs_s[col] = valid ? vs_bn[(size_t)t * nkv] : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) dot += s_part[w][g][col];
        s_part[0][g][col] = valid ? dot * ksc * hd_scale : -INFINITY;
      }
    }
    __syncthreads();

    // ---- 3. online softmax, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = -1e30f;
      for (int col = lane; col < NCOL; col += 32)
        mx = fmaxf(mx, s_part[0][g][col]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int col = lane; col < NCOL; col += 32) {
        const float p = expf(s_part[0][g][col] - m_new);  // 0 when masked
        sum += p;
        p_s[g][col] = to_f32(from_f32<T>(p * vs_s[col]));
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

    // ---- 4. acc = acc * alpha + (P * v_scale) . V
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = alpha_s[g];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= a;
    }
    // V rows in batches of kVBatch: every load of a batch is in flight
    // before its FMAs. A row past the row's end reads as 0, and its P is 0.
    const int rows = min(kTile, c_end - c0);
#pragma unroll
    for (int it0 = 0; it0 < kTile / NRG; it0 += kVBatch) {
      uint32_t vw[kVBatch];
#pragma unroll
      for (int j = 0; j < kVBatch; ++j) {
        const int r = rg + (it0 + j) * NRG;
        vw[j] = r < rows ? *reinterpret_cast<const uint32_t*>(
                               v_bn + (size_t)(c0 + r) * v_row + 4 * d4)
                         : 0u;
      }
#pragma unroll
      for (int j = 0; j < kVBatch; ++j) {
        const int r = rg + (it0 + j) * NRG;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pl = p_s[g][r];
          const float ph = INT4 ? p_s[g][kTile + r] : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int bt = byte_of(vw[j], e);
            if (INT4) {
              acc[g][e] = fmaf(pl, (float)low_nibble(bt), acc[g][e]);
              acc[g][e] = fmaf(ph, (float)high_nibble(bt), acc[g][e]);
            } else {
              acc[g][e] = fmaf(pl, (float)bt, acc[g][e]);
            }
          }
        }
      }
    }
    // no barrier here: the next tile's first writes (s_part) do not touch
    // p_s/alpha_s, and its later writes follow two barriers
  }

  // ---- the row groups' partial accumulators meet; out = acc / l
  __syncthreads();
  float* red = &s_part[0][0][0];  // [NRG][G][HD]
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[((size_t)rg * G + g) * HD + 4 * d4 + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < NRG; ++r) s += red[((size_t)r * G + g) * HD + d];
    out[(bn * G) * HD + i] = from_f32<T>(s / fmaxf(l_s[g], 1e-30f));
  }
}

// Host side: pick the instance for (dtype, head_dim, group size, append).
template <bool INT4>
struct Launch {
  template <typename T, int HD, int G, bool APPEND>
  static int run(const void* q, void* out, void* kp, void* ks, void* vp,
                 void* vs, const void* lengths, const void* starts,
                 const void* pos, const void* k_new, const void* k_snew,
                 const void* v_new, const void* v_snew, int B, int nkv,
                 int T_len, float hd_scale, cudaStream_t stream) {
    kv_attention<T, HD, G, APPEND, INT4><<<dim3(nkv, B), kThreads, 0,
                                           stream>>>(
        static_cast<const T*>(q), static_cast<T*>(out),
        static_cast<int8_t*>(kp), static_cast<float*>(ks),
        static_cast<int8_t*>(vp), static_cast<float*>(vs),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(starts), static_cast<const int32_t*>(pos),
        static_cast<const int8_t*>(k_new), static_cast<const float*>(k_snew),
        static_cast<const int8_t*>(v_new), static_cast<const float*>(v_snew),
        nkv, T_len, hd_scale);
    return (int)cudaGetLastError();
  }

  template <typename T, int HD, int G>
  static int by_append(int append, const void* q, void* out, void* kp,
                       void* ks, void* vp, void* vs, const void* lengths,
                       const void* starts, const void* pos, const void* k_new,
                       const void* k_snew, const void* v_new,
                       const void* v_snew, int B, int nkv, int T_len,
                       float hd_scale, cudaStream_t st) {
    if (append)
      return run<T, HD, G, true>(q, out, kp, ks, vp, vs, lengths, starts, pos,
                                 k_new, k_snew, v_new, v_snew, B, nkv, T_len,
                                 hd_scale, st);
    return run<T, HD, G, false>(q, out, kp, ks, vp, vs, lengths, starts, pos,
                                k_new, k_snew, v_new, v_snew, B, nkv, T_len,
                                hd_scale, st);
  }

  template <typename T, int HD>
  static int by_group(int g, int append, const void* q, void* out, void* kp,
                      void* ks, void* vp, void* vs, const void* lengths,
                      const void* starts, const void* pos, const void* k_new,
                      const void* k_snew, const void* v_new,
                      const void* v_snew, int B, int nkv, int T_len,
                      float hd_scale, cudaStream_t st) {
#define ONEBIT_KV_G(GV)                                                     \
  if (g == GV)                                                              \
    return by_append<T, HD, GV>(append, q, out, kp, ks, vp, vs, lengths,    \
                                starts, pos, k_new, k_snew, v_new, v_snew,  \
                                B, nkv, T_len, hd_scale, st);
    ONEBIT_KV_G(1)
    ONEBIT_KV_G(2)
    ONEBIT_KV_G(4)
    ONEBIT_KV_G(8)
#undef ONEBIT_KV_G
    return (int)cudaErrorInvalidValue;
  }

  template <typename T>
  static int by_head_dim(int hd, int g, int append, const void* q, void* out,
                         void* kp, void* ks, void* vp, void* vs,
                         const void* lengths, const void* starts,
                         const void* pos, const void* k_new,
                         const void* k_snew, const void* v_new,
                         const void* v_snew, int B, int nkv, int T_len,
                         float hd_scale, cudaStream_t st) {
    if (hd == 64)
      return by_group<T, 64>(g, append, q, out, kp, ks, vp, vs, lengths,
                             starts, pos, k_new, k_snew, v_new, v_snew, B,
                             nkv, T_len, hd_scale, st);
    if (hd == 128)
      return by_group<T, 128>(g, append, q, out, kp, ks, vp, vs, lengths,
                              starts, pos, k_new, k_snew, v_new, v_snew, B,
                              nkv, T_len, hd_scale, st);
    return (int)cudaErrorInvalidValue;
  }

  // dtype: 0 = float32, 1 = bfloat16 (q and out).
  static int dispatch(int dtype, int hd, int g, int append, const void* q,
                      void* out, void* kp, void* ks, void* vp, void* vs,
                      const void* lengths, const void* starts,
                      const void* pos, const void* k_new, const void* k_snew,
                      const void* v_new, const void* v_snew, int B, int nkv,
                      int T_len, float hd_scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
      return by_head_dim<__nv_bfloat16>(hd, g, append, q, out, kp, ks, vp, vs,
                                        lengths, starts, pos, k_new, k_snew,
                                        v_new, v_snew, B, nkv, T_len,
                                        hd_scale, st);
    return by_head_dim<float>(hd, g, append, q, out, kp, ks, vp, vs, lengths,
                              starts, pos, k_new, k_snew, v_new, v_snew, B,
                              nkv, T_len, hd_scale, st);
  }
};

}  // namespace onebit_kv
