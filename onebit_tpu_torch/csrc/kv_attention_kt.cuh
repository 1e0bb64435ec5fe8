// Fused decode attention over the quantized KT pools, with an optional
// append of this step's K/V: the body of kernels B5-B8 of the port, one
// template instanced by kv_attention_int8.cu (B5, B6) and
// kv_attention_int4.cu (B7, B8), each with its own chunk of byte columns.
//
// Replaces, in onebit_tpu/kernels/kv_attention.py,
//   _kernel_append_kt  / _kernel_kt   (int8 pools)
//   _kernel_append_kt4 / _kernel_kt4  (int4 pools).
//
// Layouts of one layer (the wrapper passes the layer slice's base pointers;
// every offset below is 64-bit: a llama2-7b pool at batch 16 holds 2**32
// elements):
//   K  [B, nkv, HD, TB] int8, T contiguous   TB = T (int8) or T/2 (int4)
//   Ks [B, nkv, T] f32                       scale of (position, head)
//   V  [B, TB, nkv, HD] int8, HD contiguous
//   Vs [B, T, nkv] f32
// int4 pools are half-plane packed: byte column c holds position c in its
// low nibble and position T/2 + c in its high nibble, sign-extended.
// Scales are stored pre-divided (int8 absmax/127, int4 absmax/7), so a value
// is its integer times its scale.
//
// The function: row b attends positions [start, length); scores are fp32
// dots of q with K times the position's K scale times HD**-0.5; the softmax
// is fp32; P = exp(s - m) times the position's V scale is rounded to q's
// dtype before the PV sum, which accumulates in fp32; out = acc / max(l,
// 1e-30) in q's dtype, with l the sum of the unrounded P. A row with no
// position in [start, length) gets out = 0 (finite; the Pallas kernel gives
// a uniform average there; neither is ever read).
//
// Bound on an H100: HBM bytes. Every K and V byte of a row's columns (and
// the scales of its positions) is read once for a few flops per element and
// query head, far below the 295 flops per byte where bf16 compute would
// bound it. The design is B9's (kv_attention_decode.cu), over byte columns:
//   * split-T: each row's byte columns are cut into chunks of CHUNK columns
//     counted from column 0 (256 for both: 256 positions int8, 512 int4);
//     one CTA runs per (chunk, kv head, row) and serves the G
//     query heads of that kv head, so each pool byte is read by one CTA
//     only. The grid is (ceil(TB / CHUNK), nkv, B); a CTA whose columns hold
//     no position of [start, length) exits. An int4 CTA scores both nibbles
//     of every byte it loads: chunks of positions would read each byte
//     twice for a row longer than T/2. Chunks count absolute columns, not
//     from `start` as B9's do: a chunk's K rows then start on 16 bytes for
//     the 16-byte copies, and an int4 byte column serves two positions T/2
//     apart, so no chunking from `start` covers both planes;
//   * inside a CTA, each of the 4 warps takes every 4th tile of TILE = 16
//     byte columns of the chunk (16 positions int8, 32 int4) and runs its
//     own online softmax over them. A warp skips a tile with no position to
//     attend (a start inside the chunk, the gap between int4's planes). Its
//     tiles come through its own ring of two shared-memory stages filled by
//     cp.async: K as HD rows of the tile's 16 bytes, V as its 16 rows of HD
//     bytes, the tile's K and V scales. The next tile is in flight while
//     the current one is scored; no block barrier in the loop (a warp waits
//     on cp.async.wait_group and __syncwarp only). K rows of 16 bytes need
//     no pad: lane 4 dg + cw reads word cw of rows dg + 8 i, and a warp's 32
//     reads land on 32 banks;
//   * scores: each lane dots an eighth of HD (rows dg + 8 i) with q for 4
//     byte columns (int4: their 8 positions), three shuffles join the 8
//     row groups; k_scale multiplies the dot, not each element.
//     Bytes and nibbles become floats by their bits under 2**23's exponent
//     (prmt, one fadd), exactly, on the shared-memory read;
//   * P (x V scale, rounded to q's dtype) goes to a per-warp buffer, and
//     each lane accumulates HD / 32 columns of P . V for the G heads;
//   * the 4 warps' (m, l, acc) meet in shared memory in warp order; a row
//     whose positions lie in one chunk writes its output there. Otherwise
//     the chunk's fp32 partial goes to scratch the wrapper allocates, and
//     the last of the row's chunks to arrive (an atomic ticket on a
//     per-(row, head) counter the wrapper keeps per device, reset by that
//     CTA) merges them in chunk order, in the same launch. No float
//     atomics: the same call gives the same bits. The counters are shared
//     by every launch on a device: two streams must not run this kernel at
//     once.
// G query heads run on the CUDA cores; the tensor cores are not used.
// Measured alternatives (scripts/torch_kt_probe.py; PERF.md): tiles of 32
// columns, rings of 3 or 4 stages, CTAs of 8 warps, chunks of 128 or 512
// columns and an L2 prefetch hint were no faster at llama2-7b; the copies
// alone take most of the time.
//
// Append (APPEND = true): the CTA whose chunk holds pos[b]'s byte column
// writes this step's K column, V row and both scales there (int4: the
// live nibble, the partner nibble kept bit for bit), even when the row
// attends nothing, as the reference does. No other CTA reads that byte
// column of (row, head), so the writes cannot race, and every other CTA
// starts at once. The owner issues its copies first, with this step's K/V
// waiting in shared memory; the warp whose tile holds the column merges
// them into its stage once the copy lands (for int4, into the byte as
// copied) and writes the merged bytes to the pools from there, so the
// fresh column is attended as written and costs no read of the pool. A
// column in no attended tile is written at once (int4: a read-modify-write).
// (The alternative, the append in a prologue before the chunks, would make
// every CTA of the row wait on it.) Unlike the Pallas kernel, which adds the
// fresh column's PV term in fp32, its P * v_scale is rounded to q's dtype
// like every other column's (no difference for fp32 q).
#pragma once

#include "kv_attention_common.cuh"
#include "wgmma_common.cuh"

namespace onebit_kt {

using onebit_kv::from_f32;
using onebit_kv::merge_nibble;
using onebit_kv::round_to;
using onebit_kv::to_f32;
using onebit_sm90::cp_async16;
using onebit_sm90::cp_async4;
using onebit_sm90::cp_async8;
using onebit_sm90::cp_async_commit;
using onebit_sm90::cp_async_wait;
using onebit_sm90::smem_u32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;   // a warp's ring of tiles

// One stage of a warp's ring, for tiles of TILE byte columns: K [HD][TILE]
// bytes, V [TILE][HD] bytes, then the K and V scales of the tile's
// positions (int4: the low plane's TILE, then the high plane's).
template <int HD, bool INT4, int TILE>
struct Stage {
  static constexpr int kNP = INT4 ? 2 * TILE : TILE;  // positions
  static constexpr int kK = 0;
  static constexpr int kV = HD * TILE;
  static constexpr int kKs = kV + TILE * HD;
  static constexpr int kVs = kKs + kNP * 4;
  static constexpr int kBytes = kVs + kNP * 4;
  static_assert(kBytes % 16 == 0, "16-byte copies");
};

// A CTA's shared memory: each warp's ring and its P buffer [G][kNP], q in
// fp32 [G][HD], then the append's K and V bytes [2][HD] and scales [2].
// After the loop the warps' (m, l) [warp][G] and acc [warp][G][HD] reuse
// the rings.
template <int HD, int G, bool INT4, int TILE>
struct Smem {
  using S = Stage<HD, INT4, TILE>;
  static constexpr int kP = kStages * S::kBytes;
  static constexpr int kWarpBytes = kP + G * S::kNP * 4;
  static constexpr int kQ = kWarps * kWarpBytes;
  static constexpr int kFresh = kQ + G * HD * 4;
  static constexpr int kBytes = kFresh + 2 * HD + 16;
  static_assert(kWarps * G * (HD + 2) * 4 <= kQ, "the merge fits");
};

// The 4 signed bytes of w as exact floats: each byte, its sign bit flipped,
// under the exponent of 2**23, less 2**23 + 128.
__device__ __forceinline__ void bytes_f32(uint32_t w, float (&f)[4]) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | i)) -
           8388736.f;
}

// The low and high signed nibbles of w's 4 bytes as exact floats, the same
// way: each nibble plus 8 under 2**23's exponent, less 2**23 + 8.
__device__ __forceinline__ void nibbles_f32(uint32_t w, float (&lo)[4],
                                            float (&hi)[4]) {
  const uint32_t x = w ^ 0x88888888u;
  const uint32_t xl = x & 0x0F0F0F0Fu, xh = (x >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = __uint_as_float(__byte_perm(xl, 0x4B000000u, 0x7440 | i)) -
            8388616.f;
    hi[i] = __uint_as_float(__byte_perm(xh, 0x4B000000u, 0x7440 | i)) -
            8388616.f;
  }
}

// The index of m's (k + 1)-th set bit.
__device__ __forceinline__ int nth_bit(uint32_t m, int k) {
  for (int i = 0; i < k; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

// The K rows, V rows and scales of one warp tile, byte columns [t0, t0 +
// TILE) of (row, head), into the stage at shared address st; columns past
// TB arrive as zeros. K's rows go in pieces of kvec bytes (16, 8 or 4: TB and
// the base are multiples), or, for rows not on 4 bytes (an odd T), by byte
// loads stored at once.
template <int HD, bool INT4, int TILE>
__device__ __forceinline__ void copy_tile(uint32_t st, unsigned char* st_p,
                                          const int8_t* k_bn,
                                          const float* ks_bn,
                                          const int8_t* v_bn,
                                          const float* vs_bn, size_t v_row,
                                          int nkv, int TB, int kvec, int t0,
                                          int lane) {
  using S = Stage<HD, INT4, TILE>;
  constexpr int NP = S::kNP;
  if (kvec >= 4) {
    const int per = TILE / kvec;
    for (int e = lane; e < HD * per; e += 32) {
      const int d = e / per, col = t0 + (e % per) * kvec;
      const bool ok = col < TB;
      const int8_t* src = k_bn + (size_t)d * TB + (ok ? col : 0);
      const uint32_t dst = st + S::kK + d * TILE + (col - t0);
      if (kvec == 16)
        cp_async16(dst, src, ok);
      else if (kvec == 8)
        cp_async8(dst, src, ok);
      else
        cp_async4(dst, src, ok);
    }
  } else {
    for (int e = lane; e < HD * TILE; e += 32) {
      const int d = e / TILE, col = t0 + e % TILE;
      st_p[S::kK + e] = col < TB ? k_bn[(size_t)d * TB + col] : 0;
    }
  }
  constexpr int kVChunks = HD / 16;
  for (int e = lane; e < TILE * kVChunks; e += 32) {
    const int j = e / kVChunks, ch = e % kVChunks;
    const bool ok = t0 + j < TB;
    cp_async16(st + S::kV + j * HD + 16 * ch,
               v_bn + (size_t)(ok ? t0 + j : 0) * v_row + 16 * ch, ok);
  }
  for (int e = lane; e < 2 * NP; e += 32) {
    const bool is_v = e >= NP;
    const int s = is_v ? e - NP : e;
    const int col = t0 + s % TILE;
    const bool ok = col < TB;
    const size_t t = ok ? (size_t)(s / TILE) * TB + col : 0;
    cp_async4(st + (is_v ? S::kVs : S::kKs) + 4 * s,
              is_v ? vs_bn + t * nkv : ks_bn + t, ok);
  }
}

// One warp tile of the online softmax, from the stage st_p (byte columns
// [t0, t0 + TILE)): lane cw + (TILE / 4) dg dots q with the 4 byte columns
// of word cw over rows dg + groups i (int4: their 8 positions, low plane
// then high), the row groups joined by shuffles; scores x K scale x
// HD**-0.5, masked to [start, length); the tile's max and sum over the
// TILE / 4 lanes cw that hold its columns; P x V scale rounded to T into
// the warp's buffer pr_s [G][kNP]; then acc (this lane's HD / 32 columns)
// rescaled and += P . V. Rows of TILE bytes need no pad: a warp's 32 word
// reads of K land on 32 banks.
template <typename T, int HD, int G, bool INT4, int TILE>
__device__ __forceinline__ void attend_tile(
    const unsigned char* st_p, const float* q_s, float* pr_s, int t0, int TB,
    int start, int length, float hd_scale, int lane, float (&m)[G],
    float (&l)[G], float (&acc)[G][HD / 32]) {
  using S = Stage<HD, INT4, TILE>;
  constexpr int NP = S::kNP;
  constexpr int NV = INT4 ? 8 : 4;  // positions a lane scores
  constexpr int kCols = HD / 32;
  constexpr int kCW = TILE / 4;          // lanes across a K row's words
  constexpr int kGroups = 32 / kCW;      // row groups
  static_assert(kCW * kGroups == 32 && HD % kGroups == 0, "lane tiling");
  const int cw = lane % kCW, dg = lane / kCW;
  const float* ks_s = reinterpret_cast<const float*>(st_p + S::kKs);
  const float* vs_s = reinterpret_cast<const float*>(st_p + S::kVs);

  // ---- dots
  float dot[G][NV];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < NV; ++j) dot[g][j] = 0.f;
  const unsigned char* kt = st_p + S::kK + 4 * cw;
#pragma unroll
  for (int i = 0; i < HD / kGroups; ++i) {
    const int d = dg + kGroups * i;
    const uint32_t w = *reinterpret_cast<const uint32_t*>(kt + d * TILE);
    float kv[NV];
    if (INT4) {
      float lo[4], hi[4];
      nibbles_f32(w, lo, hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = lo[j];
        kv[4 + j] = hi[j];
      }
    } else {
      float by[4];
      bytes_f32(w, by);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = by[j];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float qv = q_s[g * HD + d];
#pragma unroll
      for (int j = 0; j < NV; ++j) dot[g][j] = fmaf(qv, kv[j], dot[g][j]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int off = kCW; off < 32; off <<= 1)
        dot[g][j] += __shfl_xor_sync(0xffffffffu, dot[g][j], off);

  // ---- scores, online softmax, P x V scale rounded to T
  bool valid[NV];
  float ksc[NV], vsc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int plane = j / 4, col = t0 + 4 * cw + j % 4;
    const int t = plane * TB + col;
    const int slot = plane * TILE + 4 * cw + j % 4;
    valid[j] = col < TB && t >= start && t < length;
    ksc[j] = ks_s[slot];
    vsc[j] = valid[j] ? vs_s[slot] : 0.f;  // a masked scale may be stale
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const float s = valid[j] ? dot[g][j] * ksc[j] * hd_scale : -INFINITY;
      dot[g][j] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int off = 1; off < kCW; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[g], mx);
    const float alpha = expf(m[g] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const float p = expf(dot[g][j] - m_new);  // 0 when masked
      sum += p;
      dot[g][j] = round_to<T>(p * vsc[j]);
    }
#pragma unroll
    for (int off = 1; off < kCW; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[g] = l[g] * alpha + sum;
    m[g] = m_new;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[g][e] *= alpha;
  }
  if (dg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int plane = 0; plane < NV / 4; ++plane)
        *reinterpret_cast<float4*>(pr_s + g * NP + plane * TILE + 4 * cw) =
            make_float4(dot[g][4 * plane], dot[g][4 * plane + 1],
                        dot[g][4 * plane + 2], dot[g][4 * plane + 3]);
  }
  __syncwarp();

  // ---- acc += P . V, 4 rows at a time
  const unsigned char* vt = st_p + S::kV + lane * kCols;
#pragma unroll
  for (int j4 = 0; j4 < TILE; j4 += 4) {
    float vlo[4][kCols], vhi[4][kCols];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      using U = typename onebit_kv::Vec<kCols>::type;
      const uint32_t w = *reinterpret_cast<const U*>(vt + (j4 + r) * HD);
      float lo[4], hi[4];
      if (INT4)
        nibbles_f32(w, lo, hi);
      else
        bytes_f32(w, lo);
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        vlo[r][e] = lo[e];
        vhi[r][e] = INT4 ? hi[e] : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 pl = *reinterpret_cast<const float4*>(pr_s + g * NP + j4);
      const float4 ph = INT4 ? *reinterpret_cast<const float4*>(
                                   pr_s + g * NP + TILE + j4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      const float plv[4] = {pl.x, pl.y, pl.z, pl.w};
      const float phv[4] = {ph.x, ph.y, ph.z, ph.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          acc[g][e] = fmaf(plv[r], vlo[r][e], acc[g][e]);
          if (INT4) acc[g][e] = fmaf(phv[r], vhi[r][e], acc[g][e]);
        }
    }
  }
}

template <typename T, int HD, int G, bool APPEND, bool INT4, int CHUNK,
          int TILE>
__global__ void __launch_bounds__(kThreads)
kv_attention_kt(const T* __restrict__ q, T* __restrict__ out, int8_t* kp,
                float* ks, int8_t* vp, float* vs,
                const int32_t* __restrict__ lengths,
                const int32_t* __restrict__ starts,
                const int32_t* __restrict__ pos,
                const int8_t* __restrict__ k_new,
                const float* __restrict__ k_snew,
                const int8_t* __restrict__ v_new,
                const float* __restrict__ v_snew, float* __restrict__ part,
                int* __restrict__ counters, int nkv, int T_len, int kvec,
                float hd_scale) {
  // pool pointers carry no __restrict__/const: with APPEND the CTA writes
  // bytes its own copies read
  using S = Stage<HD, INT4, TILE>;
  using SM = Smem<HD, G, INT4, TILE>;
  constexpr int kTilesPerWarp = CHUNK / (kWarps * TILE);
  constexpr int kCols = HD / 32;                 // V columns a lane sums
  static_assert(kTilesPerWarp * kWarps * TILE == CHUNK, "chunk tiling");
  static_assert(kTilesPerWarp <= 32 && TILE % 16 == 0, "tiling");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int max_chunks = gridDim.x;
  const int TB = INT4 ? T_len / 2 : T_len;  // bytes per pool row
  const size_t bn = (size_t)b * nkv + n;
  const size_t v_row = (size_t)nkv * HD;    // bytes between V rows
  int8_t* k_bn = kp + bn * HD * TB;          // [HD, TB]
  float* ks_bn = ks + bn * T_len;            // [T]
  int8_t* v_bn = vp + (size_t)b * TB * v_row + (size_t)n * HD;
  float* vs_bn = vs + (size_t)b * T_len * nkv + n;
  T* o = out + bn * G * HD;
  const int c0 = c * CHUNK, c1 = min(c0 + CHUNK, TB);

  // ---- the fresh byte column, when this CTA's chunk holds it
  int pc = -1, p = 0;
  bool p_hi = false;  // int4: the fresh position is in the high plane
  if (APPEND) {
    p = pos[b];
    if (p >= 0 && p < T_len) {
      p_hi = INT4 && p >= TB;
      const int col = p_hi ? p - TB : p;
      if (col >= c0 && col < c1) pc = col;
    }
  }
  // the append at once: K column, V row and both scales (int4: a
  // read-modify-write of the live nibble), for a column no warp attends
  auto append = [&]() {
    const int8_t* kn = k_new + bn * HD;
    const int8_t* vn = v_new + bn * HD;
    for (int d = tid; d < HD; d += kThreads) {
      int8_t* kb = k_bn + (size_t)d * TB + pc;
      int8_t* vb = v_bn + (size_t)pc * v_row + d;
      *kb = INT4 ? merge_nibble(*kb, kn[d], p_hi) : kn[d];
      *vb = INT4 ? merge_nibble(*vb, vn[d], p_hi) : vn[d];
    }
    if (tid == 0) {
      ks_bn[p] = k_snew[bn];
      vs_bn[(size_t)p * nkv] = v_snew[bn];
    }
  };

  // ---- the row's columns: [a0, a1) holds positions a0.. (int8; int4's
  // low plane), [h0, h1) positions TB + h0.. (int4's high plane)
  const int length = min(lengths[b], T_len);
  const int start = starts != nullptr ? max(starts[b], 0) : 0;
  const int a0 = start, a1 = min(length, TB);
  const int h0 = INT4 ? max(start - TB, 0) : 0, h1 = INT4 ? length - TB : 0;
  auto live = [&](int x0, int x1) {
    return max(x0, a0) < min(x1, a1) || (INT4 && max(x0, h0) < min(x1, h1));
  };
  // the chunks holding live columns: [ca0, ca1) and [cb0, cb1)
  int ca0 = 0, ca1 = 0, cb0 = 0, cb1 = 0;
  if (a0 < a1) {
    ca0 = a0 / CHUNK;
    ca1 = (a1 - 1) / CHUNK + 1;
  }
  if (INT4 && h0 < h1) {
    cb0 = h0 / CHUNK;
    cb1 = (h1 - 1) / CHUNK + 1;
  }
  const int n_work = (ca1 - ca0) + (cb1 - cb0) -
                     max(0, min(ca1, cb1) - max(ca0, cb0));
  if (n_work == 0 || !live(c0, c1)) {
    if (APPEND && pc >= 0) append();
    if (n_work == 0 && c == 0)
      for (int i = tid; i < G * HD; i += kThreads) o[i] = from_f32<T>(0.f);
    return;
  }

  // ---- this warp's live tiles: local tile warp + 4 i for each set bit i;
  // the first kStages go in flight before anything else
  uint32_t mask = 0;
#pragma unroll
  for (int i = 0; i < kTilesPerWarp; ++i) {
    const int t0 = c0 + (warp + kWarps * i) * TILE;
    if (live(t0, t0 + TILE)) mask |= 1u << i;
  }
  const int nt = __popc(mask);
  auto tile_col = [&](int k) {
    return c0 + (warp + kWarps * nth_bit(mask, k)) * TILE;
  };
  unsigned char* ring_p = smem + warp * SM::kWarpBytes;
  const uint32_t ring = smem_u32(ring_p);
  // live tile k into stage k % kStages; every call commits one group
  auto issue = [&](int k) {
    if (k < nt)
      copy_tile<HD, INT4, TILE>(ring + (k % kStages) * S::kBytes,
                          ring_p + (k % kStages) * S::kBytes, k_bn, ks_bn,
                          v_bn, vs_bn, v_row, nkv, TB, kvec, tile_col(k),
                          lane);
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages; ++k) issue(k);
  // the fresh column: its warp writes it from its stage (below) when its
  // tile is attended; this step's K/V wait in shared memory meanwhile
  int8_t* fresh = reinterpret_cast<int8_t*>(smem + SM::kFresh);  // K, V
  float* fresh_s = reinterpret_cast<float*>(fresh + 2 * HD);     // scales
  const int pt0 = pc - (pc - c0) % TILE;  // that tile's first column
  if (APPEND && pc >= 0) {
    if (live(pt0, pt0 + TILE)) {
      for (int d = tid; d < HD; d += kThreads) {
        fresh[d] = k_new[bn * HD + d];
        fresh[HD + d] = v_new[bn * HD + d];
      }
      if (tid == 0) {
        fresh_s[0] = k_snew[bn];
        fresh_s[1] = v_snew[bn];
      }
    } else {
      append();
    }
  }
  float* q_s = reinterpret_cast<float*>(smem + SM::kQ);
  for (int i = tid; i < G * HD; i += kThreads)
    q_s[i] = to_f32(q[bn * G * HD + i]);
  __syncthreads();  // q_s

  float m[G], l[G], acc[G][kCols];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -1e30f;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[g][e] = 0.f;
  }
  float* pr_s = reinterpret_cast<float*>(ring_p + SM::kP);
  for (int k = 0; k < nt; ++k) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
    unsigned char* st = ring_p + (k % kStages) * S::kBytes;
    const int t0 = tile_col(k);
    if (APPEND && t0 == pt0 && pc >= 0) {
      // the fresh column into the stage (int4: merged with the partner
      // nibble as copied), and from there into the pools
      const int j = pc - t0;
      for (int d = lane; d < HD; d += 32) {
        int8_t* kb = reinterpret_cast<int8_t*>(st + S::kK + d * TILE + j);
        int8_t* vb = reinterpret_cast<int8_t*>(st + S::kV + j * HD + d);
        *kb = INT4 ? merge_nibble(*kb, fresh[d], p_hi) : fresh[d];
        *vb = INT4 ? merge_nibble(*vb, fresh[HD + d], p_hi) : fresh[HD + d];
        k_bn[(size_t)d * TB + pc] = *kb;
        v_bn[(size_t)pc * v_row + d] = *vb;
      }
      if (lane == 0) {
        const int slot = j + (p_hi ? TILE : 0);
        reinterpret_cast<float*>(st + S::kKs)[slot] = fresh_s[0];
        reinterpret_cast<float*>(st + S::kVs)[slot] = fresh_s[1];
        ks_bn[p] = fresh_s[0];
        vs_bn[(size_t)p * nkv] = fresh_s[1];
      }
      __syncwarp();
    }
    attend_tile<T, HD, G, INT4, TILE>(st, q_s, pr_s, t0, TB, start, length,
                                      hd_scale, lane, m, l, acc);
    __syncwarp();  // every lane is done with the stage and the P buffer
    issue(k + kStages);
  }
  cp_async_wait<0>();

  // ---- the warps meet in warp order: the chunk's (m, l, acc)
  __syncthreads();  // every warp is done with its ring
  float* mw = reinterpret_cast<float*>(smem);
  float* lw = mw + kWarps * G;
  float* aw = lw + kWarps * G;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mw[warp * G + g] = m[g];
      lw[warp * G + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      aw[(warp * G + g) * HD + lane * kCols + e] = acc[g][e];
  __syncthreads();
  const size_t ml_of_row = bn * max_chunks * G * 2;
  const size_t acc_base = (size_t)gridDim.z * nkv * max_chunks * G * 2;
  const size_t acc_of_row = acc_base + bn * max_chunks * G * HD;
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float mx = mw[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, mw[w * G + g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(mw[w * G + g] - mx);
      ls += lw[w * G + g] * f;
      as += aw[(w * G + g) * HD + d] * f;
    }
    if (n_work == 1) {
      o[i] = from_f32<T>(as / fmaxf(ls, 1e-30f));
    } else {
      part[acc_of_row + (size_t)c * G * HD + i] = as;
      if (d == 0) {
        part[ml_of_row + ((size_t)c * G + g) * 2] = mx;
        part[ml_of_row + ((size_t)c * G + g) * 2 + 1] = ls;
      }
    }
  }
  if (n_work == 1) return;

  // ---- the row's last live chunk to arrive merges them all, in chunk
  // order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + bn;
    const bool last = atomicAdd(cnt, 1) == n_work - 1;
    if (last) *cnt = 0;
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  auto chunk_live = [&](int cc) {
    return (cc >= ca0 && cc < ca1) || (cc >= cb0 && cc < cb1);
  };
  // every live chunk's (m, l) into shared memory at once (the rings are
  // free), then each thread's accumulators kBatch chunks at a time: a few
  // L2 round trips, not two a chunk. The sums keep chunk order.
  constexpr int kBatch = 8;
  float* ml_s = reinterpret_cast<float*>(smem);    // [chunk][G][2]
  const bool staged = (size_t)max_chunks * G * 2 * 4 <= (size_t)SM::kQ;
  if (staged) {
    for (int i = tid; i < max_chunks * G * 2; i += kThreads)
      ml_s[i] = chunk_live(i / (G * 2)) ? __ldcg(part + ml_of_row + i) : 0.f;
    __syncthreads();
  }
  auto ml = [&](int cc, int g, int k) {
    const size_t at = ((size_t)cc * G + g) * 2 + k;
    return staged ? ml_s[at] : __ldcg(part + ml_of_row + at);
  };
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const float* pa = part + acc_of_row + i;
    float mx = -INFINITY;
    for (int cc = 0; cc < max_chunks; ++cc)
      if (chunk_live(cc)) mx = fmaxf(mx, ml(cc, g, 0));
    float ls = 0.f, as = 0.f;
    for (int cb = 0; cb < max_chunks; cb += kBatch) {
      float a[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int cc = cb + u;
        a[u] = cc < max_chunks && chunk_live(cc)
                   ? __ldcg(pa + (size_t)cc * G * HD)
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int cc = cb + u;
        if (cc < max_chunks && chunk_live(cc)) {
          const float f = expf(ml(cc, g, 0) - mx);
          ls += ml(cc, g, 1) * f;
          as += a[u] * f;
        }
      }
    }
    o[i] = from_f32<T>(as / fmaxf(ls, 1e-30f));
  }
}

// Host side: pick the instance for (dtype, head_dim, group size, append).
struct Call {
  const void *q, *lengths, *starts, *pos, *k_new, *k_snew, *v_new, *v_snew;
  void *out, *kp, *ks, *vp, *vs, *part, *counters;
  int B, nkv, T_len, kvec;
  float hd_scale;
  cudaStream_t stream;
  bool smem_only;   // return the instance's shared bytes, launch nothing
};

constexpr int kNoInstance = -1;

template <bool INT4, int CHUNK, int TILE>
struct Launch {
  template <typename T, int HD, int G, bool APPEND>
  static int run(const Call& a) {
    auto kernel = kv_attention_kt<T, HD, G, APPEND, INT4, CHUNK, TILE>;
    constexpr int smem = Smem<HD, G, INT4, TILE>::kBytes;
    if (a.smem_only) return smem;
    static bool done[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !done[dev]) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) done[dev] = true;
    }
    const int tb = INT4 ? a.T_len / 2 : a.T_len;
    const dim3 grid((tb + CHUNK - 1) / CHUNK, a.nkv, a.B);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<T*>(a.out),
        static_cast<int8_t*>(a.kp), static_cast<float*>(a.ks),
        static_cast<int8_t*>(a.vp), static_cast<float*>(a.vs),
        static_cast<const int32_t*>(a.lengths),
        static_cast<const int32_t*>(a.starts),
        static_cast<const int32_t*>(a.pos),
        static_cast<const int8_t*>(a.k_new),
        static_cast<const float*>(a.k_snew),
        static_cast<const int8_t*>(a.v_new),
        static_cast<const float*>(a.v_snew), static_cast<float*>(a.part),
        static_cast<int*>(a.counters), a.nkv, a.T_len, a.kvec, a.hd_scale);
    return (int)cudaGetLastError();
  }

  template <typename T, int HD, int G>
  static int by_append(int append, const Call& a) {
    return append ? run<T, HD, G, true>(a) : run<T, HD, G, false>(a);
  }

  template <typename T, int HD>
  static int by_group(int g, int append, const Call& a) {
    if (g == 1) return by_append<T, HD, 1>(append, a);
    if (g == 2) return by_append<T, HD, 2>(append, a);
    if (g == 4) return by_append<T, HD, 4>(append, a);
    if (g == 8) return by_append<T, HD, 8>(append, a);
    return kNoInstance;
  }

  template <typename T>
  static int by_head_dim(int hd, int g, int append, const Call& a) {
    if (hd == 64) return by_group<T, 64>(g, append, a);
    if (hd == 128) return by_group<T, 128>(g, append, a);
    return kNoInstance;
  }

  // dtype: 0 = float32, 1 = bfloat16 (q and out).
  static int dispatch(int dtype, int hd, int g, int append, const Call& a) {
    return dtype == 1 ? by_head_dim<__nv_bfloat16>(hd, g, append, a)
                      : by_head_dim<float>(hd, g, append, a);
  }

  // One launch, after the checks of its scratch; see the entry points.
  static int launch(const void* q, void* out, void* kp, void* ks, void* vp,
                    void* vs, const void* lengths, const void* starts,
                    const void* pos, const void* k_new, const void* k_snew,
                    const void* v_new, const void* v_snew, void* part,
                    void* counters, int B, int nkv, int g, int hd, int T,
                    int dtype, int append, int chunk, long long part_floats,
                    float hd_scale, void* stream) {
    const int tb = INT4 ? T / 2 : T;
    const long long need =
        (long long)B * nkv * ((tb + CHUNK - 1) / CHUNK) * g * (hd + 2);
    if (chunk != CHUNK || part_floats < need || B < 1 || B > 65535 ||
        tb < 1 || nkv < 1 || nkv > 65535)
      return (int)cudaErrorInvalidValue;
    // the widest copy that K's rows and base allow (16, 8 or 4 bytes; 1:
    // byte loads)
    int kvec = 16;
    while (kvec >= 4 &&
           (tb % kvec != 0 || reinterpret_cast<uintptr_t>(kp) % kvec != 0))
      kvec /= 2;
    if (kvec < 4) kvec = 1;
    const Call a{q,      lengths, starts, pos,  k_new, k_snew,
                 v_new,  v_snew,  out,    kp,   ks,    vp,
                 vs,     part,    counters, B,  nkv,   T,
                 kvec,   hd_scale, static_cast<cudaStream_t>(stream), false};
    const int r = dispatch(dtype, hd, g, append, a);
    return r == kNoInstance ? (int)cudaErrorInvalidValue : r;
  }

  static int smem_bytes(int dtype, int hd, int g, int append) {
    Call a{};
    a.smem_only = true;
    return dispatch(dtype, hd, g, append, a);
  }
};

}  // namespace onebit_kt
