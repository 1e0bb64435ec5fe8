// Small-M (decode) packed OneBit linear: K1, K2 and B4 small-M of the port,
// three counted instances of one kernel body, one launch a call.
//
// Replaces, in onebit_tpu/kernels/bitlinear_pallas.py:
//   K1  bitlinear_packed_pallas_stacked / _call_small_m_stacked
//       (body _fused_small_m_kernel): one projection, o_proj and down_proj;
//   K2  bitlinear_packed_fused_stacked (body _fused_multiseg_small_kernel):
//       ns projections sharing x (q/k/v, gate/up) concatenated along N, each
//       segment padded to seg_pad with h = 0, LayerNorm per segment over the
//       true width n_true;
//   B4  bitlinear_packed_raw_stacked / bitlinear_packed_raw at M <= 128
//       (_call_small_m(_stacked) with fuse_ln=False): K1 with raw = 1, the
//       projection of a tensor-parallel shard, whose LayerNorm runs after
//       the cross-shard all-reduce (model/tp_decode.py); its output is the
//       fp32 z ⊙ h.
// All compute LayerNorm(((x ⊙ g_seg) · Sᵀ) ⊙ h) (+ bias) for M <= 128 rows.
//
// Bound on an H100: the packed sign words, read once (K*N/8 bytes); x, g, h
// and the output are small beside them at decode. At llama2-7b o_proj
// (K = N = 4096) that is 2.1 MB, about 0.63 us at 3.35 TB/s.
//
// Design.
//  * Tensor cores: mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with A and
//    B swapped: 16 output columns are the MMA's M side, 8 rows of x its N
//    side, so decode's M = 8 fills it; a CTA owns 8 rows (grid.y walks the
//    rows in blocks of 8). mma.sync rather than wgmma m64n8k16: the ±1 A
//    operand is built in each warp's own registers, so the CTA's 8 warps
//    split its k range with no warpgroup-wide handoff, and the product at
//    M = 8 needs about 2% of the tensor cores' rate, so wgmma's higher rate
//    would buy nothing.
//  * The A operand from the packed words, in registers: MMA k slots 2t and
//    2t+1 of lane quad t (and 2t+8, 2t+9) take word bits p and p + 16,
//    p = 4t + 2s + r for k step s of the word's two and register r, so one
//    shift and one lop3 make a ±1 bf16 pair: ((w << (15 - p)) & 0x80008000)
//    | 0x3F803F80 (bit 1 = sign -1 moved onto each half's sign bit over
//    1.0). y's B fragment pairs y[p] with y[p + 16] in the same order; the
//    sum over k is the same in any order of k. Nothing unpacked touches
//    memory.
//  * y = x ⊙ g rounded to x's dtype (JAX's rounding): for bf16 one bf16x2
//    multiply, correctly rounded; for fp32 the fp32 product split into
//    three bf16 parts (split_bf16x3 in bitlinear_cuda.py) whose exact
//    products with ±1 go through three MMAs; each word row's 32 k start a
//    fresh accumulator that is then added in fp32 registers, since the
//    tensor cores' fp32 adds round toward zero.
//  * Every weight byte in flight: the grid is (column tiles x k splits, row
//    blocks), `block_n`, `splits` and the split's `kw` word rows from
//    small_m_plan (bitlinear_cuda.py: about 1.5 CTAs an SM, at most 64 word
//    rows a CTA where K allows). Each warp takes every 8th word row of its
//    CTA's split and issues the cp.async copies of all of them (the words
//    of BN columns, the 8 x rows and g of those 32 k) in four commit groups
//    before it uses any, then consumes group by group behind
//    cp.async.wait_group and __syncwarp: no block barrier until the warps'
//    sums meet. At llama2-7b, M = 8 (BN 128, one wave): o_proj 192 CTAs (6
//    splits of 22 word rows), about 16 KB of words in flight an SM;
//    down_proj 192 (6 of 58; 43 KB an SM); q/k/v 192 (2 of 64; 48 KB);
//    gate/up 344 (2 of 64; 85 KB); the mp = 2 shards 128-215 CTAs of 11-29
//    rows (8-21 KB an SM). x and g reach each CTA from L2 once, for its
//    split's k range: 576 bytes of bf16 x and g per 512 bytes of words, so
//    a call reads 1.1 times its words' bytes of x and g from L2 (the first
//    version's 128 CTAs each read all of x: 8.4 MB at o_proj against 2.1 MB
//    of words).
//  * Split-K in a thread-block cluster: a tile's splits (at most 8) are one
//    cluster; each CTA leaves its fp32 partial [8, BN] in its shared
//    memory, and after a cluster barrier the first CTA sums them through
//    distributed shared memory in split order (no float atomics, so the
//    same call gives the same bits); a second barrier keeps the peers'
//    shared memory until it is read.
//  * LayerNorm in the same launch: the tile's first CTA writes z ⊙ h (fp32)
//    and, per row, the tile's sum over its true columns and the squared
//    deviations about the tile's own mean (two passes over the tile in
//    shared memory), then takes a ticket on a per-(row block, segment)
//    counter the wrapper keeps per device. The last `normalizers` tiles to
//    arrive (at most 8, and together under a quarter of the SMs, so the
//    tiles they wait for always find room to run) wait for the others,
//    combine the statistics in tile order, mean = Σ sums / n_true and
//    M2 = Σ [M2_t + n_t (mean_t - mean)^2] (the two-pass statistics by
//    parts; biased variance, eps, over n_true only, never the pad
//    columns), and normalise a slice each of the segment's columns,
//    reading z from L2, + bias, cast; the last to leave zeroes the
//    counters. With raw = 1 (B4) the tile's first CTA writes z ⊙ h and
//    stops.
//  * Edges: a column tile never straddles a fused segment (BN = 64 where
//    128 does not divide seg_pad); ragged N and M are masked; K is any
//    number of 32-k words up to 32768; offsets are 64-bit.
// The counters are shared by every launch on a device: two streams must not
// run this kernel at once.
#include <cooperative_groups.h>

#include "bitlinear_common.cuh"
#include "wgmma_common.cuh"

namespace onebit {

namespace cg = cooperative_groups;

using onebit_sm90::cp_async16;
using onebit_sm90::cp_async4;
using onebit_sm90::cp_async_commit;
using onebit_sm90::cp_async_wait;
using onebit_sm90::smem_u32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;         // rows of x per CTA: the MMA's N
constexpr int kMaxWords = 128;   // word rows a CTA stages at most
constexpr int kMaxSplits = 8;    // a tile's splits: one portable cluster
constexpr int kGroups = 4;       // commit groups of a warp's word rows
constexpr int kBatch = 8;        // float4 loads a thread keeps in flight
static_assert(kWarps == kRows, "the statistics give each warp one row");

// Shared memory of one CTA: per staged word row, its words [BN], its x rows
// [8][32] and g [32] (in x's dtype); after the MMAs, the warps' partial sums
// [warp][row][BN + 4] and the z tile [8][BN].
template <typename T, int BN>
struct Layout {
  static constexpr int kWordBytes = BN * 4;
  static constexpr int kXBytes = 32 * (int)sizeof(T);
  static constexpr int kRowBytes = kWordBytes + (kRows + 1) * kXBytes;
  static constexpr int kRedStride = BN + 4;  // floats; spreads the banks
  static constexpr int kRedBytes = kWarps * kRows * kRedStride * 4;
  static constexpr int kTileBytes = kRows * BN * 4;
  static constexpr int kMaxBytes =
      kMaxWords * kRowBytes > kRedBytes + kTileBytes
          ? kMaxWords * kRowBytes
          : kRedBytes + kTileBytes;
  static_assert(kRowBytes % 16 == 0, "16-byte copies");
};

struct Args {
  const void* x;          // [M, K] (x's dtype T)
  const void* g;          // [ns, K] (T)
  const int32_t* packed;  // [K/32, N]
  const float* h;         // [N]
  const float* bias;      // [N] or null (ns = 1)
  float* z;               // z ⊙ h [M, N]: the output (raw) or the LN input
  float2* stats;          // per (row, tile): (sum, squared deviations)
  void* out;              // [ns, M, n_true] (T), unless raw
  int* counters;          // per (row block, segment): arrivals, departures
  int M, K, N, ns, seg_pad, n_true, splits, kw, normalizers, raw, vec;
  float eps;
};

// Copies of word row `wr` (its BN words, the 8 x rows and g over its 32 k)
// into shared memory at dst, issued by one warp; rows past M and columns
// past N arrive as zeros.
template <typename T, int BN>
__device__ __forceinline__ void stage_row(const Args& a, uint32_t dst, int wr,
                                          int n0, int m0, int seg, int lane) {
  using L = Layout<T, BN>;
  constexpr int kXChunks = L::kXBytes / 16;     // 16-byte copies a 32-k row
  constexpr int kPer = 16 / (int)sizeof(T);     // elements a copy
  const int32_t* words = a.packed + (size_t)wr * a.N;
  if (a.vec) {
    for (int c = lane; c < BN / 4; c += 32) {
      const int n = n0 + 4 * c;
      cp_async16(dst + 16 * c, n < a.N ? words + n : a.packed, n < a.N);
    }
  } else {
    for (int c = lane; c < BN; c += 32) {
      const int n = n0 + c;
      cp_async4(dst + 4 * c, n < a.N ? words + n : a.packed, n < a.N);
    }
  }
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  for (int c = lane; c < (kRows + 1) * kXChunks; c += 32) {
    const int r = c / kXChunks, k = 32 * wr + (c % kXChunks) * kPer;
    const bool ok = r == kRows || m0 + r < a.M;
    const T* src = r == kRows ? g + (size_t)seg * a.K + k
                 : ok         ? x + (size_t)(m0 + r) * a.K + k
                              : x;
    cp_async16(dst + L::kWordBytes + 16 * c, src, ok);
  }
}

// One ±1 bf16 pair: bits p and p + 16 of w onto the sign bits of 1.0, 1.0.
__device__ __forceinline__ uint32_t sign_pair(uint32_t w, int shift) {
  return ((w << shift) & 0x80008000u) | 0x3F803F80u;
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The B fragments of one word row for this lane (x row gr, k quad tig):
// b[part][s][r] pairs y[p] (low half) with y[p + 16], p = 4 tig + 2 s + r.
// bf16: one part, y = x * g correctly rounded; fp32: y's three bf16 parts.
template <typename T>
struct YFrag;

template <>
struct YFrag<__nv_bfloat16> {
  static constexpr int kParts = 1;
  uint32_t b[1][2][2];
  __device__ __forceinline__ void load(const unsigned char* xg, int gr,
                                       int tig) {
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(xg) + gr * 32 + 4 * tig;
    const __nv_bfloat16* gs =
        reinterpret_cast<const __nv_bfloat16*>(xg) + kRows * 32 + 4 * tig;
    const uint2 xl = *reinterpret_cast<const uint2*>(xs);
    const uint2 xh = *reinterpret_cast<const uint2*>(xs + 16);
    const uint2 gl = *reinterpret_cast<const uint2*>(gs);
    const uint2 gh = *reinterpret_cast<const uint2*>(gs + 16);
    auto mul = [](uint32_t u, uint32_t v) {
      return bf16_bits(__hmul2(*reinterpret_cast<const __nv_bfloat162*>(&u),
                               *reinterpret_cast<const __nv_bfloat162*>(&v)));
    };
    const uint32_t l01 = mul(xl.x, gl.x), l23 = mul(xl.y, gl.y);
    const uint32_t h01 = mul(xh.x, gh.x), h23 = mul(xh.y, gh.y);
    b[0][0][0] = __byte_perm(l01, h01, 0x5410);
    b[0][0][1] = __byte_perm(l01, h01, 0x7632);
    b[0][1][0] = __byte_perm(l23, h23, 0x5410);
    b[0][1][1] = __byte_perm(l23, h23, 0x7632);
  }
};

template <>
struct YFrag<float> {
  static constexpr int kParts = 3;
  uint32_t b[3][2][2];
  __device__ __forceinline__ void load(const unsigned char* xg, int gr,
                                       int tig) {
    const float* xs = reinterpret_cast<const float*>(xg) + gr * 32 + 4 * tig;
    const float* gs =
        reinterpret_cast<const float*>(xg) + kRows * 32 + 4 * tig;
    const float4 xl = *reinterpret_cast<const float4*>(xs);
    const float4 xh = *reinterpret_cast<const float4*>(xs + 16);
    const float4 gl = *reinterpret_cast<const float4*>(gs);
    const float4 gh = *reinterpret_cast<const float4*>(gs + 16);
    const float lo[4] = {__fmul_rn(xl.x, gl.x), __fmul_rn(xl.y, gl.y),
                         __fmul_rn(xl.z, gl.z), __fmul_rn(xl.w, gl.w)};
    const float hi[4] = {__fmul_rn(xh.x, gh.x), __fmul_rn(xh.y, gh.y),
                         __fmul_rn(xh.z, gh.z), __fmul_rn(xh.w, gh.w)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float pl[3], ph[3];
      split3(lo[q], pl);
      split3(hi[q], ph);
#pragma unroll
      for (int part = 0; part < 3; ++part)
        b[part][q >> 1][q & 1] = bf16_bits(__floats2bfloat162_rn(pl[part],
                                                                 ph[part]));
    }
  }
  // y = hi + mid + lo, each a bf16 value (split_bf16x3's rule)
  __device__ __forceinline__ static void split3(float y, float (&p)[3]) {
    p[0] = __bfloat162float(__float2bfloat16_rn(y));
    const float r = __fsub_rn(y, p[0]);
    p[1] = __bfloat162float(__float2bfloat16_rn(r));
    p[2] = __fsub_rn(r, p[1]);   // rounded to bf16 by the pack
  }
};

// acc[cg] += the 32 k of one staged word row for column group cg (16
// columns) and the CTA's 8 rows.
template <typename T, int BN>
__device__ __forceinline__ void mma_row(const unsigned char* row, int gr,
                                        int tig, float (&acc)[BN / 16][4]) {
  using L = Layout<T, BN>;
  YFrag<T> y;
  y.load(row + L::kWordBytes, gr, tig);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
  const int sh = 15 - 4 * tig;
#pragma unroll
  for (int cg = 0; cg < BN / 16; ++cg) {
    const uint32_t w0 = words[16 * cg + gr], w1 = words[16 * cg + gr + 8];
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint32_t a[4] = {sign_pair(w0, sh - 2 * s),
                             sign_pair(w1, sh - 2 * s),
                             sign_pair(w0, sh - 2 * s - 1),
                             sign_pair(w1, sh - 2 * s - 1)};
      if constexpr (YFrag<T>::kParts == 1) {
        mma16816(acc[cg], a, y.b[0][s][0], y.b[0][s][1]);
      } else {
#pragma unroll
        for (int part = 0; part < YFrag<T>::kParts; ++part)
          mma16816(d, a, y.b[part][s][0], y.b[part][s][1]);
      }
    }
    if constexpr (YFrag<T>::kParts > 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[cg][e] += d[e];
    }
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 2)
small_m_kernel(const Args a) {
  using L = Layout<T, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket_s;
  __shared__ float mean_s[kRows], rstd_s[kRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tig = lane & 3;
  const int M = a.M, N = a.N;
  const int n_tiles = (N + BN - 1) / BN;
  const int tile = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int rblk = blockIdx.y, m0 = rblk * kRows;
  const int n0 = tile * BN, seg = n0 / a.seg_pad;
  const int w_first = split * a.kw;
  const int kw = max(0, min(a.kw, a.K / 32 - w_first));

  // ---- every copy of this warp's word rows (warp, warp + 8, ...) first
  const int nr = warp < kw ? (kw - warp + kWarps - 1) / kWarps : 0;
  const int per = (nr + kGroups - 1) / kGroups;
  const uint32_t base = smem_u32(smem);
  for (int q = 0; q < kGroups; ++q) {
    for (int i = q * per; i < min(nr, (q + 1) * per); ++i) {
      const int j = warp + kWarps * i;
      stage_row<T, BN>(a, base + j * L::kRowBytes, w_first + j, n0, m0, seg,
                       lane);
    }
    cp_async_commit();
  }

  // ---- then the MMAs, group by group as the copies land
  float acc[BN / 16][4];
#pragma unroll
  for (int cg = 0; cg < BN / 16; ++cg)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[cg][e] = 0.f;
  static_assert(kGroups == 4, "one wait per group");
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    if (q == 0) cp_async_wait<3>();
    if (q == 1) cp_async_wait<2>();
    if (q == 2) cp_async_wait<1>();
    if (q == 3) cp_async_wait<0>();
    __syncwarp();
    for (int i = q * per; i < min(nr, (q + 1) * per); ++i)
      mma_row<T, BN>(smem + (warp + kWarps * i) * L::kRowBytes, gr, tig, acc);
  }

  // ---- the warps' sums meet in warp order: the CTA's [8, BN] partial
  __syncthreads();  // every warp is done with the staged rows
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int cg = 0; cg < BN / 16; ++cg)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * kRows + 2 * tig + (e & 1)) * L::kRedStride + 16 * cg + gr +
          8 * (e >> 1)] = acc[cg][e];
  __syncthreads();
  constexpr int kPer = kRows * BN / kThreads;
  float v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int o = tid + i * kThreads, r = o / BN, c = o % BN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * kRows + r) * L::kRedStride + c];
    v[i] = s;
  }

  // ---- split-K: the cluster's first CTA sums the splits' partials from
  // their shared memory, in split order
  float* part = reinterpret_cast<float*>(smem + L::kRedBytes);  // [8][BN]
  if (a.splits > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int i = 0; i < kPer; ++i) part[tid + i * kThreads] = v[i];
    cluster.sync();
    if (split == 0) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[i] = 0.f;
      for (int r = 0; r < a.splits; ++r) {
        const float* peer = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < kPer; ++i) v[i] += peer[tid + i * kThreads];
      }
    }
    cluster.sync();  // the peers' shared memory stays until it is read
    if (split != 0) return;
  }

  // ---- z ⊙ h: the output (raw), or the LayerNorm's input
  float* zt = part;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int o = tid + i * kThreads, r = o / BN, c = o % BN;
    const int m = m0 + r, n = n0 + c;
    const float z = n < N ? v[i] * a.h[n] : 0.f;
    zt[o] = z;
    if (m < M && n < N) a.z[(size_t)m * N + n] = z;
  }
  if (a.raw) return;

  // ---- the tile's statistics per row, over its true columns
  __syncthreads();
  {
    const int r = warp, m = m0 + r;
    const int cnt = max(0, min(min(a.n_true - (n0 - seg * a.seg_pad), N - n0),
                               BN));
    float s = 0.f;
    for (int c = lane; c < cnt; c += 32) s += zt[r * BN + c];
    s = warp_sum(s);
    float q = 0.f;
    if (cnt > 0) {
      const float mean = s / (float)cnt;
      for (int c = lane; c < cnt; c += 32) {
        const float d = zt[r * BN + c] - mean;
        q += d * d;
      }
    }
    q = warp_sum(q);
    if (lane == 0 && m < M)
      a.stats[(size_t)m * n_tiles + tile] = make_float2(s, q);
  }

  // ---- the segment's last `normalizers` tiles to arrive normalise it, a
  // slice each, once every tile of the segment has arrived
  const int seg_tiles = a.ns == 1 ? n_tiles : a.seg_pad / BN;
  int* arrive = a.counters + 2 * (rblk * a.ns + seg);
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // this CTA's z and statistics, before its arrival
    ticket_s = atomicAdd(arrive, 1);
    __threadfence();
  }
  __syncthreads();
  const int first = seg_tiles - a.normalizers, slice = ticket_s - first;
  if (slice < 0) return;
  if (tid == 0) {
    while (ld_acquire(arrive) < seg_tiles) __nanosleep(64);
  }
  __syncthreads();

  const int t0 = seg * seg_tiles, n_seg = seg * a.seg_pad;
  {
    const int r = warp, m = m0 + r;
    if (m < M) {
      // a lane's tiles u = lane + 32 j (a segment has at most 32 * kSt)
      constexpr int kSt = 8;
      const float2* st = a.stats + (size_t)m * n_tiles + t0;
      float2 p[kSt];
#pragma unroll
      for (int j = 0; j < kSt; ++j) {
        const int u = lane + 32 * j;
        p[j] = u < seg_tiles ? __ldcg(st + u) : make_float2(0.f, 0.f);
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kSt; ++j) s += p[j].x;
      const float mean = warp_sum(s) / (float)a.n_true;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < kSt; ++j) {
        const int u = lane + 32 * j;
        const int cnt =
            max(0, min(min(a.n_true - u * BN, N - n_seg - u * BN), BN));
        if (cnt > 0) {
          const float d = p[j].x / (float)cnt - mean;
          q += p[j].y + (float)cnt * d * d;
        }
      }
      q = warp_sum(q);
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rsqrtf(q / (float)a.n_true + a.eps);
      }
    }
  }
  __syncthreads();

  // ---- this CTA's slice [c0, c1) of the segment's true columns, + bias,
  // cast
  const int rows = min(kRows, M - m0), nt = a.n_true;
  const bool vec = a.vec && nt % 4 == 0 && a.seg_pad % 4 == 0;
  const int width = vec ? (nt + 4 * a.normalizers - 1) / (4 * a.normalizers) * 4
                        : (nt + a.normalizers - 1) / a.normalizers;
  const int c0 = min(nt, slice * width), c1 = min(nt, c0 + width);
  const float* zs = a.z + (size_t)m0 * N + n_seg;
  T* out = static_cast<T*>(a.out) + ((size_t)seg * M + m0) * nt;
  if (vec) {
    const int w4 = (c1 - c0) / 4, total = rows * w4;
    for (int b0 = 0; b0 < total; b0 += kThreads * kBatch) {
      float4 zz[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = b0 + tid + u * kThreads;
        if (i < total)
          zz[u] = __ldcg(reinterpret_cast<const float4*>(
              zs + (size_t)(i / w4) * N + c0 + 4 * (i % w4)));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = b0 + tid + u * kThreads;
        if (i >= total) continue;
        const int r = i / w4, c = c0 + 4 * (i % w4);
        const float mean = mean_s[r], rstd = rstd_s[r];
        float o[4] = {(zz[u].x - mean) * rstd, (zz[u].y - mean) * rstd,
                      (zz[u].z - mean) * rstd, (zz[u].w - mean) * rstd};
        if (a.bias != nullptr) {
          const float4 bv = *reinterpret_cast<const float4*>(a.bias + c);
          o[0] += bv.x;
          o[1] += bv.y;
          o[2] += bv.z;
          o[3] += bv.w;
        }
        T* dst = out + (size_t)r * nt + c;
        if (sizeof(T) == 2) {
          uint2 pk;
          pk.x = bf16_bits(__floats2bfloat162_rn(o[0], o[1]));
          pk.y = bf16_bits(__floats2bfloat162_rn(o[2], o[3]));
          *reinterpret_cast<uint2*>(dst) = pk;
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
        }
      }
    }
  } else {
    const int w = c1 - c0;
    for (int i = tid; i < rows * w; i += kThreads) {
      const int r = i / w, c = c0 + i % w;
      float o = (__ldcg(zs + (size_t)r * N + c) - mean_s[r]) * rstd_s[r];
      if (a.bias != nullptr) o += a.bias[c];
      out[(size_t)r * nt + c] = from_f32<T>(o);
    }
  }

  // ---- the last normaliser to leave zeroes the segment's counters
  if (tid == 0 && atomicAdd(arrive + 1, 1) == a.normalizers - 1) {
    arrive[0] = 0;
    arrive[1] = 0;
  }
}

// Raises a kernel's dynamic shared memory limit once per device.
template <typename T, int BN>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(small_m_kernel<T, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Layout<T, BN>::kMaxBytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <typename T, int BN>
int launch(const Args& a, cudaStream_t stream) {
  using L = Layout<T, BN>;
  const cudaError_t e = allow_smem<T, BN>();
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (a.N + BN - 1) / BN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * a.splits, (a.M + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.kw * L::kRowBytes > L::kRedBytes + L::kTileBytes
                             ? a.kw * L::kRowBytes
                             : L::kRedBytes + L::kTileBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;  // one cluster per (tile, row block)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, small_m_kernel<T, BN>, a);
}

// Checks the plan (block_n, splits, kw, normalizers) the wrapper passes,
// then launches.
int dispatch(Args a, int dtype, int block_n, void* stream) {
  const int nw = a.K / 32;
  const int tiles = (a.N + block_n - 1) / block_n;
  const int seg_tiles = a.ns == 1 ? tiles : a.seg_pad / block_n;
  const bool plan_ok =
      a.M >= 1 && a.M <= 128 && a.K % 32 == 0 && nw >= 1 && a.splits >= 1 &&
      a.splits <= kMaxSplits && a.kw >= 1 && a.kw <= kMaxWords &&
      (a.splits - 1) * a.kw < nw && a.splits * a.kw >= nw &&
      (block_n == 64 || block_n == 128) && a.seg_pad * a.ns == a.N &&
      (a.ns == 1 || a.seg_pad % block_n == 0) && a.n_true >= 1 &&
      a.n_true <= a.seg_pad && a.normalizers >= 1 &&
      a.normalizers <= seg_tiles && seg_tiles <= 256;
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return block_n == 128 ? launch<__nv_bfloat16, 128>(a, st)
                          : launch<__nv_bfloat16, 64>(a, st);
  return block_n == 128 ? launch<float, 128>(a, st) : launch<float, 64>(a, st);
}

}  // namespace onebit

// One launch of the small-M kernel. dtype: 0 = float32, 1 = bfloat16 (x, g
// and out; h, bias, z and stats are fp32). The plan (block_n, splits, kw,
// normalizers) is bitlinear_cuda.small_m_plan's; stats holds M *
// ceil(N / block_n) pairs, counters 2 * ceil(M / 8) * ns ints that are zero
// before the launch and after it. vec = 1 when packed starts on 16 bytes
// and N % 4 == 0 (and bias, if given, starts on 16 bytes); x and g start
// on 16 bytes. raw = 1: z is the output. Returns the launch's error (0 on
// success).
extern "C" int onebit_bitlinear_small_m(
    const void* x, const void* g, const void* packed, const void* h,
    const void* bias, void* z, void* stats, void* out, void* counters, int M,
    int K, int N, int ns, int seg_pad, int n_true, int dtype, int raw,
    int block_n, int splits, int kw, int normalizers, int vec, float eps,
    void* stream) {
  onebit::Args a;
  a.x = x;
  a.g = g;
  a.packed = static_cast<const int32_t*>(packed);
  a.h = static_cast<const float*>(h);
  a.bias = static_cast<const float*>(bias);
  a.z = static_cast<float*>(z);
  a.stats = static_cast<float2*>(stats);
  a.out = out;
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.K = K;
  a.N = N;
  a.ns = ns;
  a.seg_pad = seg_pad;
  a.n_true = n_true;
  a.splits = splits;
  a.kw = kw;
  a.normalizers = normalizers;
  a.raw = raw;
  a.vec = vec;
  a.eps = eps;
  return onebit::dispatch(a, dtype, block_n, stream);
}
