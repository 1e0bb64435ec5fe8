// Decode attention through page tables: kernel B10 of the port.
//
// Replaces onebit_tpu/kernels/paged_attention.py paged_attention_flat (body
// _kernel): one query token per row against a flat multi-layer page pool.
// Three instances share this body, each counted apart by the wrapper: float
// pages (bf16 or f32, the dtype of q), int8 pages with raw absmax scales,
// and fp8 e4m3 pages with no scales. The fp8 instance computes the function
// of JAX's gather path for such pages (onebit_tpu/engine/paged.py:262-270:
// the pages cast to q's dtype, then _jnp_paged_attention), since the Pallas
// kernel has no fp8 page path: each element converts exactly to q's dtype
// (every e4m3 value is exact in bf16), one byte an element moved.
//
// Layouts of one layer (the wrapper passes the layer slice's base pointers;
// every offset below is 64-bit, since a llama2-7b pool at the engine's
// defaults holds 32 x 1025 x 32 x 16 x 128 > 2**31 elements):
//   K, V  [P, nkv, ps, HD]   page p, head n: one contiguous [ps, HD] slab
//                            (HD bytes a position for int8 and fp8);
//                            position t of row b is row
//                            (tbl[t / ps] * nkv + n) * ps + t % ps
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
// Bound on an H100: HBM bytes. Every K and V byte of a row's positions
// under its length is read once for 4 flops per element and query head,
// far below the 295 flops per byte where bf16 compute would bound it. The
// design is B9's (kv_attention_decode.cu), through the page tables:
//   * split-T: each row's positions are cut into chunks of kChunk = 256
//     counted from position 0 (16 pages at ps 16); one CTA runs per (chunk,
//     kv head, row) and serves the G query heads of that kv head, so each
//     page byte is read by one CTA only, and a 2048-position row spreads
//     over 8 CTAs a head instead of walking serially in one. The grid is
//     (ceil(mp * ps / 256), nkv, B); a CTA past its row's last chunk exits;
//   * inside a CTA, each of the 4 warps takes every 4th tile of 16
//     positions of the chunk and runs its own online softmax over them: two
//     lanes a position (each dots half of HD with q, one shuffle joins
//     them), the tile's max and sum by warp shuffles, then P . V with each
//     lane accumulating HD / 32 columns for the G heads. No block barrier in
//     the loop: a warp's tiles come through its own ring of two shared-memory
//     stages filled by cp.async (K rows padded by 16 bytes, so the lanes'
//     row reads do not share banks), the next tile's K, V (and scales) in
//     flight while the current tile's scores, softmax and P . V run;
//   * tiles follow pages: each warp reads the page ids of its tiles' 16
//     positions from the table once, when the CTA starts (the Pallas
//     kernel's scalar prefetch), into shared memory. At ps 16 a tile is one
//     page's contiguous [16, HD] slab for head n (4 KB of bf16), one run of
//     16-byte copies; other page sizes take the same per-position rows;
//   * int8 pages dequantize per element in shared memory's read, each
//     position's scale copied beside its tile (4-byte cp.async);
//   * the 4 warps' (m, l, acc) meet in shared memory in warp order; a row
//     of one chunk writes its output there. Otherwise the chunk's fp32
//     partial goes to scratch the wrapper allocates, and the last of the
//     row's chunks to arrive (an atomic ticket on a per-(row, head) counter
//     the wrapper keeps per device, reset by that CTA) merges them in chunk
//     order, in the same launch. No float atomics: the same call gives the
//     same bits;
//   * the chunks, the warps' tiles and the masks depend on a position's
//     index in its row only, never on its page id: the same positions
//     through another page order give the same bits.
// G query heads run on the CUDA cores (a GQA group of up to 8 heads reads
// each K/V element once from shared memory); the tensor cores are not used.
// The Pallas kernel's concat-convert slab and pages-per-block schedule exist
// for the TPU's VMEM and DMA queue and have no counterpart here. The
// counters are shared by every launch on a device: two streams must not run
// this kernel at once.
//
// A row with length 0 gets out = 0 (finite; the Pallas kernel gives a
// uniform average there; the engine never reads one).
#include <type_traits>

#include "kv_attention_common.cuh"
#include "wgmma_common.cuh"

namespace onebit_paged {

using onebit_kv::load_elems;
using onebit_kv::round_to;
using onebit_kv::to_f32;
using onebit_kv::warp_max;
using onebit_kv::warp_sum;
using onebit_sm90::cp_async16;
using onebit_sm90::cp_async4;
using onebit_sm90::cp_async_commit;
using onebit_sm90::cp_async_wait;
using onebit_sm90::smem_u32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;   // positions a CTA, counted from position 0
constexpr int kTileP = 16;    // positions a warp tile: two lanes a position
constexpr int kStages = 2;    // a warp's ring of tiles
constexpr int kTilesPerWarp = kChunk / (kWarps * kTileP);
static_assert(kTilesPerWarp * kWarps * kTileP == kChunk, "chunk tiling");

// One stage of a warp's ring: K [16][HD] (rows padded by 16 bytes), V
// [16][HD], and for int8 pages the tile's K and V scales.
template <typename P, int HD>
struct Stage {
  static constexpr int kRowBytes = HD * (int)sizeof(P);
  static constexpr int kKStride = kRowBytes + 16;
  static constexpr int kK = 0;
  static constexpr int kV = kTileP * kKStride;
  static constexpr int kKs = kV + kTileP * kRowBytes;
  static constexpr int kVs = kKs + kTileP * 4;
  static constexpr int kBytes = kVs + kTileP * 4;
  static_assert(kRowBytes % 16 == 0 && kBytes % 16 == 0, "16-byte copies");
};

// A CTA's shared memory: the warps' rings, q in fp32 [G][HD], then the
// pool rows of each warp's tile positions [warp][tile][16] (64-bit). After
// the loop the warps' (m, l) [warp][G] and acc [warp][G][HD] reuse the
// rings.
template <typename P, int HD, int G>
struct Smem {
  static constexpr int kWarpBytes = kStages * Stage<P, HD>::kBytes;
  static constexpr int kQ = kWarps * kWarpBytes;
  static constexpr int kRows = kQ + G * HD * 4;
  static constexpr int kBytes = kRows + kWarps * kTilesPerWarp * kTileP * 8;
  static_assert(kWarps * G * (HD + 2) * 4 <= kQ, "the merge fits");
};

template <typename T, typename P, int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_attention(const T* __restrict__ q, float* __restrict__ out,
                const P* __restrict__ kp, const float* __restrict__ ks,
                const P* __restrict__ vp, const float* __restrict__ vs,
                const int32_t* __restrict__ lengths,
                const int32_t* __restrict__ tables, float* __restrict__ part,
                int* __restrict__ counters, int nkv, int ps, int mp,
                float hd_scale) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  using S = Stage<P, HD>;
  using SM = Smem<P, HD, G>;
  constexpr int kHalf = HD / 2;    // elements of a K row one lane dots
  constexpr int kCols = HD / 32;   // V columns one lane accumulates
  constexpr int kRowChunks = S::kRowBytes / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int max_chunks = gridDim.x;
  const size_t bn = (size_t)b * nkv + n;
  float* o = out + bn * G * HD;
  const int n_tok = max(0, min(lengths[b], mp * ps));
  const int n_chunks = (n_tok + kChunk - 1) / kChunk;
  if (n_tok == 0) {
    if (c == 0)
      for (int i = tid; i < G * HD; i += kThreads) o[i] = 0.f;
    return;
  }
  if (c >= n_chunks) return;
  const int c0 = c * kChunk, c1 = min(c0 + kChunk, n_tok);
  const float inv_max = 1.0f / 127.5f;

  float* q_s = reinterpret_cast<float*>(smem + SM::kQ);
  for (int i = tid; i < G * HD; i += kThreads)
    q_s[i] = to_f32(q[bn * G * HD + i]);

  // ---- this warp's tiles: local tile warp + 4 i, i < nt; the pool row of
  // each of their positions, from the page table once
  int nt = 0;
#pragma unroll
  for (int i = 0; i < kTilesPerWarp; ++i)
    if (c0 + (warp + kWarps * i) * kTileP < c1) nt = i + 1;
  long long* rows_s = reinterpret_cast<long long*>(smem + SM::kRows) +
                      warp * kTilesPerWarp * kTileP;
  const int32_t* tbl = tables + (size_t)b * mp;
  for (int e = lane; e < nt * kTileP; e += 32) {
    const int t = c0 + (warp + kWarps * (e / kTileP)) * kTileP + e % kTileP;
    rows_s[e] = t < c1 ? ((long long)tbl[t / ps] * nkv + n) * ps + t % ps
                       : -1;
  }
  __syncwarp();
  const uint32_t ring = smem_u32(smem) + warp * SM::kWarpBytes;
  // tile i's K, V (and scales) into stage i % 2; positions past the chunk
  // arrive as zeros. Every call commits one group, empty or not.
  auto issue = [&](int i) {
    if (i < nt) {
      const uint32_t st = ring + (i % kStages) * S::kBytes;
      const long long* rows = rows_s + i * kTileP;
      for (int e = lane; e < kTileP * kRowChunks; e += 32) {
        const int j = e / kRowChunks, ch = e % kRowChunks;
        const long long row = rows[j];
        const bool ok = row >= 0;
        const size_t off = (size_t)(ok ? row : rows[0]) * HD +
                           ch * (16 / (int)sizeof(P));
        cp_async16(st + S::kK + j * S::kKStride + 16 * ch, kp + off, ok);
        cp_async16(st + S::kV + j * S::kRowBytes + 16 * ch, vp + off, ok);
      }
      if (QUANT) {
        const int j = lane & 15;
        const long long row = rows[j];
        const bool ok = row >= 0;
        const size_t off = (size_t)(ok ? row : rows[0]);
        cp_async4(st + (lane < 16 ? S::kKs : S::kVs) + 4 * j,
                  (lane < 16 ? ks : vs) + off, ok);
      }
    }
    cp_async_commit();
  };
  __syncthreads();  // q_s
  issue(0);
  issue(1);

  float m[G], l[G], acc[G][kCols];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -1e30f;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[g][e] = 0.f;
  }
  const int j = lane & 15, half = lane >> 4;
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<1>();
    __syncwarp();
    const unsigned char* st =
        smem + warp * SM::kWarpBytes + (i % kStages) * S::kBytes;
    const bool valid = c0 + (warp + kWarps * i) * kTileP + j < c1;
    const float* ksc_s = reinterpret_cast<const float*>(st + S::kKs);
    const float* vsc_s = reinterpret_cast<const float*>(st + S::kVs);

    // ---- scores: q . k (k dequantized to T) over the two lanes of the
    // position, x HD**-0.5
    float dot[G];
#pragma unroll
    for (int g = 0; g < G; ++g) dot[g] = 0.f;
    const P* krow =
        reinterpret_cast<const P*>(st + S::kK + j * S::kKStride) + half * kHalf;
    const float* qh = q_s + half * kHalf;
    const float ksc = QUANT ? ksc_s[j] * inv_max : 1.f;
#pragma unroll
    for (int d = 0; d < kHalf; d += 8) {
      float kv[8];
      load_elems<P, 8>(krow + d, kv);
      if (QUANT) {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = round_to<T>(kv[e] * ksc);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 qa = *reinterpret_cast<const float4*>(qh + g * HD + d);
        const float4 qb =
            *reinterpret_cast<const float4*>(qh + g * HD + d + 4);
        dot[g] = fmaf(qa.x, kv[0], dot[g]);
        dot[g] = fmaf(qa.y, kv[1], dot[g]);
        dot[g] = fmaf(qa.z, kv[2], dot[g]);
        dot[g] = fmaf(qa.w, kv[3], dot[g]);
        dot[g] = fmaf(qb.x, kv[4], dot[g]);
        dot[g] = fmaf(qb.y, kv[5], dot[g]);
        dot[g] = fmaf(qb.z, kv[6], dot[g]);
        dot[g] = fmaf(qb.w, kv[7], dot[g]);
      }
    }

    // ---- online softmax over the tile (lanes j and j + 16 hold the same
    // position), P rounded to q's dtype
    float pr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float full = dot[g] + __shfl_xor_sync(0xffffffffu, dot[g], 16);
      const float s = valid ? full * hd_scale : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(s));
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);  // 0 when masked
      l[g] = l[g] * alpha + warp_sum(lane < 16 ? p : 0.f);
      m[g] = m_new;
      pr[g] = round_to<T>(p);
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[g][e] *= alpha;
    }

    // ---- acc += P . V (v dequantized to T), this lane's HD / 32 columns
    const P* vcol = reinterpret_cast<const P*>(st + S::kV) + lane * kCols;
#pragma unroll
    for (int jj = 0; jj < kTileP; ++jj) {
      float vv[kCols];
      load_elems<P, kCols>(vcol + jj * HD, vv);
      if (QUANT) {
        const float vsc = vsc_s[jj] * inv_max;
#pragma unroll
        for (int e = 0; e < kCols; ++e) vv[e] = round_to<T>(vv[e] * vsc);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(0xffffffffu, pr[g], jj);
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[g][e] = fmaf(pj, vv[e], acc[g][e]);
      }
    }
    __syncwarp();  // every lane is done with the stage
    issue(i + 2);
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
    if (n_chunks == 1) {
      o[i] = as / fmaxf(ls, 1e-30f);
    } else {
      part[acc_of_row + (size_t)c * G * HD + i] = as;
      if (d == 0) {
        part[ml_of_row + ((size_t)c * G + g) * 2] = mx;
        part[ml_of_row + ((size_t)c * G + g) * 2 + 1] = ls;
      }
    }
  }
  if (n_chunks == 1) return;

  // ---- the row's last chunk to arrive merges them all, in chunk order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + bn;
    const bool last = atomicAdd(cnt, 1) == n_chunks - 1;
    if (last) *cnt = 0;
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const float* pm = part + ml_of_row + 2 * g;
    const float* pa = part + acc_of_row + i;
    float mx = __ldcg(pm);
    for (int cc = 1; cc < n_chunks; ++cc)
      mx = fmaxf(mx, __ldcg(pm + (size_t)cc * G * 2));
    float ls = 0.f, as = 0.f;
    for (int cc = 0; cc < n_chunks; ++cc) {
      const float f = expf(__ldcg(pm + (size_t)cc * G * 2) - mx);
      ls += __ldcg(pm + (size_t)cc * G * 2 + 1) * f;
      as += __ldcg(pa + (size_t)cc * G * HD) * f;
    }
    o[i] = as / fmaxf(ls, 1e-30f);
  }
}

// Host side: pick the instance for (q dtype, page kind, head_dim, group).
struct Call {
  const void *q, *kp, *ks, *vp, *vs, *lengths, *tables;
  void *out, *part, *counters;
  int B, nkv, ps, mp;
  float hd_scale;
  cudaStream_t stream;
  bool smem_only;   // return the instance's shared bytes, launch nothing
};

constexpr int kNoInstance = -1;

template <typename T, typename P, int HD, int G>
int run(const Call& a) {
  auto kernel = paged_attention<T, P, HD, G>;
  constexpr int smem = Smem<P, HD, G>::kBytes;
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
  const dim3 grid((a.mp * a.ps + kChunk - 1) / kChunk, a.nkv, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<float*>(a.out),
      static_cast<const P*>(a.kp), static_cast<const float*>(a.ks),
      static_cast<const P*>(a.vp), static_cast<const float*>(a.vs),
      static_cast<const int32_t*>(a.lengths),
      static_cast<const int32_t*>(a.tables), static_cast<float*>(a.part),
      static_cast<int*>(a.counters), a.nkv, a.ps, a.mp, a.hd_scale);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int HD>
int by_group(int g, const Call& a) {
  if (g == 1) return run<T, P, HD, 1>(a);
  if (g == 2) return run<T, P, HD, 2>(a);
  if (g == 4) return run<T, P, HD, 4>(a);
  if (g == 8) return run<T, P, HD, 8>(a);
  return kNoInstance;
}

template <typename T, typename P>
int by_head_dim(int hd, int g, const Call& a) {
  if (hd == 64) return by_group<T, P, 64>(g, a);
  if (hd == 128) return by_group<T, P, 128>(g, a);
  return kNoInstance;
}

// pages: 0 = q's dtype, 1 = int8 with scales, 2 = fp8 e4m3
template <typename T>
int by_pages(int pages, int hd, int g, const Call& a) {
  if (pages == 1) return by_head_dim<T, int8_t>(hd, g, a);
  if (pages == 2) return by_head_dim<T, __nv_fp8_e4m3>(hd, g, a);
  if (pages == 0) return by_head_dim<T, T>(hd, g, a);
  return kNoInstance;
}

int dispatch(int dtype, int pages, int hd, int g, const Call& a) {
  if (dtype == 1) return by_pages<__nv_bfloat16>(pages, hd, g, a);
  return by_pages<float>(pages, hd, g, a);
}

}  // namespace onebit_paged

// q [B, nkv * g, hd] (dtype 0 = float32, 1 = bfloat16), out [B, nkv * g, hd]
// f32; the layer's pages k/v [P, nkv, ps, hd] in q's dtype (pages = 0),
// int8 with scales k_scales/v_scales [P, nkv, ps] f32 (pages = 1), or fp8
// e4m3 (pages = 2); the scales are null but for int8; lengths [B] and page_indices [B, mp] int32 on the device.
// `chunk` must be the kernel's chunk of positions
// (paged_attention_cuda.PAGED_CHUNK); `part` holds part_floats floats, at
// least B * nkv * ceil(mp * ps / chunk) * g * (hd + 2); `counters` B * nkv
// ints that are zero before the launch and after it. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int onebit_paged_attention(
    const void* q, void* out, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* lengths,
    const void* page_indices, void* part, void* counters, int B, int nkv,
    int g, int hd, int ps, int mp, int dtype, int pages, int chunk,
    long long part_floats, float hd_scale, void* stream) {
  using namespace onebit_paged;
  const long long need = (long long)B * nkv *
                         (((long long)mp * ps + kChunk - 1) / kChunk) * g *
                         (hd + 2);
  if (chunk != kChunk || part_floats < need || B < 1 || B > 65535 ||
      ps < 1 || mp < 1)
    return (int)cudaErrorInvalidValue;
  const Call a{q, k_pages, k_scales, v_pages, v_scales, lengths,
               page_indices, out, part, counters, B, nkv, ps, mp, hd_scale,
               static_cast<cudaStream_t>(stream), false};
  const int r = dispatch(dtype, pages, hd, g, a);
  return r == kNoInstance ? (int)cudaErrorInvalidValue : r;
}

// The dynamic shared bytes a CTA of the instance asks for (-1: no such
// instance).
extern "C" int onebit_paged_attention_smem_bytes(int dtype, int pages,
                                                 int hd, int g) {
  onebit_paged::Call a{};
  a.smem_only = true;
  return onebit_paged::dispatch(dtype, pages, hd, g, a);
}
