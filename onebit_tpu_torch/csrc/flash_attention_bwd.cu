// The backward of causal full-sequence attention: kernels B11-dkv and B11-dq
// of the port.
//
// Replace the two Pallas TPU kernels that the upstream flash attention's
// custom_vjp runs in JAX's backward pass of onebit_tpu/kernels/attention.py
// flash_causal_attention (jax/experimental/pallas/ops/tpu/flash_attention.py
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq). As B11's forward
// does, they work on the projections' own layout, with no repeat of K/V for
// GQA and no transpose:
//   q, do [B, S, nh, HD], k/v [B, S, nkv, HD] (T = float or bf16), read
//   through their batch and sequence strides (the [n, HD] of a row
//   contiguous); lse, di [B, nh, S] fp32 contiguous; dq [B, S, nh, HD],
//   dk/dv [B, S, nkv, HD] contiguous, in T.
//
// The function, per (row b, head h, query i, key j <= i), kv head h / G:
//   P_ij  = exp(q_i . k_j * scale - lse_i)   (the forward's probabilities,
//           recomputed from its log-sum-exp; fp32 dots of T operands)
//   dP_ij = do_i . v_j,  dS_ij = round_T(P_ij (dP_ij - di_i) scale),
//   di_i = o_i . do_i,
//   dv_j = sum_i round_T(P_ij) do_i,  dk_j = sum_i dS_ij q_i,
//   dq_i = sum_j dS_ij k_j,
// the sums over the query heads of kv head h / G included in dk and dv
// (JAX repeats K/V and sums the repeated gradients: the same arithmetic).
// P is rounded to T before the dv product, as the forward rounds it before
// the PV product, and dS, scaled, before the dk and dq products: the
// roundings of the TPU kernel, whose matrix unit takes bf16 operands as
// the tensor cores do (round_T is the identity for float). Keys above the
// diagonal have P = 0 and are skipped; every sum accumulates in fp32.
//
// Bound on an H100: operations. The backward's five products (S and dP
// recomputed or formed, dv, dk, dq) cost 2.5 times the forward's two, 10 *
// B * nh * HD * S(S+1)/2 flops: 344 GFLOP per layer at llama2-7b's training
// shape (4 x 2048 x 32 x 128). These kernels recompute S and dP once in
// each of the two kernels (7 products in all, 0.487 ms at the bf16 peak);
// one fused kernel would need dq by atomics, whose order changes the
// result from run to run.
//
// The bf16 instances (every KD step) run every product on the tensor cores
// through wgmma (sm_90a), one warpgroup (128 threads) a CTA:
//   * B11-dkv: one CTA per (key tile of 64, kv head, row), the tiles with
//     the most work (the first keys) launched first. K and V come in once
//     by TMA; the CTA walks the G query heads of the group and, for each,
//     the query tiles from its diagonal to S, so GQA needs no atomics. Q and
//     dO tiles come by TMA through a ring of two stages, the tile's 64 lse
//     and di beside them by cp.async, all counted on the stage's mbarrier:
//     the next tile is in flight during this tile's four products, and the
//     loop has no block barrier. The four products read each operand's
//     natural [rows, HD] tile, nothing transposed in memory: Sᵀ = K Qᵀ and
//     dPᵀ = V dOᵀ with both operands in shared memory, K-major; Pᵀ =
//     exp2(Sᵀ scale log2(e) - lse log2(e)) and scale dSᵀ, converted to bf16
//     in registers, are the A operands of dV += Pᵀ dO and dK += dSᵀ Q,
//     whose B (dO, Q) is read as an MN-major operand (the descriptor's
//     transpose bit). dK and dV stay in fp32 registers for the whole walk
//     (128 a thread at HD 128) and are written once;
//   * B11-dq: one CTA per (query tile of 64, head, row), longest rows
//     first. Q and dO come in once by TMA, K and V tiles through a ring of
//     two stages up to the diagonal. S = Q Kᵀ and dP = dO Vᵀ in shared
//     memory, then dQ += (scale dS) K with dS as the register A operand and
//     K as an MN-major B; dQ stays in fp32 registers and is written once;
//   * query rows past S arrive as zeros (TMA) and are masked, as are keys
//     above the diagonal inside the diagonal tile (in B11-dkv the
//     accumulator's rows are keys and its columns queries).
// What holds them back (PERF.md): each tile runs its products and the
// exponentials between them one after another inside its warpgroup, and
// two CTAs an SM fill only part of the gaps; S and dP are formed in both
// kernels.
// The fp32 instances (the fp32 KD step, held to 1e-4 of the plain fp32
// gradients) run every product on the bf16 tensor cores too, on operands
// split into three bf16 parts in the kernel, as B11's fp32 forward does
// (flash_attention.cu; the split pieces in flash_attention_common.cuh):
//   * each fp32 product (B11-dkv: Sᵀ, dPᵀ, dV, dK; B11-dq: S, dP, dQ) is
//     six bf16 products, hi hi apart from the five small ones (mid mid, hi
//     lo, lo hi, hi mid, mid hi), the two sums joined on the CUDA cores
//     (the tensor cores' fp32 sums round toward zero). Fewer fail: three
//     drop v's and do's low parts from dP, and through di = Σ o·do that
//     leaves gradient errors past 1e-4 where the gradient is zero (S = 1;
//     tests/test_torch_flash_bwd_design.py). P and dS stay unrounded fp32
//     and are split in registers into the A fragments of dV, dK and dQ;
//   * each query tile's dV and dK (B11-dkv), each key tile's dQ (B11-dq),
//     sums afresh and joins the running fp32 sum on the CUDA cores, so the
//     error does not grow with the walk (up to 32 query tiles x G heads):
//     the five small products' sum first, then hi hi's, in the same 32
//     registers (both fresh sums at once beside B11-dkv's running dV or dK
//     spilled at 255 registers);
//   * two warpgroups a CTA (256 threads), the grids of the bf16 instances
//     (B11-dkv one CTA per key tile, kv head and row, walking the group's
//     query heads, no atomics; B11-dq one per query tile, head and row,
//     longest rows first). All 256 threads split the walked tiles (16-byte
//     loads, 128-byte swizzled part tiles: fp32 is not TMA-loadable as
//     parts); then warpgroup 0 forms S (Sᵀ) and P while warpgroup 1 forms
//     dP (dPᵀ) on the tensor cores at the same time, the two accumulator
//     fragments alike, so P (B11-dkv) or P and then dS (B11-dq) cross
//     between them element for element through 16 KB of shared memory.
//     B11-dkv: warpgroup 0 sums dV, warpgroup 1 dK, each for the whole
//     walk in registers (64 floats a thread at HD 128); B11-dq: each
//     warpgroup sums 64 of dQ's columns (at HD 64, warpgroup 0 all);
//   * the parts of four 64-row tiles stay in shared memory (B11-dkv: K and
//     V once, Q and dO a step; B11-dq: Q and dO once, K and V a step), 192
//     KB at HD 128, with the exchange, the stats and alignment 214,528
//     bytes: one CTA an SM, and no room for a second stage, so the split of
//     the next tile waits for this tile's products. 254 (B11-dkv) and 204
//     (B11-dq) registers at HD 128, no spills.
// Their bound is six bf16 products an fp32 product at the tensor cores'
// peak (B11-dkv 1.668 ms, B11-dq 1.251 at the training shape); the first
// version's, on the CUDA cores' fp32 FMA, was 4.105 and 3.078 ms. What
// holds them back (PERF.md): each step's split runs on every thread while
// the tensor cores wait, and so do the exponentials and the exchange.
#include <math.h>

#include "flash_attention_common.cuh"
#include "wgmma_common.cuh"

namespace onebit_flash {

// ---- the bf16 instances: wgmma on the tensor cores ----

using bf16 = __nv_bfloat16;
using namespace onebit_sm90;

// Shared memory of both bf16 kernels: six 64-row tiles (the two staged
// once, then a ring of two stages of two tiles each), 128 floats per stage
// (B11-dkv's lse and di), three mbarriers, + alignment.
template <int HD>
struct BwdLayout {
  static constexpr int kStats = 6 * WgTile<HD>::kBytes;   // offset
  static constexpr int kBars = kStats + 2 * 2 * kTile * 4;
  static constexpr int kBytes = kBars + 3 * 8 + 1024;
};

// The bf16 stores of rows r0 + row and r0 + row + 8 (those below S) of a
// 64 x HD accumulator fragment to the [B, S, n, HD] tensor out at head n.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, const float (&d)[HD / 2],
                                           int b, int S, int nheads, int n,
                                           int r0, int row, int col) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + row + 8 * r;
    if (i >= S) continue;
    bf16* o = out + (((size_t)b * S + i) * nheads + n) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(o + 8 * c + col) =
          bf16_pair(d[4 * c + 2 * r], d[4 * c + 2 * r + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int nh, int G,
                    float scale) {
  using L = BwdLayout<HD>;
  constexpr int TB = WgTile<HD>::kBytes;
  constexpr int KS = HD / 16;   // k16 steps of Sᵀ and dPᵀ
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u, vs = ks + TB;
  // stage s: Q at ks + (2 + 2s) TB, dO after it, lse and di at
  // stats[128 s..], its mbarrier at bar_st(s)
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (ks - raw) + L::kStats);
  const uint32_t bar_kv = ks + L::kBars;
  auto qslot = [&](int s) { return ks + (2 + 2 * s) * TB; };
  auto bar_st = [&](int s) { return bar_kv + 8 + 8 * s; };

  const int tid = threadIdx.x, lane = tid & 31;
  const int row = (tid >> 5) * 16 + (lane >> 2);   // key rows, and row + 8
  const int col = 2 * (lane & 3);                  // query columns
  const int kt = blockIdx.x;          // the first keys have the most work
  const int hk = blockIdx.y, b = blockIdx.z, nkv = gridDim.y;
  const int k0 = kt * kTile, nq = (S + kTile - 1) / kTile;
  const int per_head = nq - kt, steps = G * per_head;
  const float scale2 = scale * kLog2e;

  // Step it of the walk: query tile kt + it % per_head of head
  // hk G + it / per_head into stage it & 1. Thread 0 issues Q and dO by
  // TMA; every thread copies one of the 64 lse or di values (zeros past
  // S) and arrives when it is in.
  auto issue = [&](int it) {
    const int s = it & 1, h = hk * G + it / per_head;
    const int q0 = (kt + it % per_head) * kTile;
    if (tid == 0) {
      tma_tile<HD>(qslot(s), &qmap, bar_st(s), h, q0, b);
      tma_tile<HD>(qslot(s) + TB, &omap, bar_st(s), h, q0, b);
    }
    const int r = q0 + (tid & (kTile - 1));
    const float* src = (tid < kTile ? lse : di) + ((size_t)b * nh + h) * S +
                       min(r, S - 1);
    cp_async4(ks + L::kStats + (s * 2 * kTile + tid) * 4, src, r < S);
    mbar_arrive_cp_async(bar_st(s));
  };

  if (tid == 0) {
    // K and V: two arrivals; a stage: Q and dO, and every thread's copy
    mbar_init(bar_kv, 2);
    mbar_init(bar_st(0), 2 + kWgThreads);
    mbar_init(bar_st(1), 2 + kWgThreads);
    mbar_init_fence();
    tma_tile<HD>(ks, &kmap, bar_kv, hk, k0, b);
    tma_tile<HD>(vs, &vmap, bar_kv, hk, k0, b);
  }
  __syncthreads();   // the inits, before any thread arrives
  issue(0);
  if (steps > 1) issue(1);
  mbar_wait(bar_kv, 0);

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int s = it & 1, qt = kt + it % per_head, q0 = qt * kTile;
    const uint32_t qs = qslot(s), os = qs + TB;
    const float* Ls = stats + s * 2 * kTile;
    const float* Ds = Ls + kTile;
    mbar_wait(bar_st(s), (it >> 1) & 1);

    // ---- 1-2. Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (keys x queries, fp32)
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    // the zeros in place before the fence (else ptxas sets them between
    // the two products and injects a wait there)
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(st, kmajor_desc<HD>(ks, kk), kmajor_desc<HD>(qs, kk));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dpt, kmajor_desc<HD>(vs, kk), kmajor_desc<HD>(os, kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // Pᵀ from the forward's log-sum-exp, in base 2; zero above the
    // diagonal (j > i, only in the diagonal tile) and on query rows past S
    // (only in the last tile)
    const bool diag = qt == kt, tail = q0 + kTile > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i / 4) + col + (i & 1);
      const int kr = row + 8 * ((i >> 1) & 1);
      const float p = exp2f(fmaf(st[i], scale2, -Ls[qc] * kLog2e));
      st[i] = (diag && kr > qc) || (tail && q0 + qc >= S) ? 0.f : p;
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    // scale dSᵀ = scale Pᵀ (dPᵀ - di), rounded to bf16 below (as the TPU
    // kernel rounds it)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i / 4) + col + (i & 1);
      dpt[i] = (dpt[i] - Ds[qc]) * st[i] * scale;
    }

    // ---- 3-4. dV += round(Pᵀ) dO, dK += round(scale dSᵀ) Q (k = queries)
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, st);
    pack_a(da, dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_mn<HD>(dva, pa[kk], mn_desc<HD>(os, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_mn<HD>(dka, da[kk], mn_desc<HD>(qs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    // the stage is free: the warpgroup's products that read it are done
    if (it + 2 < steps) issue(it + 2);
  }

  store_rows<HD>(dv, dva, b, S, nkv, hk, k0, row, col);
  store_rows<HD>(dk, dka, b, S, nkv, hk, k0, row, col);
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, bf16* __restrict__ dq,
                   int S, int nh, int G, float scale) {
  using L = BwdLayout<HD>;
  constexpr int TB = WgTile<HD>::kBytes;
  constexpr int KS = HD / 16;   // k16 steps of S and dP
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u, os = qs + TB;
  // stage s: K at qs + (2 + 2s) TB, V after it, its mbarrier at bar_st(s)
  const uint32_t bar_q = qs + L::kBars;
  auto kslot = [&](int s) { return qs + (2 + 2 * s) * TB; };
  auto bar_st = [&](int s) { return bar_q + 8 + 8 * s; };

  const int tid = threadIdx.x, lane = tid & 31;
  const int row = (tid >> 5) * 16 + (lane >> 2);   // query rows, and + 8
  const int col = 2 * (lane & 3);                  // key columns
  const int qt = gridDim.x - 1 - blockIdx.x;       // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qt * kTile;
  const float scale2 = scale * kLog2e;

  // key tile kt into stage kt & 1 (thread 0, by TMA)
  auto issue = [&](int kt) {
    tma_tile<HD>(kslot(kt & 1), &kmap, bar_st(kt & 1), hk, kt * kTile, b);
    tma_tile<HD>(kslot(kt & 1) + TB, &vmap, bar_st(kt & 1), hk, kt * kTile,
                 b);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar_q + 8 * i, 2);
    mbar_init_fence();
    tma_tile<HD>(qs, &qmap, bar_q, h, q0, b);
    tma_tile<HD>(os, &omap, bar_q, h, q0, b);
    issue(0);
    if (qt > 0) issue(1);
  }
  __syncthreads();
  // the rows' lse (times log2(e)) and di; rows past S are never stored
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + row + 8 * r;
    const size_t off = ((size_t)b * nh + h) * S + min(i, S - 1);
    lr[r] = lse[off] * kLog2e;
    dr[r] = di[off];
  }
  mbar_wait(bar_q, 0);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const uint32_t kslt = kslot(kt & 1), vslt = kslt + TB;
    mbar_wait(bar_st(kt & 1), (kt >> 1) & 1);

    // ---- 1-2. S = Q Kᵀ and dP = dO Vᵀ (queries x keys, fp32)
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(sc, kmajor_desc<HD>(qs, kk), kmajor_desc<HD>(kslt, kk));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dp, kmajor_desc<HD>(os, kk), kmajor_desc<HD>(vslt, kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P from the forward's log-sum-exp, zero above the diagonal (only in
    // the diagonal tile)
    const bool diag = kt == qt;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kc = 8 * (i / 4) + col + (i & 1);
      const int qr = row + 8 * ((i >> 1) & 1);
      const float p = exp2f(fmaf(sc[i], scale2, -lr[(i >> 1) & 1]));
      sc[i] = diag && kc > qr ? 0.f : p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = (dp[i] - dr[(i >> 1) & 1]) * sc[i] * scale;

    // ---- 3. dQ += round(scale dS) K (k = keys)
    uint32_t da[4][4];
    pack_a(da, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_mn<HD>(acc, da[kk], mn_desc<HD>(kslt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // the stage is free: the warpgroup's products that read it are done
    if (tid == 0 && kt + 2 <= qt) issue(kt + 2);
  }

  store_rows<HD>(dq, acc, b, S, nh, h, q0, row, col);
}

// ---- the fp32 instances: split operands on the bf16 tensor cores ----

constexpr int kSplitThreads = 2 * kWgThreads;   // two warpgroups

// Shared memory of both fp32 kernels: the three bf16 parts of four 64-row
// tiles, the exchange between the warpgroups (32 floats for each thread of
// one warpgroup), the query tile's lse and di (B11-dkv), + alignment.
template <int HD>
struct SplitBwdLayout {
  static constexpr int kXch = 12 * WgTile<HD>::kBytes;   // offsets
  static constexpr int kStats = kXch + kWgThreads * 32 * 4;
  static constexpr int kBytes = kStats + 2 * kTile * 4 + 1024;
};

// acc (64 x 64, fp32) += A B on one warpgroup: A's three parts as register
// fragments a[p] (k = 64: four k16 steps), B the 64 columns of block blk of
// three part tiles at b + p TB ([64 k rows, HD], read MN-major). The five
// small products sum afresh and join acc on the CUDA cores, then hi hi
// does the same in the same 32 registers (two fresh sums at once, beside
// B11-dkv's running dV or dK, would not fit in 255 registers).
template <int HD>
__device__ __forceinline__ void split_product_rs(float (&acc)[32],
                                                 const uint32_t (&a)[3][4][4],
                                                 uint32_t b, int blk) {
  constexpr int TB = WgTile<HD>::kBytes;
  float d[32];
  auto part = [&](int ap, int bp) {   // A part ap times B part bp
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64<1>(d, a[ap][kk],
                      mn_desc<HD>(b + bp * TB + blk * WgTile<HD>::kBlock, kk));
  };
  auto fresh = [&] {
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    fence_regs(d);
    wgmma_fence();
  };
  auto join = [&] {
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += d[i];
  };
  fresh();
  part(1, 1);   // smallest first, as in split_product_ss
  part(0, 2);
  part(2, 0);
  part(0, 1);
  part(1, 0);
  join();
  fresh();
  part(0, 0);
  join();
}

// The fp32 stores of rows r0 + row and r0 + row + 8 (those below S) of a
// 64 x 64 accumulator fragment to columns [c0, c0 + 64) of the [B, S,
// nheads, HD] tensor out at head n.
template <int HD>
__device__ __forceinline__ void store_block(float* out, const float (&d)[32],
                                            int b, int S, int nheads, int n,
                                            int c0, int r0, int row,
                                            int col) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + row + 8 * r;
    if (i >= S) continue;
    float* o = out + (((size_t)b * S + i) * nheads + n) * HD + c0;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<float2*>(o + 8 * c + col) =
          make_float2(d[4 * c + 2 * r], d[4 * c + 2 * r + 1]);
  }
}

// This thread's 32 floats of a 64 x 64 fragment to (put) or from (take)
// the exchange: float4 j of thread t at xch[j * 128 + t], so both
// warpgroups' thread t meet on the same (row, column) elements.
__device__ __forceinline__ void xch_put(float4* xch, int t,
                                        const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    xch[j * kWgThreads + t] =
        make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
}
__device__ __forceinline__ void xch_take(const float4* xch, int t,
                                         float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = xch[j * kWgThreads + t];
    x[4 * j] = v.x;
    x[4 * j + 1] = v.y;
    x[4 * j + 2] = v.z;
    x[4 * j + 3] = v.w;
  }
}

template <int HD>
__global__ void __launch_bounds__(kSplitThreads, 1)
flash_bwd_dkv_split(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dk,
                    float* __restrict__ dv, int S, int nh, int G,
                    long long q_sb, long long q_ss, long long k_sb,
                    long long k_ss, long long v_sb, long long v_ss,
                    long long o_sb, long long o_ss, float scale) {
  using L = SplitBwdLayout<HD>;
  constexpr int TB = WgTile<HD>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  // the parts of K, V, Q and dO, three tiles each
  const uint32_t ks = (raw + 1023) & ~1023u, vs = ks + 3 * TB;
  const uint32_t qs = ks + 6 * TB, os = ks + 9 * TB;
  uint8_t* aligned = smem_raw + (ks - raw);
  float4* xch = reinterpret_cast<float4*>(aligned + L::kXch);
  float* stats = reinterpret_cast<float*>(aligned + L::kStats);  // lse, di

  const int tid = threadIdx.x, wg = tid / kWgThreads;
  const int t = tid % kWgThreads, lane = tid & 31;
  const int row = (t >> 5) * 16 + (lane >> 2);   // key rows, and row + 8
  const int col = 2 * (lane & 3);                // query columns
  const int kt = blockIdx.x;          // the first keys have the most work
  const int hk = blockIdx.y, b = blockIdx.z, nkv = gridDim.y;
  const int k0 = kt * kTile, nq = (S + kTile - 1) / kTile;
  const int per_head = nq - kt, steps = G * per_head;

  split_tile<HD, 3, kSplitThreads>(ks, k + b * k_sb + (long long)hk * HD,
                                   k_ss, k0, S);
  split_tile<HD, 3, kSplitThreads>(vs, v + b * v_sb + (long long)hk * HD,
                                   v_ss, k0, S);

  // warpgroup 0 sums dV, warpgroup 1 dK, 64 columns a block
  float acc[HD / 64][32];
#pragma unroll
  for (int c = 0; c < HD / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int h = hk * G + it / per_head, qt = kt + it % per_head;
    const int q0 = qt * kTile;
    // the last step's products are done with Q's and dO's parts, the
    // exchange and the stats
    __syncthreads();
    split_tile<HD, 3, kSplitThreads>(qs, q + b * q_sb + (long long)h * HD,
                                     q_ss, q0, S);
    split_tile<HD, 3, kSplitThreads>(
        os, dout + b * o_sb + (long long)h * HD, o_ss, q0, S);
    if (tid < 2 * kTile) {   // the query rows' lse, then their di
      const int r = q0 + (tid & (kTile - 1));
      stats[tid] = r < S ? (tid < kTile ? lse : di)[((size_t)b * nh + h) * S +
                                                    r]
                         : 0.f;
    }
    fence_proxy_async();
    __syncthreads();

    // ---- 1. warpgroup 0: Sᵀ = K Qᵀ, warpgroup 1: dPᵀ = V dOᵀ (keys x
    // queries, fp32)
    float x[32];
    split_product_ss<HD>(x, wg == 0 ? ks : vs, wg == 0 ? qs : os);
    const bool diag = qt == kt, tail = q0 + kTile > S;
    if (wg == 0) {
      // Pᵀ from the forward's log-sum-exp; zero above the diagonal (j > i,
      // only in the diagonal tile) and on query rows past S (the last tile)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i / 4) + col + (i & 1);
        const int kr = row + 8 * ((i >> 1) & 1);
        const float p = expf(fmaf(x[i], scale, -stats[qc]));
        x[i] = (diag && kr > qc) || (tail && q0 + qc >= S) ? 0.f : p;
      }
      xch_put(xch, t, x);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        x[i] -= stats[kTile + 8 * (i / 4) + col + (i & 1)];
    }
    __syncthreads();
    if (wg == 1) {   // scale dSᵀ = scale Pᵀ (dPᵀ - di)
      float p[32];
      xch_take(xch, t, p);
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = x[i] * p[i] * scale;
    }

    // ---- 2. warpgroup 0: dV += Pᵀ dO, warpgroup 1: dK += (scale dSᵀ) Q
    // (k = queries): this tile's product afresh, joined in fp32
    uint32_t xa[3][4][4];
    split_a(xa, x);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c)
      split_product_rs<HD>(acc[c], xa, wg == 0 ? os : qs, c);
  }

#pragma unroll
  for (int c = 0; c < HD / 64; ++c)
    store_block<HD>(wg == 0 ? dv : dk, acc[c], b, S, nkv, hk, 64 * c, k0, row,
                    col);
}

template <int HD>
__global__ void __launch_bounds__(kSplitThreads, 1)
flash_bwd_dq_split(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, float* __restrict__ dq,
                   int S, int nh, int G, long long q_sb, long long q_ss,
                   long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, long long o_sb, long long o_ss,
                   float scale) {
  using L = SplitBwdLayout<HD>;
  constexpr int TB = WgTile<HD>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  // the parts of Q, dO, K and V, three tiles each
  const uint32_t qs = (raw + 1023) & ~1023u, os = qs + 3 * TB;
  const uint32_t ks = qs + 6 * TB, vs = qs + 9 * TB;
  float4* xch = reinterpret_cast<float4*>(smem_raw + (qs - raw) + L::kXch);

  const int tid = threadIdx.x, wg = tid / kWgThreads;
  const int t = tid % kWgThreads, lane = tid & 31;
  const int row = (t >> 5) * 16 + (lane >> 2);   // query rows, and + 8
  const int col = 2 * (lane & 3);                // key columns
  const int qt = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qt * kTile;
  const bool owns = wg < HD / 64;   // dQ's columns [64 wg, 64 wg + 64)

  split_tile<HD, 3, kSplitThreads>(qs, q + b * q_sb + (long long)h * HD,
                                   q_ss, q0, S);
  split_tile<HD, 3, kSplitThreads>(os, dout + b * o_sb + (long long)h * HD,
                                   o_ss, q0, S);
  // the rows' lse (warpgroup 0) or di (warpgroup 1); rows past S are never
  // stored
  float stat[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    stat[r] = (wg == 0 ? lse : di)[((size_t)b * nh + h) * S +
                                   min(q0 + row + 8 * r, S - 1)];

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const float* kb = k + b * k_sb + (long long)hk * HD;
  const float* vb = v + b * v_sb + (long long)hk * HD;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    // the last tile's products are done with K's and V's parts and the
    // exchange
    __syncthreads();
    split_tile<HD, 3, kSplitThreads>(ks, kb, k_ss, k0, S);
    split_tile<HD, 3, kSplitThreads>(vs, vb, v_ss, k0, S);
    fence_proxy_async();
    __syncthreads();

    // ---- 1. warpgroup 0: S = Q Kᵀ, warpgroup 1: dP = dO Vᵀ (queries x
    // keys, fp32)
    float x[32];
    split_product_ss<HD>(x, wg == 0 ? qs : os, wg == 0 ? ks : vs);
    if (wg == 0) {
      // P from the forward's log-sum-exp, zero above the diagonal (only in
      // the diagonal tile)
      const bool diag = kt == qt;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kc = 8 * (i / 4) + col + (i & 1);
        const int qr = row + 8 * ((i >> 1) & 1);
        const float p = expf(fmaf(x[i], scale, -stat[(i >> 1) & 1]));
        x[i] = diag && kc > qr ? 0.f : p;
      }
      xch_put(xch, t, x);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] -= stat[(i >> 1) & 1];
    }
    __syncthreads();
    if (wg == 1) {   // scale dS = scale P (dP - di), and back to warpgroup 0
      float p[32];
      xch_take(xch, t, p);
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = x[i] * p[i] * scale;
      xch_put(xch, t, x);
    }
    __syncthreads();
    if (wg == 0) xch_take(xch, t, x);

    // ---- 2. dQ += (scale dS) K over this warpgroup's 64 columns (k =
    // keys): this tile's product afresh, joined in fp32
    if (owns) {
      uint32_t xa[3][4][4];
      split_a(xa, x);
      split_product_rs<HD>(acc, xa, ks, wg);
    }
  }

  if (owns) store_block<HD>(dq, acc, b, S, nh, h, 64 * wg, q0, row, col);
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *dq, *dk, *dv;
  int B, S, nh, nkv;
  long long strides[8];  // q, k, v, do: batch then sequence stride each
  float scale;
  cudaStream_t st;
};

// The bf16 instances: q, k, v and do as [B, S, n, HD] tensor maps.
template <int HD>
int run_wgmma(int which, const BwdArgs& a) {
  constexpr int smem = BwdLayout<HD>::kBytes;
  cudaError_t e = which == 0
      ? cudaFuncSetAttribute(flash_bwd_dkv_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem)
      : cudaFuncSetAttribute(flash_bwd_dq_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap m[4];
  const void* bases[4] = {a.q, a.k, a.v, a.dout};
  const int heads[4] = {a.nh, a.nkv, a.nkv, a.nh};
  for (int i = 0; i < 4; ++i)
    if (!make_rows_map(&m[i], bases[i], a.B, a.S, heads[i], HD,
                       a.strides[2 * i], a.strides[2 * i + 1]))
      return (int)cudaErrorInvalidValue;
  const int nt = (a.S + kTile - 1) / kTile, G = a.nh / a.nkv;
  if (which == 0)
    flash_bwd_dkv_wgmma<HD><<<dim3(nt, a.nkv, a.B), kWgThreads, smem,
                              a.st>>>(
        m[0], m[1], m[2], m[3], a.lse, a.di, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.S, a.nh, G, a.scale);
  else
    flash_bwd_dq_wgmma<HD><<<dim3(nt, a.nh, a.B), kWgThreads, smem, a.st>>>(
        m[0], m[1], m[2], m[3], a.lse, a.di, static_cast<bf16*>(a.dq), a.S,
        a.nh, G, a.scale);
  return (int)cudaGetLastError();
}

// The fp32 instances: q, k, v and do read as fp32 rows and split in the
// kernel.
template <int HD>
int run_split(int which, const BwdArgs& a) {
  constexpr int smem = SplitBwdLayout<HD>::kBytes;
  cudaError_t e = which == 0
      ? cudaFuncSetAttribute(flash_bwd_dkv_split<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem)
      : cudaFuncSetAttribute(flash_bwd_dq_split<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return (int)e;
  const long long* s = a.strides;
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *o = static_cast<const float*>(a.dout);
  const int nt = (a.S + kTile - 1) / kTile, G = a.nh / a.nkv;
  if (which == 0)
    flash_bwd_dkv_split<HD><<<dim3(nt, a.nkv, a.B), kSplitThreads, smem,
                              a.st>>>(
        q, k, v, o, a.lse, a.di, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.S, a.nh, G, s[0], s[1], s[2], s[3],
        s[4], s[5], s[6], s[7], a.scale);
  else
    flash_bwd_dq_split<HD><<<dim3(nt, a.nh, a.B), kSplitThreads, smem,
                             a.st>>>(
        q, k, v, o, a.lse, a.di, static_cast<float*>(a.dq), a.S, a.nh, G,
        s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int run(int which, int dtype, const BwdArgs& a) {
  return dtype == 1 ? run_wgmma<HD>(which, a) : run_split<HD>(which, a);
}

int launch(int which, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* di, void* dq,
           void* dk, void* dv, int B, int S, int nh, int nkv, int hd,
           const long long* strides, int dtype, float scale, void* stream) {
  if (B < 1 || S < 1 || nkv < 1 || nh % nkv)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(di), dq, dk, dv, B, S, nh, nkv, {},
            scale, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 8; ++i) a.strides[i] = strides[i];
  if (hd == 64) return run<64>(which, dtype, a);
  if (hd == 128) return run<128>(which, dtype, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace onebit_flash

// q, do [B, S, nh, hd], k/v [B, S, nkv, hd] in one dtype (0 = float32,
// 1 = bfloat16), each row's [n, hd] contiguous, at batch and sequence
// strides (in elements) q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss (o:
// do); lse and di [B, nh, S] fp32 contiguous; nh a multiple of nkv; hd 64
// or 128. B11-dkv writes dk, dv [B, S, nkv, hd] contiguous in the dtype;
// B11-dq writes dq [B, S, nh, hd]. Each returns cudaGetLastError() after
// its launch (0 on success).
extern "C" int onebit_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, int B, int S, int nh,
    int nkv, int hd, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, long long o_sb,
    long long o_ss, int dtype, float scale, void* stream) {
  const long long strides[8] = {q_sb, q_ss, k_sb, k_ss,
                                v_sb, v_ss, o_sb, o_ss};
  return onebit_flash::launch(0, q, k, v, dout, lse, di, nullptr, dk, dv, B,
                              S, nh, nkv, hd, strides, dtype, scale, stream);
}

extern "C" int onebit_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, int B, int S, int nh, int nkv,
    int hd, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    int dtype, float scale, void* stream) {
  const long long strides[8] = {q_sb, q_ss, k_sb, k_ss,
                                v_sb, v_ss, o_sb, o_ss};
  return onebit_flash::launch(1, q, k, v, dout, lse, di, dq, nullptr,
                              nullptr, B, S, nh, nkv, hd, strides, dtype,
                              scale, stream);
}

// Dynamic shared memory of one CTA of B11-dkv (which 0) or B11-dq (1) at
// hd 64 or 128 in dtype 0 (float32) or 1 (bfloat16), in bytes; 0 for
// anything else.
extern "C" int onebit_flash_bwd_smem_bytes(int which, int hd, int dtype) {
  using namespace onebit_flash;
  if ((hd != 64 && hd != 128) || (which != 0 && which != 1)) return 0;
  if (dtype == 1)
    return hd == 64 ? BwdLayout<64>::kBytes : BwdLayout<128>::kBytes;
  return hd == 64 ? SplitBwdLayout<64>::kBytes : SplitBwdLayout<128>::kBytes;
}
