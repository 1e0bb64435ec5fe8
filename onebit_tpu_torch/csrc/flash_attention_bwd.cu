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
// The fp32 instances run on the CUDA cores' fp32 FMA (the bound is the
// 67 TFLOP/s fp32 peak) and keep dS in fp32:
//   * B11-dkv: one CTA of 256 threads per (key tile of 64, kv head, row),
//     the first keys first, K and V in shared memory, walking the query
//     heads of the group and their query tiles as the bf16 instance does.
//     Thread (ty, tx) forms the transposed scores of key rows ty + 16a and
//     query columns tx + 16c (a, c < 4), writes P and dS transposed to
//     shared memory, then owns dk and dv rows ty + 16a, columns 64n +
//     4tx.. +3, in registers for the whole walk;
//   * B11-dq: one CTA per (query tile of 64, head, row), longest first,
//     walking the key tiles up to the diagonal; dS goes over the V tile in
//     shared memory, and dq accumulates in registers;
//   * rows past S load as zeros, are masked, and are never stored; every
//     global offset is 64-bit.
#include <math.h>

#include <type_traits>

#include "flash_attention_common.cuh"
#include "wgmma_common.cuh"

namespace onebit_flash {

constexpr int kBwdThreads = kThreads;

template <int HD>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO padded; P and dS transposed [key][query]; lse and di
  return (size_t)(4 * kTile * (HD + kPad) + 2 * kTile * (kTile + kPad) +
                  2 * kTile) * sizeof(float);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V padded (dS over V); lse and di
  return (size_t)(4 * kTile * (HD + kPad) + 2 * kTile) * sizeof(float);
}

// lse and di of the query rows [r0, r0 + kTile) of one (row, head): zeros
// past S.
__device__ __forceinline__ void load_row_stats(float* Ls, float* Ds,
                                               const float* lse,
                                               const float* di,
                                               size_t base, int r0, int S) {
  const int t = threadIdx.x;
  if (t < kTile) {
    Ls[t] = r0 + t < S ? lse[base + r0 + t] : 0.f;
  } else if (t < 2 * kTile) {
    Ds[t - kTile] = r0 + t - kTile < S ? di[base + r0 + t - kTile] : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              T* __restrict__ dk, T* __restrict__ dv, int S, int nh, int G,
              long long q_sb, long long q_ss, long long k_sb, long long k_ss,
              long long v_sb, long long v_ss, long long o_sb, long long o_ss,
              float scale) {
  constexpr int LDK = HD + kPad;
  constexpr int LDP = kTile + kPad;
  constexpr int NC = HD / 64;
  static_assert(HD % 64 == 0, "head_dim");

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * LDK;
  float* Qs = Vs + kTile * LDK;
  float* Os = Qs + kTile * LDK;       // dO
  float* Pt = Os + kTile * LDK;       // [key][query], rounded to T
  float* dSt = Pt + kTile * LDP;      // dS, [key][query]
  float* Ls = dSt + kTile * LDP;
  float* Ds = Ls + kTile;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kt = blockIdx.x;          // the first keys have the most work
  const int hk = blockIdx.y, b = blockIdx.z, nkv = gridDim.y;
  const int k0 = kt * kTile, nq = (S + kTile - 1) / kTile;

  load_tile<T, HD>(Ks, LDK, k + b * k_sb + (long long)hk * HD, k_ss, k0, S);
  load_tile<T, HD>(Vs, LDK, v + b * v_sb + (long long)hk * HD, v_ss, k0, S);

  float acc_v[4][NC][4] = {}, acc_k[4][NC][4] = {};
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const T* qb = q + b * q_sb + (long long)h * HD;
    const T* ob = dout + b * o_sb + (long long)h * HD;
    const size_t sb = ((size_t)b * nh + h) * S;
    for (int qt = kt; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      load_tile<T, HD>(Qs, LDK, qb, q_ss, q0, S);
      load_tile<T, HD>(Os, LDK, ob, o_ss, q0, S);
      load_row_stats(Ls, Ds, lse, di, sb, q0, S);
      __syncthreads();

      // ---- transposed scores and dP of key rows ty + 16a, query cols
      // tx + 16c
      float st[4][4] = {}, dpt[4][4] = {};
      dot_4x4<HD>(st, Ks, Qs, LDK, ty, tx);
      dot_4x4<HD>(dpt, Vs, Os, LDK, ty, tx);
      const bool diag = qt == kt;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jl = ty + 16 * a, il = tx + 16 * c;
          const bool masked = (diag && jl > il) || q0 + il >= S;
          const float p = masked ? 0.f : expf(st[a][c] * scale - Ls[il]);
          Pt[jl * LDP + il] = round_to<T>(p);
          dSt[jl * LDP + il] = p * (dpt[a][c] - Ds[il]);
        }
      __syncthreads();

      // ---- dv += P^T . dO, dk += dS^T . Q (scaled at the end)
      matmul_rows<HD>(acc_v, Pt, LDP, Os, LDK, ty, tx);
      matmul_rows<HD>(acc_k, dSt, LDP, Qs, LDK, ty, tx);
      __syncthreads();   // before the next tile's loads overwrite Q and dO
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= S) continue;
    const size_t off = (((size_t)b * S + j) * nkv + hk) * HD;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      Convert<T>::store4(dv + off + n * 64 + tx * 4,
                         make_float4(acc_v[a][n][0], acc_v[a][n][1],
                                     acc_v[a][n][2], acc_v[a][n][3]));
      Convert<T>::store4(dk + off + n * 64 + tx * 4,
                         make_float4(acc_k[a][n][0] * scale,
                                     acc_k[a][n][1] * scale,
                                     acc_k[a][n][2] * scale,
                                     acc_k[a][n][3] * scale));
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             T* __restrict__ dq, int S, int nh, int G, long long q_sb,
             long long q_ss, long long k_sb, long long k_ss, long long v_sb,
             long long v_ss, long long o_sb, long long o_ss, float scale) {
  constexpr int LDK = HD + kPad;
  constexpr int LDP = kTile + kPad;
  constexpr int NC = HD / 64;
  static_assert(HD % 64 == 0, "head_dim");
  static_assert(LDP <= LDK, "dS fits over V");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + kTile * LDK;       // dO
  float* Ks = Os + kTile * LDK;
  float* Vs = Ks + kTile * LDK;
  float* Ss = Vs;                     // dS [query][key], over V once used
  float* Ls = Vs + kTile * LDK;
  float* Ds = Ls + kTile;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qt * kTile;

  load_tile<T, HD>(Qs, LDK, q + b * q_sb + (long long)h * HD, q_ss, q0, S);
  load_tile<T, HD>(Os, LDK, dout + b * o_sb + (long long)h * HD, o_ss, q0,
                   S);
  load_row_stats(Ls, Ds, lse, di, ((size_t)b * nh + h) * S, q0, S);

  float acc[4][NC][4] = {};
  const T* kb = k + b * k_sb + (long long)hk * HD;
  const T* vb = v + b * v_sb + (long long)hk * HD;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    load_tile<T, HD>(Ks, LDK, kb, k_ss, k0, S);
    load_tile<T, HD>(Vs, LDK, vb, v_ss, k0, S);
    __syncthreads();

    // ---- scores and dP of query rows ty + 16a, key cols tx + 16c
    float s[4][4] = {}, dp[4][4] = {};
    dot_4x4<HD>(s, Qs, Ks, LDK, ty, tx);
    dot_4x4<HD>(dp, Os, Vs, LDK, ty, tx);
    __syncthreads();   // every thread is done with V: dS goes over it
    const bool diag = kt == qt;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int il = ty + 16 * a, jl = tx + 16 * c;
        const float p = (diag && jl > il) ? 0.f
                                          : expf(s[a][c] * scale - Ls[il]);
        Ss[il * LDP + jl] = p * (dp[a][c] - Ds[il]);
      }
    __syncthreads();

    // ---- dq += dS . K (scaled at the end)
    matmul_rows<HD>(acc, Ss, LDP, Ks, LDK, ty, tx);
    __syncthreads();   // before the next tile's loads overwrite K and dS
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= S) continue;
    T* o = dq + (((size_t)b * S + i) * nh + h) * HD;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      Convert<T>::store4(o + n * 64 + tx * 4,
                         make_float4(acc[a][n][0] * scale,
                                     acc[a][n][1] * scale,
                                     acc[a][n][2] * scale,
                                     acc[a][n][3] * scale));
  }
}

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

template <typename T, int HD>
int run_dkv(const BwdArgs& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    return run_wgmma<HD>(0, a);
  } else {
    constexpr size_t smem = dkv_smem_bytes<HD>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long* s = a.strides;
    const dim3 grid((a.S + kTile - 1) / kTile, a.nkv, a.B);
    flash_bwd_dkv<T, HD><<<grid, kBwdThreads, smem, a.st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.di, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.nh,
        a.nh / a.nkv, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
        a.scale);
    return (int)cudaGetLastError();
  }
}

template <typename T, int HD>
int run_dq(const BwdArgs& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    return run_wgmma<HD>(1, a);
  } else {
    constexpr size_t smem = dq_smem_bytes<HD>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long* s = a.strides;
    const dim3 grid((a.S + kTile - 1) / kTile, a.nh, a.B);
    flash_bwd_dq<T, HD><<<grid, kBwdThreads, smem, a.st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.di, static_cast<T*>(a.dq), a.S, a.nh, a.nh / a.nkv, s[0], s[1],
        s[2], s[3], s[4], s[5], s[6], s[7], a.scale);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch(int which, int hd, const BwdArgs& a) {
  if (hd == 64) return which == 0 ? run_dkv<T, 64>(a) : run_dq<T, 64>(a);
  if (hd == 128) return which == 0 ? run_dkv<T, 128>(a) : run_dq<T, 128>(a);
  return (int)cudaErrorInvalidValue;
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
  return dtype == 1 ? dispatch<__nv_bfloat16>(which, hd, a)
                    : dispatch<float>(which, hd, a);
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
  if (hd != 64 && hd != 128) return 0;
  if (dtype == 1)
    return hd == 64 ? BwdLayout<64>::kBytes : BwdLayout<128>::kBytes;
  if (which == 0)
    return (int)(hd == 64 ? dkv_smem_bytes<64>() : dkv_smem_bytes<128>());
  return (int)(hd == 64 ? dq_smem_bytes<64>() : dq_smem_bytes<128>());
}
