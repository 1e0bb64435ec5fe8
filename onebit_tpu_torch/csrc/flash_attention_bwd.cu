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
//   dP_ij = do_i . v_j,  dS_ij = P_ij (dP_ij - di_i),  di_i = o_i . do_i
//   dv_j = sum_i round_T(P_ij) do_i,  dk_j = scale sum_i dS_ij q_i,
//   dq_i = scale sum_j dS_ij k_j,
// the sums over the query heads of kv head h / G included in dk and dv
// (JAX repeats K/V and sums the repeated gradients: the same arithmetic).
// P is rounded to T before the dv product, as the forward rounds it before
// the PV product (and as the plain version and the TPU kernel do); dS stays
// fp32 (the TPU kernel rounds it to T for its bf16 matrix unit, which these
// fp32 FMA kernels do not need). Keys above the diagonal have P = 0 and are
// skipped; every sum accumulates in fp32.
//
// Bound on an H100: operations. The backward's five products (S and dP
// recomputed or formed, dv, dk, dq) cost 2.5 times the forward's two, 10 *
// B * nh * HD * S(S+1)/2 flops: 344 GFLOP per layer at llama2-7b's training
// shape (4 x 2048 x 32 x 128). These kernels recompute S and dP once in
// each of the two kernels (7 products in all). Both dtypes run fp32 FMA on
// the CUDA cores; the bound is the dtype's peak (fp32 67 TFLOP/s, bf16
// 989 TFLOP/s on the tensor cores, which a later mma/wgmma version would
// use).
//
// Design, simple first, in the forward's style:
//   * B11-dkv: one CTA of 256 threads per (key tile of 64, kv head, row),
//     the tiles with the most work (the first keys) launched first. K and V
//     stay in shared memory; the CTA walks the G query heads of the group
//     and, for each, the query tiles from its diagonal to S. Thread
//     (ty, tx) forms the transposed scores of key rows ty + 16a and query
//     columns tx + 16c (a, c < 4), writes P (rounded) and dS transposed to
//     shared memory, then owns dk and dv rows ty + 16a, columns 64n + 4tx..
//     +3, in registers for the whole walk: dk and dv are written once, with
//     no atomics;
//   * B11-dq: one CTA per (query tile of 64, head, row), longest first,
//     walking the key tiles up to the diagonal; dS goes over the V tile in
//     shared memory, and dq accumulates in registers;
//   * rows past S load as zeros, are masked, and are never stored; every
//   global offset is 64-bit.
// Not done yet: mma.sync / wgmma on bf16 tiles, cp.async or TMA pipelining,
// one fused kernel for both (dq by atomics or a second pass).
#include <math.h>

#include "flash_attention_common.cuh"

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

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *dq, *dk, *dv;
  int B, S, nh, nkv;
  long long strides[8];  // q, k, v, do: batch then sequence stride each
  float scale;
  cudaStream_t st;
};

template <typename T, int HD>
int run_dkv(const BwdArgs& a) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long* s = a.strides;
  const dim3 grid((a.S + kTile - 1) / kTile, a.nkv, a.B);
  flash_bwd_dkv<T, HD><<<grid, kBwdThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.nh, a.nh / a.nkv,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int run_dq(const BwdArgs& a) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long* s = a.strides;
  const dim3 grid((a.S + kTile - 1) / kTile, a.nh, a.B);
  flash_bwd_dq<T, HD><<<grid, kBwdThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.dq), a.S, a.nh, a.nh / a.nkv, s[0], s[1], s[2], s[3],
      s[4], s[5], s[6], s[7], a.scale);
  return (int)cudaGetLastError();
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
