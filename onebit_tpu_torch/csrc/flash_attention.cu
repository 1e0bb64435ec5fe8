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
// byte. The fp32 instance (the eval dtype) runs on the CUDA cores' fp32 FMA,
// not TF32 (the eval's logits are held to 2e-4), against the 67 TFLOP/s
// fp32 peak: 2.05 ms a layer. The bf16 instance does the same fp32 FMA
// arithmetic; its bound is the 989 TFLOP/s bf16 tensor-core peak, which a
// later wgmma version would approach.
//
// Design, simple first:
//   * one CTA of 256 threads per (query tile of 64, head, row), launched
//     longest rows first; it walks the key tiles of 64 only up to the
//     diagonal and masks j > i inside the diagonal tile;
//   * each K and V tile is staged in shared memory as fp32 with 16-byte
//     global loads, every load of the tile issued before any is stored
//     (4-8 in flight per thread); the Q tile is staged once;
//   * a 16 x 16 thread grid: thread (ty, tx) owns score rows ty + 16a and
//     columns tx + 16c (a, c < 4), reading Q and K rows as float4 from
//     rows padded by 4 floats (conflict-free); the row max and sum meet by
//     shuffles within the 16 lanes of a row; P is written over the K tile;
//   * the same thread owns output rows ty + 16a and columns 64n + 4tx..+3,
//     reading P and V as float4;
//   * every global offset is 64-bit.
// Not done yet: mma.sync / wgmma on bf16 tiles, cp.async or TMA pipelining,
// warp specialisation.
#include <math.h>

#include "flash_attention_common.cuh"

namespace onebit_flash {

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K (P over K) padded, V unpadded
  return (size_t)(2 * kTile * (HD + kPad) + kTile * HD) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_causal(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int S, int nh, int G, long long q_sb,
             long long q_ss, long long k_sb, long long k_ss, long long v_sb,
             long long v_ss, float scale) {
  constexpr int LDK = HD + kPad;     // Q, K rows
  constexpr int LDP = kTile + kPad;  // P rows
  constexpr int NC = HD / 64;        // float4 column groups of out per thread
  static_assert(HD % 64 == 0, "head_dim");
  static_assert(kTile * LDP <= kTile * LDK, "P fits over K");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * LDK;
  float* Vs = Ks + kTile * LDK;
  float* Ps = Ks;                    // P is written over K once scored

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qt * kTile;

  load_tile<T, HD>(Qs, LDK, q + b * q_sb + (long long)h * HD, q_ss, q0, S);

  float acc[4][NC][4], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -1e30f;
    l[a] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
  }

  const T* kb = k + b * k_sb + (long long)hk * HD;
  const T* vb = v + b * v_sb + (long long)hk * HD;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    load_tile<T, HD>(Ks, LDK, kb, k_ss, k0, S);
    load_tile<T, HD>(Vs, HD, vb, v_ss, k0, S);
    __syncthreads();

    // ---- 1. scores of the thread's 4 x 4 cells
    float s[4][4] = {};
    dot_4x4<HD>(s, Qs, Ks, LDK, ty, tx);
    // only the diagonal tile holds keys above the diagonal; a query row
    // past S (the last tile's padding) sees zero keys and is never stored
    const bool diag = kt == qt;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[a][c] = (diag && tx + 16 * c > ty + 16 * a) ? -INFINITY
                                                      : s[a][c] * scale;
    __syncthreads();   // every thread is done with K: P goes over it

    // ---- 2. online softmax; the 16 lanes of a row meet by shuffles
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - m_new);   // 0 above the diagonal
        sum += p;
        Ps[(ty + 16 * a) * LDP + tx + 16 * c] = round_to<T>(p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[a] = l[a] * alpha + sum;
      m[a] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] *= alpha;
    }
    __syncthreads();

    // ---- 3. acc += P . V
    matmul_rows<HD>(acc, Ps, LDP, Vs, HD, ty, tx);
    __syncthreads();   // before the next tile's loads overwrite P and V
  }

  // ---- out = acc / l, in T
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= S) continue;
    T* o = out + (((size_t)b * S + i) * nh + h) * HD;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      Convert<T>::store4(o + n * 64 + tx * 4,
                         make_float4(acc[a][n][0] / l[a], acc[a][n][1] / l[a],
                                     acc[a][n][2] / l[a],
                                     acc[a][n][3] / l[a]));
  }
  // ---- the rows' log-sum-exp, for the backward (every lane of a row holds
  // the same m and l)
  if (lse != nullptr && tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
      if (i < S) lse[((size_t)b * nh + h) * S + i] = m[a] + logf(l[a]);
    }
  }
}

template <typename T, int HD>
int run(const void* q, const void* k, const void* v, void* out, float* lse,
        int B, int S, int nh, int G, const long long* strides, float scale,
        cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_causal<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kTile - 1) / kTile, nh, B);
  flash_causal<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, nh, G,
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
      scale);
  return (int)cudaGetLastError();
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
