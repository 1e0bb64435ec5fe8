// Large-M (prefill) packed OneBit linear: K3 of the port.
//
// Replaces _call_large_m (body _matmul_large_m_kernel) in
// onebit_tpu/kernels/bitlinear_pallas.py: z = ((x ⊙ g) · Sᵀ) ⊙ h for
// M > 128 rows, stored in x's dtype (bf16 for bf16 input, fp32 for fp32
// input), followed here by the same per-segment row LayerNorm the JAX
// callers apply (layernorm_segments, bitlinear_common.cuh). Fused weights
// (q/k/v, gate/up) go through one launch: a block's 64 columns never
// straddle a segment, so it picks its g row by segment. With raw = 1 it is
// B4 at M > 128 (bitlinear_packed_raw_stacked / bitlinear_packed_raw): z
// in x's dtype is the result, the projection of a tensor-parallel shard.
//
// Bound on an H100: operations. 2*M*K*N flops; prefill of 8 x 256 rows at
// llama2-7b is about 26.5 TFLOP, about 27 ms at the 989 TFLOP/s bf16
// tensor-core peak. This kernel runs on the fp32 CUDA cores (67 TFLOP/s
// peak), so it cannot come within 15x of that bound; mma.sync or wgmma
// with the unpacked tile as a bf16 operand is a later step.
//
// Design: a 64 x 64 output tile per block of 256 threads, each thread a
// 4 x 4 register tile. The K loop walks one word row (32 k) at a time: the
// block stages y = x ⊙ g (rounded to x's dtype, held in fp32) for its 64
// rows and unpacks the 64 words of its columns into a ±1 fp32 tile in
// shared memory, once per block, reused by all 64 rows. Accumulation is
// fp32.
#include "bitlinear_common.cuh"

namespace onebit {

constexpr int kTile = 64;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
project_large_m(const T* __restrict__ x, const T* __restrict__ g,
                const int32_t* __restrict__ packed,
                const float* __restrict__ h, T* __restrict__ z, int M, int K,
                int N, int seg_pad) {
  __shared__ float ys[kTile][33];                   // +1: no bank conflicts
  __shared__ __align__(16) float ss[32][kTile];     // ±1 sign tile
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const T* gs = g + (size_t)(n0 / seg_pad) * K;
  const int nw = K / 32;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int wi = 0; wi < nw; ++wi) {
    for (int idx = tid; idx < kTile * 32; idx += kThreads) {
      const int r = idx >> 5, kk = idx & 31, k = wi * 32 + kk;
      ys[r][kk] = (m0 + r < M)
                      ? scaled_input<T>(x[(size_t)(m0 + r) * K + k], gs[k])
                      : 0.f;
    }
    {
      const int c = tid & (kTile - 1), jb = (tid >> 6) * 8;
      const uint32_t w =
          n0 + c < N ? (uint32_t)packed[(size_t)wi * N + n0 + c] : 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ss[jb + j][c] = ((w >> (jb + j)) & 1u) ? -1.f : 1.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 32; ++kk) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ys[ty * 4 + r][kk];
      const float4 b = *reinterpret_cast<const float4*>(&ss[kk][tx * 4]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] += a[r] * b.x;
        acc[r][1] += a[r] * b.y;
        acc[r][2] += a[r] * b.z;
        acc[r][3] += a[r] * b.w;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < N) z[(size_t)m * N + n] = from_f32<T>(acc[r][c] * h[n]);
    }
  }
}

template <typename T>
int launch_large_m(const void* x, const void* g, const void* packed,
                   const void* h, const void* bias, void* z, void* out, int M,
                   int K, int N, int ns, int seg_pad, int n_true, int raw,
                   float eps, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  project_large_m<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const int32_t*>(packed), static_cast<const float*>(h),
      static_cast<T*>(z), M, K, N, seg_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || raw) return (int)err;
  layernorm_segments<T, T><<<dim3(M, ns), kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const float*>(bias),
      static_cast<T*>(out), M, N, seg_pad, n_true, eps);
  return (int)cudaGetLastError();
}

}  // namespace onebit

// dtype: 0 = float32, 1 = bfloat16 (x, g, z and out; h and bias are fp32).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int onebit_bitlinear_large_m(const void* x, const void* g,
                                        const void* packed, const void* h,
                                        const void* bias, void* z, void* out,
                                        int M, int K, int N, int ns,
                                        int seg_pad, int n_true, int dtype,
                                        int raw, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return onebit::launch_large_m<__nv_bfloat16>(
        x, g, packed, h, bias, z, out, M, K, N, ns, seg_pad, n_true, raw, eps,
        st);
  return onebit::launch_large_m<float>(x, g, packed, h, bias, z, out, M, K, N,
                                       ns, seg_pad, n_true, raw, eps, st);
}
