// Shared device code of the packed OneBit linear kernels: dtype helpers and
// the row-LayerNorm epilogue that follows every projection.
//
// Layout of the packed signs (onebit_tpu_torch/core/packing.py, "the port's
// layout"): int32 words [K/32, N], K-major canonical. Word (i, n) holds the
// signs of in-indices 32*i .. 32*i+31 of output column n, LSB-first, with
// bit 1 meaning sign -1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace onebit {

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

// y = x * g rounded to T (as the JAX kernels round x*g to x.dtype before the
// dot), returned in fp32. The fp32 product of two bf16 values is exact, so
// one rounding gives the correctly rounded bf16 product.
template <typename T>
__device__ __forceinline__ float scaled_input(T x, T g) {
  return to_f32(from_f32<T>(to_f32(x) * to_f32(g)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block (blockDim.x a multiple of 32, at most 1024); every
// thread gets the total. ``red`` holds 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // the previous call's reads of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
}

// Row LayerNorm over each segment's true width. One block per (row m,
// segment j): segment j of row m is z[m, j*seg_pad : j*seg_pad + n_true];
// pad columns are never read. Two-pass fp32 statistics (biased variance),
// then + bias, cast to TO, written to out[j, m, :n_true].
template <typename TZ, typename TO>
__global__ void layernorm_segments(const TZ* __restrict__ z,
                                   const float* __restrict__ bias,
                                   TO* __restrict__ out, int M, int ld,
                                   int seg_pad, int n_true, float eps) {
  __shared__ float red[32];
  const int m = blockIdx.x, j = blockIdx.y;
  const TZ* row = z + (size_t)m * ld + (size_t)j * seg_pad;
  float s = 0.f;
  for (int c = threadIdx.x; c < n_true; c += blockDim.x) s += to_f32(row[c]);
  const float mean = block_sum(s, red) / (float)n_true;
  float q = 0.f;
  for (int c = threadIdx.x; c < n_true; c += blockDim.x) {
    const float d = to_f32(row[c]) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, red) / (float)n_true + eps);
  TO* o = out + ((size_t)j * M + m) * n_true;
  for (int c = threadIdx.x; c < n_true; c += blockDim.x) {
    float v = (to_f32(row[c]) - mean) * rstd;
    if (bias != nullptr) v += bias[c];
    o[c] = from_f32<TO>(v);
  }
}

}  // namespace onebit
