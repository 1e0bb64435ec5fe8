// The pieces the decode attention kernels share: B5-B8 over the
// quantized KT pools (kv_attention_kt.cuh, built from kv_attention_int8.cu
// and kv_attention_int4.cu), B9 over the flat pools (kv_attention_decode.cu)
// and B10 through page tables (paged_attention.cu): q's dtype to and from
// fp32, warp reductions, element loads from shared memory (load_elems) and
// the int4 nibble merge of an append.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace onebit_kv {

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

// The byte with nibble `hi` replaced by the low 4 bits of v, the other
// nibble kept.
__device__ __forceinline__ int8_t merge_nibble(int8_t old, int8_t v,
                                               bool hi) {
  const uint32_t o = (uint8_t)old, n = (uint32_t)v & 0xFu;
  const uint32_t m = hi ? (o & 0x0Fu) | (n << 4) : (o & 0xF0u) | n;
  return (int8_t)(uint8_t)m;
}

}  // namespace onebit_kv
