// The pieces the decode attention kernels share: B5-B8 over the
// quantized KT pools (kv_attention_kt.cuh, built from kv_attention_int8.cu
// and kv_attention_int4.cu), B9 over the flat pools (kv_attention_decode.cu)
// and B10 through page tables (paged_attention.cu): q's dtype to and from
// fp32, warp reductions, element loads from shared memory (load_elems, of
// f32, bf16, int8 or fp8 e4m3 elements) and the int4 nibble merge of an
// append.
#pragma once

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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

// Two e4m3 bytes (the first in the low byte) as two floats, exactly, in
// one cvt.rn.f16x2.e4m3x2 (sm_89 on): every e4m3 value is exact in f16.
__device__ __forceinline__ float2 fp8x2_to_float2(uint16_t x) {
  uint32_t h2;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"(x));
  return __half22float2(*reinterpret_cast<const __half2*>(&h2));
}

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
    if constexpr (std::is_same<P, __nv_fp8_e4m3>::value) {
      // fp8: two elements an instruction
      static_assert(kPer % 2 == 0, "fp8 elements come in pairs");
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer / 2; ++j) {
        const float2 f = fp8x2_to_float2(e[j]);
        v[i * kPer + 2 * j] = f.x;
        v[i * kPer + 2 * j + 1] = f.y;
      }
    } else {
      const P* e = reinterpret_cast<const P*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[i * kPer + j] = elem_f32(e[j]);
    }
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
