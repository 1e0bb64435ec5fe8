// Small-M (decode) packed OneBit linear: K1 and K2 of the port.
//
// Replaces, in onebit_tpu/kernels/bitlinear_pallas.py:
//   K1  bitlinear_packed_pallas_stacked / _call_small_m_stacked
//       (body _fused_small_m_kernel): one projection, o_proj and down_proj;
//   K2  bitlinear_packed_fused_stacked (body _fused_multiseg_small_kernel):
//       ns projections sharing x (q/k/v, gate/up) concatenated along N, each
//       segment padded to seg_pad with h = 0, LayerNorm per segment over the
//       true width n_true.
//   B4  bitlinear_packed_raw_stacked / bitlinear_packed_raw at M <= 128
//       (_call_small_m(_stacked) with fuse_ln=False): K1 with raw = 1, the
//       projection of a tensor-parallel shard, whose LayerNorm runs after
//       the cross-shard all-reduce (model/tp_decode.py).
// Both compute LayerNorm(((x ⊙ g_seg) · Sᵀ) ⊙ h) (+ bias) for M <= 128 rows.
//
// Bound on an H100: the packed sign words, read once (K*N/8 bytes); x, g, h
// and the output are small beside them at decode. At llama2-7b o_proj
// (K = N = 4096) that is 2.1 MB, about 0.63 us at 3.35 TB/s.
//
// Design. The TPU kernel carries an fp32 accumulator across its sequential
// grid and normalises in the last grid step; CUDA blocks cannot share state,
// so the work is split in two launches:
//   1. project_small_m: a block owns 32 output columns (one per lane, so a
//      warp's load of a word row is one coalesced 128-byte read) and 8 rows.
//      Its 8 warps split the K/32 word rows; y = x ⊙ g is staged in shared
//      memory 1024 k at a time, in fp32 after rounding to x's dtype, with
//      all loads of a chunk in flight together. Bit j of a word becomes
//      ±1.0f in a register (moved to the float's sign bit over 1.0f) and
//      serves all 8 rows, one fma each; no unpacked tile is stored. The
//      warps' partial sums meet in shared memory and z ⊙ h is written to an
//      fp32 scratch.
//   2. layernorm_segments (bitlinear_common.cuh): one block per row and
//      segment, two-pass fp32 statistics over n_true, + bias, cast.
// With raw = 1 (B4) the second launch is skipped and the fp32 scratch is
// the result.
#include "bitlinear_common.cuh"

namespace onebit {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;             // rows of x per block
constexpr int kChunkWords = 32;      // word rows of y staged at a time
constexpr int kChunk = kChunkWords * 32;

// ±1.0f from bit j of w: the bit moved to the float's sign bit, over the
// bit pattern of 1.0f. Built once per k, used by all rows.
__device__ __forceinline__ float sign_of(uint32_t w, int j) {
  return __uint_as_float(((w << (31 - j)) & 0x80000000u) | 0x3f800000u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
project_small_m(const T* __restrict__ x, const T* __restrict__ g,
                const int32_t* __restrict__ packed,
                const float* __restrict__ h, float* __restrict__ z, int M,
                int K, int N, int seg_pad) {
  __shared__ __align__(16) float ys[kRows][kChunk];  // 32 KB
  __shared__ float part[kWarps][kRows][32];           // 8 KB
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * 32, n = n0 + lane;
  const int m0 = blockIdx.y * kRows;
  const T* gs = g + (size_t)(n0 / seg_pad) * K;  // blocks never straddle
  const int nw = K / 32;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int w0 = 0; w0 < nw; w0 += kChunkWords) {
    const int ck = min(kChunkWords, nw - w0) * 32;
    const int k0 = w0 * 32;
    // Stage y: every load of the chunk is issued before any is used (the
    // loops are unrolled with fixed trip counts), so the block waits one
    // memory latency per chunk rather than one per element.
    constexpr int kPer = kChunk / kThreads;
    float gv[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int kk = threadIdx.x + t * kThreads;
      gv[t] = kk < ck ? to_f32(gs[k0 + kk]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool row_ok = m0 + r < M;
      const T* xr = x + (size_t)(m0 + r) * K + k0;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int kk = threadIdx.x + t * kThreads;
        ys[r][kk] = (row_ok && kk < ck)
                        ? to_f32(from_f32<T>(to_f32(xr[kk]) * gv[t]))
                        : 0.f;
      }
    }
    __syncthreads();
    for (int wi = warp; wi * 32 < ck; wi += kWarps) {
      const uint32_t w =
          n < N ? (uint32_t)packed[(size_t)(w0 + wi) * N + n] : 0u;
#pragma unroll
      for (int jb = 0; jb < 32; jb += 4) {
        const float s0 = sign_of(w, jb), s1 = sign_of(w, jb + 1);
        const float s2 = sign_of(w, jb + 2), s3 = sign_of(w, jb + 3);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 v =
              *reinterpret_cast<const float4*>(&ys[r][wi * 32 + jb]);
          acc[r] = fmaf(v.x, s0, acc[r]);
          acc[r] = fmaf(v.y, s1, acc[r]);
          acc[r] = fmaf(v.z, s2, acc[r]);
          acc[r] = fmaf(v.w, s3, acc[r]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) part[warp][r][lane] = acc[r];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * 32; idx += kThreads) {
    const int r = idx >> 5, l = idx & 31;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += part[q][r][l];
    const int nn = n0 + l;
    if (m0 + r < M && nn < N) z[(size_t)(m0 + r) * N + nn] = s * h[nn];
  }
}

template <typename T>
int launch_small_m(const void* x, const void* g, const void* packed,
                   const void* h, const void* bias, void* z, void* out, int M,
                   int K, int N, int ns, int seg_pad, int n_true, int raw,
                   float eps, cudaStream_t stream) {
  const dim3 grid((N + 31) / 32, (M + kRows - 1) / kRows);
  project_small_m<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const int32_t*>(packed), static_cast<const float*>(h),
      static_cast<float*>(z), M, K, N, seg_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || raw) return (int)err;
  layernorm_segments<float, T><<<dim3(M, ns), kThreads, 0, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(bias),
      static_cast<T*>(out), M, N, seg_pad, n_true, eps);
  return (int)cudaGetLastError();
}

int dispatch_small_m(const void* x, const void* g, const void* packed,
                     const void* h, const void* bias, void* z, void* out,
                     int M, int K, int N, int ns, int seg_pad, int n_true,
                     int dtype, int raw, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_small_m<__nv_bfloat16>(x, g, packed, h, bias, z, out, M, K,
                                         N, ns, seg_pad, n_true, raw, eps, st);
  return launch_small_m<float>(x, g, packed, h, bias, z, out, M, K, N, ns,
                               seg_pad, n_true, raw, eps, st);
}

}  // namespace onebit

// dtype: 0 = float32, 1 = bfloat16 (x, g and out; h, bias, z are fp32).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int onebit_bitlinear_small_m(const void* x, const void* g,
                                        const void* packed, const void* h,
                                        const void* bias, void* z, void* out,
                                        int M, int K, int N, int dtype,
                                        int raw, float eps, void* stream) {
  return onebit::dispatch_small_m(x, g, packed, h, bias, z, out, M, K, N, 1,
                                  N, N, dtype, raw, eps, stream);
}

extern "C" int onebit_bitlinear_fused_small_m(
    const void* x, const void* g, const void* packed, const void* h, void* z,
    void* out, int M, int K, int N, int ns, int seg_pad, int n_true,
    int dtype, float eps, void* stream) {
  return onebit::dispatch_small_m(x, g, packed, h, nullptr, z, out, M, K, N,
                                  ns, seg_pad, n_true, dtype, 0, eps, stream);
}
