// Large-M (prefill) packed OneBit linear: K3 of the port.
//
// Replaces _call_large_m (body _matmul_large_m_kernel) in
// onebit_tpu/kernels/bitlinear_pallas.py: z = ((x ⊙ g) · Sᵀ) ⊙ h for
// M > 128 rows, stored in x's dtype (bf16 for bf16 input, fp32 for fp32
// input), followed here by the same per-segment row LayerNorm the JAX
// callers apply (layernorm_segments, bitlinear_common.cuh). Fused weights
// (q/k/v, gate/up) go through one launch: a tile's columns never straddle a
// segment, so it picks its g row by segment. With raw = 1 it is B4 at
// M > 128 (bitlinear_packed_raw_stacked / bitlinear_packed_raw): z in x's
// dtype is the result, the projection of a tensor-parallel shard.
//
// Bound on an H100: operations. 2*M*K*N flops; a prefill of 8 x 256 rows at
// llama2-7b is 0.838 ms a layer at the 989 TFLOP/s bf16 tensor-core peak.
// The product therefore runs on the tensor cores through wgmma (sm_90a),
// with bf16 operands and fp32 accumulators in registers:
//   * B is the ±1 sign tile, exact in bf16. Each CTA unpacks the words of
//     its columns once per k step, branch-free (sign_pair: two signs a
//     32-bit word), into a 128-byte swizzled K-major tile in shared memory
//     that both warpgroups read: 2 bytes a sign there, 1 bit in device
//     memory.
//   * A is y = x ⊙ g, built in registers (wgmma's A from registers) from
//     the staged x and g: for bf16 one correctly rounded bf16 product (as
//     scaled_input rounds it, and JAX rounds x*g to x.dtype before the
//     dot). For fp32, y stays the fp32 product and is split into three
//     bf16 parts, hi = bf16(y), mid = bf16(y - hi), lo = bf16(y - hi -
//     mid), 24 mantissa bits in all (split_bf16x3 in bitlinear_cuda.py is
//     its plain mirror); three wgmma run against the same B tile into the
//     same accumulators. Each part's product with ±1 is exact. Its bound is
//     three bf16 passes, 3 x 2MKN / 989 TFLOP/s.
//   * The tensor cores' fp32 sums round toward zero, so over K = 11008
//     their error grows with the partial sums (9.1e-5 after the LayerNorm
//     against a 1e-4 tolerance on an H100); the fp32 instance restarts its
//     accumulators every 8 k tiles and keeps the total in fp32 registers
//     (round to nearest): 3.4e-5 (scripts/torch_large_m_probe.py).
//   * x arrives by TMA (one thread, boxes of 128 rows x 128 bytes,
//     128-byte swizzled so that the A fragments read without bank
//     conflicts, ragged M and K zero-filled) on an mbarrier a slot; the
//     words and g by cp.async (4 and 16 bytes: N need not be a multiple of
//     4); a ring of stage slots (3 for bf16, 4 for fp32) runs kStages - 1
//     tiles ahead of the product; the signs are unpacked one tile ahead
//     into a ring of three B tiles; each k16 step's A fragment has its own
//     registers, so up to kSets - 1 wgmma groups stay in flight while the
//     next fragment is built. One block barrier a k step (the unpacked
//     tile), 256 threads doing the unpacking and the products alike.
// Tiles: BM = 128 rows (two warpgroups of 64, m64nBNk16) by BN = 128
// columns, or 64 where fused segments are not a multiple of 128 (block_n
// below, large_m_block_n in bitlinear_cuda.py); BK = 64 (two word rows; a
// last half step of K % 64 = 32 reads zeros). Ragged M and N read as zeros
// and are masked on store. CTAs walk the tiles in groups of 8 row tiles,
// so the CTAs in flight share x tiles through L2. 256 threads. The bf16
// instance fits two CTAs an SM (128 registers, 103 KB of shared memory),
// so one CTA's barrier and unpacking run beside the other's products; the
// fp32 instance (190 registers for its accumulators and their total, 185
// KB) runs one.
// What holds it back (PERF.md): the per-step barrier and unpacking still
// cost the products time; a producer warpgroup (x by TMA, the words and
// their unpacking in four warps) measured slower here than this design.
// The LayerNorm stays a second launch (it needs whole rows).
#include "bitlinear_common.cuh"
#include "wgmma_common.cuh"

namespace onebit {

using namespace onebit_sm90;

constexpr int kBM = 128;      // rows of a tile: two warpgroups of 64
constexpr int kBK = 64;       // k per stage: two word rows
constexpr int kThreads = 256;
constexpr int kGroupM = 8;    // row tiles per group of the launch order
constexpr int kBStages = 3;   // unpacked sign tiles

// kStages: x / word / g stage slots; kPasses: bf16 products per k16 step;
// kSets: A fragments in registers (kSets - 1 wgmma groups stay in flight
// while the next is built); kPromote: k tiles after which the wgmma
// accumulators are added into fp32 registers and restarted (0: never);
// kCtas: CTAs an SM (registers and shared memory sized for it).
template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kStages = 3, kPasses = 1, kSets = 4, kPromote = 0,
                       kCtas = 2;
};
template <>
struct Cfg<float> {
  static constexpr int kStages = 4, kPasses = 3, kSets = 2, kPromote = 8,
                       kCtas = 1;
};

// Shared memory: kBStages ±1 tiles, then kStages slots of [x tile, its
// words, g], then a full mbarrier a slot. The x tile is TMA's: boxes of
// kBM rows x 128 bytes (one for bf16, two for fp32), 128-byte swizzled.
template <typename T, int BN>
struct Layout {
  static constexpr int kB = BN * kBK * 2;                   // a ±1 tile
  static constexpr int kX = kBM * kBK * sizeof(T);
  static constexpr int kW = 2 * BN * 4;                     // its words
  static constexpr int kG = kBK * sizeof(T);
  static constexpr int kSlot = (kX + kW + kG + 1023) / 1024 * 1024;
  static constexpr int kBars = kBStages * kB + Cfg<T>::kStages * kSlot;
  static constexpr int kBytes = kBars + 8 * Cfg<T>::kStages + 1024;
  static_assert(kB % 1024 == 0, "layout");
};

// The column tile of a launch: 128, or 64 where fused segments are not a
// multiple of 128 (a tile must not straddle a segment).
inline int block_n(int ns, int seg_pad) {
  return (ns == 1 || seg_pad % 128 == 0) ? 128 : 64;
}

// Words of a k tile (two rows of BN) a thread copies and unpacks.
template <int BN>
constexpr int kWordsPerThread = (2 * BN + kThreads - 1) / kThreads;

// The cp.async copies of k tile t (the two word rows of columns n0.., and
// g) into a stage slot's words and g; what lies past N or K reads as
// zeros. x arrives by TMA (issue_x).
template <typename T, int BN>
__device__ __forceinline__ void issue_words(uint32_t slot, const T* gs,
                                            const int32_t* packed, int K,
                                            int N, int n0, int t) {
  using L = Layout<T, BN>;
  constexpr int E = 16 / sizeof(T);   // elements per 16-byte chunk
  const int k0 = t * kBK;
#pragma unroll
  for (int j = 0; j < kWordsPerThread<BN>; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i >= 2 * BN) break;
    const int wi = k0 / 32 + i / BN, n = n0 + i % BN;
    const bool ok = wi < K / 32 && n < N;
    cp_async4(slot + L::kX + i * 4, ok ? packed + (size_t)wi * N + n : packed,
              ok);
  }
  if (threadIdx.x < kBK / E) {
    const int k = k0 + threadIdx.x * E;
    cp_async16(slot + L::kX + L::kW + threadIdx.x * 16, k < K ? gs + k : gs,
               k < K);
  }
}

// One thread: x rows m0.. of k tile t into a slot by TMA, on its mbarrier.
template <typename T, int BN>
__device__ __forceinline__ void issue_x(uint32_t slot, uint32_t bar,
                                        const CUtensorMap* xmap, int m0,
                                        int t) {
  constexpr int BOX = 128 / sizeof(T);   // elements of a 128-byte row
  mbar_expect_tx(bar, Layout<T, BN>::kX);
#pragma unroll
  for (int b = 0; b < kBK / BOX; ++b)
    tma_load_2d(slot + b * kBM * 128, xmap, bar, t * kBK + b * BOX, m0);
}

// Two signs, bits 0 and 1 of b, as a pair of bf16 ±1: (b & 3) * 0x40008000
// puts bit 0 at bits 15 and 30, bit 1 at bits 16 and 31; the mask keeps
// the two sign bits.
__device__ __forceinline__ uint32_t sign_pair(uint32_t b) {
  return 0x3F803F80u | (((b & 3u) * 0x40008000u) & 0x80008000u);
}

// The staged words [2][BN] -> the ±1 bf16 tile [BN][64 k], K-major and
// 128-byte swizzled: chunk c of column n holds k 8c .. 8c+7 (byte c % 4 of
// word row c / 4); bit 1 means -1.

template <int BN>
__device__ __forceinline__ void unpack_signs(const uint32_t* words,
                                             uint8_t* tile) {
#pragma unroll
  for (int j = 0; j < kWordsPerThread<BN>; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i >= 2 * BN) break;
    const int w = i / BN, n = i % BN;
    const uint32_t bits = words[i];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t b = bits >> (8 * q);
      const uint4 v = make_uint4(sign_pair(b), sign_pair(b >> 2),
                                 sign_pair(b >> 4), sign_pair(b >> 6));
      *reinterpret_cast<uint4*>(tile + swizzle128(n, 4 * w + q)) = v;
    }
  }
}

// Byte offset in the staged x tile of row r, column c (c even: a pair):
// 128-byte rows of 128 / sizeof(T) elements, chunk (16 bytes) index XOR
// r % 8, fp32's second half of k in a second box.
template <typename T>
__device__ __forceinline__ int x_offset(int r, int c) {
  constexpr int BOX = 128 / sizeof(T), E = 16 / sizeof(T);
  const int b = c / BOX, cb = c % BOX;
  return b * kBM * 128 + r * 128 + (((cb / E) ^ (r & 7)) << 4) +
         (cb % E) * sizeof(T);
}

// The A fragment of one k16 step: rows r and r + 8, columns c and c + 8
// (c = 16 kk + 2 (lane % 4)) of y = x ⊙ g.
template <typename T>
struct BuildA;

template <>
struct BuildA<__nv_bfloat16> {
  // y rounded once to bf16: mul.bf16x2 rounds the exact product
  __device__ __forceinline__ static void run(uint32_t (&a)[1][4],
                                             const uint8_t* xs,
                                             const __nv_bfloat16* gt, int r,
                                             int c) {
    using B2 = __nv_bfloat162;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cc = c + 8 * half;
      const B2 g2 = *reinterpret_cast<const B2*>(gt + cc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        a[0][2 * half + i] = bits_of(__hmul2(
            *reinterpret_cast<const B2*>(
                xs + x_offset<__nv_bfloat16>(r + 8 * i, cc)),
            g2));
    }
  }
};

template <>
struct BuildA<float> {
  // y = x * g in fp32 (never contracted into a later op), split into
  // hi + mid + lo, three bf16 parts
  __device__ __forceinline__ static void run(uint32_t (&a)[3][4],
                                             const uint8_t* xs,
                                             const float* gt, int r, int c) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cc = c + 8 * half;
      const float2 g2 = *reinterpret_cast<const float2*>(gt + cc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 xv = *reinterpret_cast<const float2*>(
            xs + x_offset<float>(r + 8 * i, cc));
        float y0 = __fmul_rn(xv.x, g2.x), y1 = __fmul_rn(xv.y, g2.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(y0, y1);
        y0 -= __low2float(hi);
        y1 -= __high2float(hi);
        const __nv_bfloat162 mid = __floats2bfloat162_rn(y0, y1);
        y0 -= __low2float(mid);
        y1 -= __high2float(mid);
        const int reg = 2 * half + i;
        a[0][reg] = bits_of(hi);
        a[1][reg] = bits_of(mid);
        a[2][reg] = bf16_pair(y0, y1);
      }
    }
  }
};

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], const uint32_t (&a)[4],
                                    uint64_t desc) {
  if constexpr (BN == 128) wgmma_rs_n128<0>(d, a, desc);
  if constexpr (BN == 64) wgmma_rs_n64<0>(d, a, desc);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, Cfg<T>::kCtas)
project_large_m(const __grid_constant__ CUtensorMap xmap,
                const T* __restrict__ g, const int32_t* __restrict__ packed,
                const float* __restrict__ h, T* __restrict__ z, int M, int K,
                int N, int seg_pad) {
  using L = Layout<T, BN>;
  constexpr int NS = Cfg<T>::kStages, NP = Cfg<T>::kPasses;
  constexpr int SETS = Cfg<T>::kSets, PROMOTE = Cfg<T>::kPromote;
  constexpr int NACC = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  uint8_t* btiles = smem_raw + pad;                 // kBStages sign tiles
  uint8_t* slots = btiles + kBStages * L::kB;       // NS stage slots
  const uint32_t btiles_s = raw + pad, slots_s = btiles_s + kBStages * L::kB;
  const uint32_t full = btiles_s + L::kBars;   // an mbarrier a slot

  // grouped launch order: kGroupM row tiles by every column tile
  const int num_m = (M + kBM - 1) / kBM, num_n = (N + BN - 1) / BN;
  const int per_group = kGroupM * num_n, bid = blockIdx.x;
  const int first_m = bid / per_group * kGroupM;
  const int gsize = min(num_m - first_m, kGroupM);
  const int m0 = (first_m + bid % per_group % gsize) * kBM;
  const int n0 = bid % per_group / gsize * BN;
  const T* gs = g + (size_t)(n0 / seg_pad) * K;

  const int tid = threadIdx.x, lane = tid & 31;
  const int row = (tid >> 5) * 16 + (lane >> 2);   // and row + 8
  const int col = 2 * (lane & 3);
  const int nt = (K + kBK - 1) / kBK;

  float acc[NACC], total[PROMOTE ? NACC : 1];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (PROMOTE ? NACC : 1); ++i) total[i] = 0.f;
  uint32_t a[SETS][NP][4];

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nt) {
      if (tid == 0)
        issue_x<T, BN>(slots_s + s * L::kSlot, full + 8 * s, &xmap, m0, s);
      issue_words<T, BN>(slots_s + s * L::kSlot, gs, packed, K, N, n0, s);
    }
    cp_async_commit();
  }
  cp_async_wait<NS - 2>();
  __syncthreads();
  unpack_signs<BN>(reinterpret_cast<const uint32_t*>(slots + L::kX), btiles);
  fence_proxy_async();

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<NS - 3>();   // tile t's g and tile t + 1's words are in
    __syncthreads();
    // the copies of tile t + NS - 1 (into the slot tile t - 1 read) and
    // the signs of tile t + 1 (over the B tile of t - 2, whose wgmma both
    // warpgroups waited for before the barrier)
    if (t + NS - 1 < nt) {
      const int tn = t + NS - 1, sn = tn % NS;
      if (tid == 0)
        issue_x<T, BN>(slots_s + sn * L::kSlot, full + 8 * sn, &xmap, m0, tn);
      issue_words<T, BN>(slots_s + sn * L::kSlot, gs, packed, K, N, n0, tn);
    }
    cp_async_commit();
    if (t + 1 < nt) {
      unpack_signs<BN>(reinterpret_cast<const uint32_t*>(
                           slots + (t + 1) % NS * L::kSlot + L::kX),
                       btiles + (t + 1) % kBStages * L::kB);
      fence_proxy_async();
    }
    const uint8_t* slot = slots + t % NS * L::kSlot;
    const T* gt = reinterpret_cast<const T*>(slot + L::kX + L::kW);
    const uint32_t bt = btiles_s + t % kBStages * L::kB;
    mbar_wait(full + 8 * (t % NS), (t / NS) & 1);   // tile t's x is in
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_wait<SETS - 1>();   // the wgmma that last read a[kk % SETS]
      BuildA<T>::run(a[kk % SETS], slot, gt, row, 16 * kk + col);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < NP; ++p)
        mma<BN>(acc, a[kk % SETS][p], desc128(bt + 32 * kk, 16, 1024));
      wgmma_commit();
    }
    if constexpr (PROMOTE > 0) {
      // the tensor cores' fp32 sums round toward zero: restart them from
      // zero every PROMOTE tiles and keep the total in round-to-nearest
      if (t % PROMOTE == PROMOTE - 1 || t == nt - 1) {
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          total[i] += acc[i];
          acc[i] = 0.f;
        }
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (PROMOTE > 0) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = total[i];
  }

#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int n = n0 + 8 * i + col;
    if (n >= N) continue;
    const float h0 = h[n], h1 = n + 1 < N ? h[n + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + row + 8 * half;
      if (m >= M) continue;
      T* zr = z + (size_t)m * N + n;
      zr[0] = from_f32<T>(acc[4 * i + 2 * half] * h0);
      if (n + 1 < N) zr[1] = from_f32<T>(acc[4 * i + 2 * half + 1] * h1);
    }
  }
}

template <typename T, int BN>
cudaError_t launch_project(const T* x, const T* g, const int32_t* packed,
                           const float* h, T* z, int M, int K, int N,
                           int seg_pad, cudaStream_t stream) {
  constexpr int smem = Layout<T, BN>::kBytes;
  // x [M, K] in boxes of kBM rows x 128 bytes, 128-byte swizzled
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(T)};
  const cuuint32_t box[2] = {128 / sizeof(T), kBM};
  if (!make_tensor_map(&xmap,
                       sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                       2, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      project_large_m<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  project_large_m<T, BN><<<(unsigned)tiles, kThreads, smem, stream>>>(
      xmap, g, packed, h, z, M, K, N, seg_pad);
  return cudaGetLastError();
}

template <typename T>
int launch_large_m(const void* x, const void* g, const void* packed,
                   const void* h, const void* bias, void* z, void* out, int M,
                   int K, int N, int ns, int seg_pad, int n_true, int raw,
                   float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const int32_t* pw = static_cast<const int32_t*>(packed);
  const float* hf = static_cast<const float*>(h);
  T* zt = static_cast<T*>(z);
  const cudaError_t err =
      block_n(ns, seg_pad) == 128
          ? launch_project<T, 128>(xt, gt, pw, hf, zt, M, K, N, seg_pad,
                                   stream)
          : launch_project<T, 64>(xt, gt, pw, hf, zt, M, K, N, seg_pad,
                                  stream);
  if (err != cudaSuccess || raw) return (int)err;
  layernorm_segments<T, T><<<dim3(M, ns), kThreads, 0, stream>>>(
      zt, static_cast<const float*>(bias), static_cast<T*>(out), M, N,
      seg_pad, n_true, eps);
  return (int)cudaGetLastError();
}

}  // namespace onebit

// dtype: 0 = float32, 1 = bfloat16 (x, g, z and out; h and bias are fp32).
// x and g rows start on 16 bytes. Returns cudaGetLastError() after the
// launches (0 on success).
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

// The column tile the launch above uses for ns segments of seg_pad columns
// (bitlinear_cuda.py large_m_block_n states the same rule).
extern "C" int onebit_large_m_block_n(int ns, int seg_pad) {
  return onebit::block_n(ns, seg_pad);
}
