// int8 KT pools: kernels B5 and B6 of the port, one kernel templated on
// APPEND (kv_attention_kt.cuh holds the body and the design notes).
//
// Replaces, in onebit_tpu/kernels/kv_attention.py:
//   B5  kv_attention_append_kt (body _kernel_append_kt): write this step's
//       int8 K column, K scale, V row and V scale at pos[b] of the layer,
//       then flash-decode over [start, length) of each row;
//   B6  kv_attention_decode_kt (body _kernel_kt): the same attention,
//       read-only.
//
// Bound on an H100: HBM bytes, each row's K and V bytes and both scales up
// to its length, read once. At llama2-7b batch 8 with every row at length
// 2048 that is about 138 MB, 41 us at 3.35 TB/s.
#include "kv_attention_kt.cuh"

namespace {
constexpr int kChunk = 256;  // byte columns (positions) a CTA
constexpr int kTile = 16;    // byte columns a warp tile
using Kt = onebit_kt::Launch<false, kChunk, kTile>;
}  // namespace

// q/out [B, nh, hd] (dtype 0 = float32, 1 = bfloat16); the layer's pools
// k_qt [B, nkv, hd, T] int8, k_st [B, nkv, T] f32, v_q [B, T, nkv, hd] int8
// (16-byte aligned), v_s [B, T, nkv] f32; lengths, starts (or null), pos
// [B] int32 on the device. With append = 1, k_new/v_new [B, nkv, hd] int8
// and k_snew/v_snew [B, nkv] f32 are written at pos. `chunk` must be the
// kernel's chunk of byte columns (kv_attention_cuda.KT_CHUNK); `part` holds
// part_floats floats, at least B * nkv * ceil(T / chunk) * g * (hd + 2);
// `counters` B * nkv ints that are zero before the launch and after it.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int onebit_kv_attention_int8(
    const void* q, void* out, void* k_qt, void* k_st, void* v_q, void* v_s,
    const void* lengths, const void* starts, const void* pos,
    const void* k_new, const void* k_snew, const void* v_new,
    const void* v_snew, void* part, void* counters, int B, int nkv, int g,
    int hd, int T, int dtype, int append, int chunk, long long part_floats,
    float hd_scale, void* stream) {
  return Kt::launch(q, out, k_qt, k_st, v_q, v_s, lengths, starts, pos,
                    k_new, k_snew, v_new, v_snew, part, counters, B, nkv, g,
                    hd, T, dtype, append, chunk, part_floats, hd_scale,
                    stream);
}

// The dynamic shared bytes a CTA of the instance asks for (-1: no such
// instance).
extern "C" int onebit_kv_attention_int8_smem_bytes(int dtype, int hd, int g,
                                                   int append) {
  return Kt::smem_bytes(dtype, hd, g, append);
}
