// int4 KT pools, nibble-packed two positions per byte (half plane along T):
// kernels B7 and B8 of the port, one kernel templated on APPEND
// (kv_attention_kt.cuh holds the body and the design notes).
//
// Replaces, in onebit_tpu/kernels/kv_attention.py:
//   B7  kv_attention_append_kt4 / kv_attention_append_kt4_planar (body
//       _kernel_append_kt4): write this step's K and V nibbles at byte
//       column pos % (T/2), plane pos // (T/2), keeping the partner nibble,
//       and both scales at pos; then flash-decode over [start, length);
//   B8  kv_attention_decode_kt4 (body _kernel_kt4): the same attention,
//       read-only.
// The Pallas planar scale form exists only for XLA buffer forwarding; this
// kernel takes the natural scale layout.
//
// Bound on an H100: HBM bytes. A byte column serves two positions, so a row
// of length n reads min(n, T/2) byte columns of K and V plus n scales of
// each: at llama2-7b batch 8 with every row at 2048 of T = 2048, about
// 71 MB, 21 us at 3.35 TB/s. A CTA's chunk is of byte columns, both nibbles
// of each scored by the CTA that loads it.
#include "kv_attention_kt.cuh"

namespace {
constexpr int kChunk = 256;  // byte columns (512 positions) a CTA
constexpr int kTile = 16;    // byte columns (32 positions) a warp tile
using Kt = onebit_kt::Launch<true, kChunk, kTile>;
}  // namespace

// As onebit_kv_attention_int8, with k_qp [B, nkv, hd, T/2] and
// v_qp [B, T/2, nkv, hd] packed int8; T is the unpacked length (even);
// k_new/v_new hold int4 values in [-8, 7] as int8; `chunk` is
// kv_attention_cuda.KT4_CHUNK, and part_floats at least
// B * nkv * ceil(T / 2 / chunk) * g * (hd + 2).
extern "C" int onebit_kv_attention_int4(
    const void* q, void* out, void* k_qp, void* k_st, void* v_qp, void* v_s,
    const void* lengths, const void* starts, const void* pos,
    const void* k_new, const void* k_snew, const void* v_new,
    const void* v_snew, void* part, void* counters, int B, int nkv, int g,
    int hd, int T, int dtype, int append, int chunk, long long part_floats,
    float hd_scale, void* stream) {
  return Kt::launch(q, out, k_qp, k_st, v_qp, v_s, lengths, starts, pos,
                    k_new, k_snew, v_new, v_snew, part, counters, B, nkv, g,
                    hd, T, dtype, append, chunk, part_floats, hd_scale,
                    stream);
}

// The dynamic shared bytes a CTA of the instance asks for (-1: no such
// instance).
extern "C" int onebit_kv_attention_int4_smem_bytes(int dtype, int hd, int g,
                                                   int append) {
  return Kt::smem_bytes(dtype, hd, g, append);
}
