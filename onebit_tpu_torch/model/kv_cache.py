"""Quantized KV caches: int8, and int4 packed two values per byte.

Port of ``onebit_tpu/model/kv_cache.py``. Keys and values are quantized per
(position, head) over head_dim with an absmax scale at insertion; attention
reads the integer pools and folds the scales into the scores and into P
(``kernels/kv_attention.py``: the kernels and their plain versions).

Scale conventions (one per pool family, never mixed):

* int8: ``scale = max(absmax, 1e-6) / 127``, stored pre-divided, so
  dequantization is ``q * scale``;
* int4: ``scale = max(absmax, 1e-6) / 7``, values in [-7, 7].

The int4 pools are packed in the HALF-PLANE layout along the sequence axis:
byte c holds column c in its low nibble and column c + n/2 in its high
nibble, each sign-extended on unpacking.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.utils.device import resolve_device

_EPS = 1e-6


class QuantKVCache(NamedTuple):
    """int8 values + per-(position, head) scales, layers stacked on axis 0."""
    k_q: torch.Tensor   # [L, B, T, n_kv, head_dim] int8
    k_s: torch.Tensor   # [L, B, T, n_kv] f32
    v_q: torch.Tensor   # [L, B, T, n_kv, head_dim] int8
    v_s: torch.Tensor   # [L, B, T, n_kv] f32

    @property
    def max_len(self) -> int:
        return self.k_q.shape[2]


class QuantKVCacheKT(NamedTuple):
    """int8 cache with K stored transposed (T last), the layout of the fused
    decode kernels: a warp's load along T is contiguous, and the one-token
    append writes one column. V keeps the row-major layout."""
    k_qt: torch.Tensor  # [L, B, n_kv, head_dim, T] int8
    k_st: torch.Tensor  # [L, B, n_kv, T] f32
    v_q: torch.Tensor   # [L, B, T, n_kv, head_dim] int8
    v_s: torch.Tensor   # [L, B, T, n_kv] f32

    @property
    def max_len(self) -> int:
        return self.k_qt.shape[4]


class QuantKVCacheKT4(NamedTuple):
    """int4 cache, K transposed, both pools nibble-packed along T (half
    plane); scales at full T resolution in the int8 cache's layout."""
    k_qp: torch.Tensor  # [L, B, n_kv, head_dim, T//2] int8 (2x int4)
    k_st: torch.Tensor  # [L, B, n_kv, T] f32
    v_qp: torch.Tensor  # [L, B, T//2, n_kv, head_dim] int8 (2x int4)
    v_s: torch.Tensor   # [L, B, T, n_kv] f32

    @property
    def max_len(self) -> int:
        return self.k_st.shape[3]


def _dims(config: BitLlamaConfig, num_kv_heads=None):
    """(layers, kv heads, head_dim); ``num_kv_heads`` overrides the
    config's head count, as a tensor-parallel rank holds ``nkv / mp``."""
    return (config.num_hidden_layers,
            num_kv_heads or config.num_key_value_heads, config.head_dim)


def init_quant_kv_cache(config: BitLlamaConfig, batch: int, max_len: int,
                        device=None) -> QuantKVCache:
    device = resolve_device(device)
    L, nkv, hd = _dims(config)
    shape = (L, batch, max_len, nkv, hd)
    z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    return QuantKVCache(k_q=z(shape, torch.int8), k_s=z(shape[:-1],
                                                        torch.float32),
                        v_q=z(shape, torch.int8), v_s=z(shape[:-1],
                                                        torch.float32))


def init_quant_kv_cache_kt(config: BitLlamaConfig, batch: int, max_len: int,
                           device=None, num_kv_heads=None) -> QuantKVCacheKT:
    device = resolve_device(device)
    L, nkv, hd = _dims(config, num_kv_heads)
    z = lambda *s, dt=torch.float32: torch.zeros(  # noqa: E731
        s, dtype=dt, device=device)
    return QuantKVCacheKT(k_qt=z(L, batch, nkv, hd, max_len, dt=torch.int8),
                          k_st=z(L, batch, nkv, max_len),
                          v_q=z(L, batch, max_len, nkv, hd, dt=torch.int8),
                          v_s=z(L, batch, max_len, nkv))


def init_quant_kv_cache_kt4(config: BitLlamaConfig, batch: int, max_len: int,
                            device=None, num_kv_heads=None
                            ) -> QuantKVCacheKT4:
    if max_len % 2:
        raise ValueError(f"int4 cache needs even max_len, got {max_len}")
    device = resolve_device(device)
    L, nkv, hd = _dims(config, num_kv_heads)
    th = max_len // 2
    z = lambda *s, dt=torch.float32: torch.zeros(  # noqa: E731
        s, dtype=dt, device=device)
    return QuantKVCacheKT4(k_qp=z(L, batch, nkv, hd, th, dt=torch.int8),
                           k_st=z(L, batch, nkv, max_len),
                           v_qp=z(L, batch, th, nkv, hd, dt=torch.int8),
                           v_s=z(L, batch, max_len, nkv))


def kt_from_quant(cache: QuantKVCache) -> QuantKVCacheKT:
    """Relayout a row-major quant cache into the transposed-K form (a
    copy)."""
    return QuantKVCacheKT(k_qt=cache.k_q.movedim(2, 4).contiguous(),
                          k_st=cache.k_s.movedim(2, 3).contiguous(),
                          v_q=cache.v_q, v_s=cache.v_s)


def quant_from_kt(cache: QuantKVCacheKT) -> QuantKVCache:
    """Inverse of :func:`kt_from_quant` (tests / inspection)."""
    return QuantKVCache(k_q=cache.k_qt.movedim(4, 2).contiguous(),
                        k_s=cache.k_st.movedim(3, 2).contiguous(),
                        v_q=cache.v_q, v_s=cache.v_s)


def _quantize(x: torch.Tensor, levels: float) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    x32 = x.float()
    scale = x32.abs().amax(-1).clamp_min(_EPS) / levels
    q = torch.round(x32 / scale[..., None]).clamp(-levels, levels)
    return q.to(torch.int8), scale


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., head_dim]`` -> (int8 values, scale absmax/127 over head_dim).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    return _quantize(x, 127.0)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def quantize_kv4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., head_dim]`` -> (int4-valued int8 in [-7, 7], scale
    absmax/7)."""
    return _quantize(x, 7.0)


def _to_int8_bits(x32: torch.Tensor) -> torch.Tensor:
    """The low byte of integer ``x32`` as a signed int8 (two's complement),
    with no reliance on how an out-of-range cast wraps."""
    return (((x32 + 128) & 0xFF) - 128).to(torch.int8)


def pack_int4_halfplane(q: torch.Tensor, axis: int) -> torch.Tensor:
    """Pack int4-valued int8 (in [-8, 7]) two per byte along ``axis``: byte
    c = (q[c] & 0xF) | (q[c + n/2] << 4)."""
    n = q.shape[axis]
    if n % 2:
        raise ValueError(f"axis {axis} length {n} not even")
    lo, hi = q.to(torch.int32).split(n // 2, dim=axis)
    return _to_int8_bits((lo & 0xF) | ((hi & 0xF) << 4))


def unpack_int4_halfplane(p: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4_halfplane` -> int8 in [-8, 7]. The low
    nibble is ``(b << 28) >> 28``, written here without the shift's
    overflow; the high one ``b >> 4``, arithmetic on the sign-extended
    byte."""
    p32 = p.to(torch.int32)
    return torch.cat([(((p32 & 0xF) ^ 8) - 8).to(torch.int8),
                      (p32 >> 4).to(torch.int8)], dim=axis)


def merge_nibbles(old: torch.Tensor, new: torch.Tensor,
                  hi) -> torch.Tensor:
    """``old`` packed bytes with the nibble ``hi`` (bool, broadcast: the
    high plane) replaced by the low 4 bits of ``new``; the partner nibble
    is kept bit for bit."""
    o, n = old.to(torch.int32), new.to(torch.int32) & 0xF
    hi = torch.as_tensor(hi, device=old.device)
    return _to_int8_bits(torch.where(hi, (o & 0x0F) | (n << 4),
                                     (o & 0xF0) | n))


def kt4_from_kt(cache: QuantKVCacheKT,
                lengths: Optional[torch.Tensor] = None) -> QuantKVCacheKT4:
    """Requantize an int8 KT cache's contents into the packed int4 form:
    ``q4 = round(q8 * 7/127)``, ``scale *= 127/7``. ``lengths`` is accepted
    for the reference's signature and unused, as there."""
    def req(q8, s8):
        q4 = torch.round(q8.float() * (7.0 / 127.0)).clamp(-7, 7)
        return q4.to(torch.int8), s8 * (127.0 / 7.0)

    k4, k_st = req(cache.k_qt, cache.k_st)
    v4, v_s = req(cache.v_q, cache.v_s)
    return QuantKVCacheKT4(k_qp=pack_int4_halfplane(k4, axis=4), k_st=k_st,
                           v_qp=pack_int4_halfplane(v4, axis=2), v_s=v_s)
