"""The decode attention kernels over the KV pools, B5-B9, bound with ctypes.

Sources ``onebit_tpu_torch/csrc/kv_attention_int8.cu`` (B5, B6) and
``kv_attention_int4.cu`` (B7, B8), both instances of the kernel in
``kv_attention_kt.cuh``, and ``kv_attention_decode.cu`` (B9, over the
flat pools, with three instances counted apart: int8 pools with scales,
bf16 pools, f32 pools). :func:`launch` and :func:`launch_flat` check their
tensors, launch one kernel on PyTorch's current stream and count the launch
in the kernel's ``KernelInfo``. The public wrappers and the plain PyTorch
versions live in ``kernels/kv_attention.py``.

B9 splits each row into chunks of ``DECODE_CHUNK`` positions from its start
(``kv_attention.kv_attention_decode_chunked`` mirrors its arithmetic), B5-B8
into chunks of ``KT_CHUNK`` (int8) or ``KT4_CHUNK`` (int4) byte columns from
column 0 (``kv_attention.kv_attention_kt_chunked``). Each merges its chunks
in the same launch through ticket counters kept per device
(``bitlinear_cuda.counters``, ``B * nkv`` a launch): two streams must not
run them at once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from onebit_tpu_torch.kernels import build
from onebit_tpu_torch.kernels.bitlinear_cuda import (KernelInfo, _raise_on,
                                                     _stream, counters)

_SRC = "onebit_tpu_torch/csrc/"
_JAX = "onebit_tpu/kernels/kv_attention.py:"
APPEND_KT = KernelInfo("kv_attention_append_kt",
                       _SRC + "kv_attention_int8.cu", _JAX + "334",
                       "kv_attention_int8.cu")
DECODE_KT = KernelInfo("kv_attention_decode_kt",
                       _SRC + "kv_attention_int8.cu", _JAX + "477",
                       "kv_attention_int8.cu")
APPEND_KT4 = KernelInfo("kv_attention_append_kt4",
                        _SRC + "kv_attention_int4.cu", _JAX + "896",
                        "kv_attention_int4.cu")
DECODE_KT4 = KernelInfo("kv_attention_decode_kt4",
                        _SRC + "kv_attention_int4.cu", _JAX + "820",
                        "kv_attention_int4.cu")
_FLAT = "kv_attention_decode.cu"
DECODE_INT8 = KernelInfo("kv_attention_decode_int8", _SRC + _FLAT,
                         _JAX + "1069", _FLAT)
DECODE_BF16 = KernelInfo("kv_attention_decode_bf16", _SRC + _FLAT,
                         _JAX + "1069", _FLAT)
DECODE_F32 = KernelInfo("kv_attention_decode_f32", _SRC + _FLAT,
                        _JAX + "1069", _FLAT)
FLAT_KERNELS = {torch.int8: DECODE_INT8, torch.bfloat16: DECODE_BF16,
                torch.float32: DECODE_F32}            # by pool dtype
KERNELS = (APPEND_KT, DECODE_KT, APPEND_KT4, DECODE_KT4, DECODE_INT8,
           DECODE_BF16, DECODE_F32)

DECODE_CHUNK = 256   # positions a B9 CTA attends (the kernel's kChunk)
KT_CHUNK = 256       # byte columns a B5/B6 CTA attends (int8.cu's kChunk)
KT4_CHUNK = 256      # byte columns a B7/B8 CTA attends (int4.cu's kChunk)
KT_TILE = 16         # byte columns a B5-B8 warp tile (both sources' kTile)
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SYMBOLS = {"kv_attention_int8.cu": "onebit_kv_attention_int8",
            "kv_attention_int4.cu": "onebit_kv_attention_int4",
            _FLAT: "onebit_kv_attention_decode"}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = k.graph_launches = 0


@functools.cache
def _fn(library: str):
    fn = getattr(build.load(library), _SYMBOLS[library])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if library == _FLAT:
        fn.argtypes = [p] * 10 + [i] * 8 + [ctypes.c_longlong, f, p]
    else:
        fn.argtypes = [p] * 15 + [i] * 8 + [ctypes.c_longlong, f, p]
    fn.restype = i
    return fn


def smem_bytes(info: KernelInfo, dtype: torch.dtype, hd: int, g: int) -> int:
    """The dynamic shared bytes a CTA of a B5-B8 instance asks for."""
    fn = getattr(build.load(info.library),
                 _SYMBOLS[info.library] + "_smem_bytes")
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    append = info is APPEND_KT or info is APPEND_KT4
    return fn(_DTYPE_CODES[dtype], hd, g, int(append))


def _check_geometry(info: KernelInfo, hd: int, nh: int, nkv: int,
                    layer: int, n_layers: int) -> None:
    if hd not in HEAD_DIMS or nh % nkv or nh // nkv not in GROUPS:
        raise ValueError(f"{info.name} takes head_dim in {HEAD_DIMS} and "
                         f"nh/nkv in {GROUPS}, got hd={hd}, nh={nh}, "
                         f"nkv={nkv}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")


def _check_tensors(q, named: Sequence, dtypes: dict, shapes: dict,
                   where: str) -> None:
    """Device, layout, dtype and alignment of every named tensor, and the
    shape of every one after ``q``; ``where`` ends a shape error."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    for name, t in named[1:]:
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} {tuple(t.shape)} does not match "
                             f"{shapes[name]} ({where})")


def launch(info: KernelInfo, q, k_pool, k_scale, v_pool, v_scale, lengths,
           layer: int, *, starts: Optional[torch.Tensor],
           append=None) -> torch.Tensor:
    """One launch of B5-B8 on the CUDA tensors given. ``append`` is None
    (B6, B8) or ``(k_new, k_snew, v_new, v_snew, pos)``, written into the
    pools in place by the CTA that attends the written column. Returns
    ``ctx [B, nh, hd]`` in q's dtype."""
    int4 = info.library == "kv_attention_int4.cu"
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or k_pool.dim() != 5 or v_pool.dim() != 5:
        raise ValueError("q must be [B, nh, hd] and the pools 5-d")
    b, nh, hd = q.shape
    n_layers, _, nkv = k_pool.shape[:3]
    t = k_scale.shape[-1]
    tb = t // 2 if int4 else t
    if int4 and t % 2:
        raise ValueError(f"int4 pools need an even T, got {t}")
    shapes = {
        "k_pool": (n_layers, b, nkv, hd, tb), "k_scale": (n_layers, b, nkv, t),
        "v_pool": (n_layers, b, tb, nkv, hd), "v_scale": (n_layers, b, t, nkv),
        "lengths": (b,), "starts": (b,), "pos": (b,), "k_new": (b, nkv, hd),
        "v_new": (b, nkv, hd), "k_snew": (b, nkv), "v_snew": (b, nkv)}
    dtypes = {"q": q.dtype, "k_pool": torch.int8, "v_pool": torch.int8,
              "k_scale": torch.float32, "v_scale": torch.float32,
              "lengths": torch.int32, "starts": torch.int32,
              "pos": torch.int32, "k_new": torch.int8, "v_new": torch.int8,
              "k_snew": torch.float32, "v_snew": torch.float32}
    named = [("q", q), ("k_pool", k_pool), ("k_scale", k_scale),
             ("v_pool", v_pool), ("v_scale", v_scale), ("lengths", lengths)]
    if starts is not None:
        named.append(("starts", starts))
    if append is not None:
        named += list(zip(("k_new", "k_snew", "v_new", "v_snew", "pos"),
                          append))
    _check_tensors(q, named, dtypes, shapes, f"q {tuple(q.shape)}, T={t}")
    _check_geometry(info, hd, nh, nkv, layer, n_layers)
    # the layer's slices: the kernel sees one layer, with 64-bit offsets
    pools = [x[layer].data_ptr() for x in (k_pool, k_scale, v_pool, v_scale)]
    if pools[2] % 16:
        raise ValueError("the V pool's layer slice must be 16-byte aligned")
    out = torch.empty_like(q)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    new = [ptr(x) for x in append[:4]] if append is not None else [None] * 4
    chunk = KT4_CHUNK if int4 else KT_CHUNK
    # each chunk's (m, l) and accumulator, for rows of more than one chunk
    part_floats = b * nkv * -(-tb // chunk) * nh * (hd + 2) // nkv
    part = torch.empty(part_floats, dtype=torch.float32, device=q.device)
    err = _fn(info.library)(
        q.data_ptr(), out.data_ptr(), *pools, lengths.data_ptr(),
        ptr(starts), None if append is None else append[4].data_ptr(), *new,
        part.data_ptr(), counters(q.device, b * nkv).data_ptr(), b, nkv,
        nh // nkv, hd, t, _DTYPE_CODES[q.dtype], int(append is not None),
        chunk, part_floats, hd ** -0.5, _stream(q))
    _raise_on(err, info)
    info.launches += 1
    return out


def launch_flat(q, k_pool, k_scale, v_pool, v_scale, lengths, layer: int, *,
                starts: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of B9 on the CUDA tensors given: pools ``[L, B, T, nkv,
    hd]``, int8 with scales ``[L, B, T, nkv]`` f32, or of q's dtype with
    ``k_scale = v_scale = None``. Returns ``ctx [B, nh, hd]`` in q's
    dtype."""
    quant = k_scale is not None
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or k_pool.dim() != 5 or v_pool.dim() != 5:
        raise ValueError("q must be [B, nh, hd] and the pools 5-d")
    if quant != (v_scale is not None):
        raise ValueError("give both scales (int8 pools) or neither")
    b, nh, hd = q.shape
    n_layers, _, t, nkv = k_pool.shape[:4]
    pool_dtype = torch.int8 if quant else q.dtype
    shapes = {"k_pool": (n_layers, b, t, nkv, hd),
              "v_pool": (n_layers, b, t, nkv, hd),
              "k_scale": (n_layers, b, t, nkv),
              "v_scale": (n_layers, b, t, nkv), "lengths": (b,),
              "starts": (b,)}
    dtypes = {"q": q.dtype, "k_pool": pool_dtype, "v_pool": pool_dtype,
              "k_scale": torch.float32, "v_scale": torch.float32,
              "lengths": torch.int32, "starts": torch.int32}
    names = (("k_pool", "k_scale", "v_pool", "v_scale") if quant
             else ("k_pool", "v_pool"))
    pools = ((k_pool, k_scale, v_pool, v_scale) if quant
             else (k_pool, v_pool))
    named = [("q", q), *zip(names, pools), ("lengths", lengths)]
    if starts is not None:
        named.append(("starts", starts))
    _check_tensors(q, named, dtypes, shapes, f"q {tuple(q.shape)}, T={t}")
    info = FLAT_KERNELS[pool_dtype]
    _check_geometry(info, hd, nh, nkv, layer, n_layers)
    # the layer's slices: the kernel sees one layer, with 64-bit offsets
    ptrs = [x[layer].data_ptr() for x in pools]
    if any(p % 16 for p in ptrs):
        raise ValueError("the pools' layer slices must be 16-byte aligned")
    k_ptr, ks_ptr, v_ptr, vs_ptr = ptrs if quant else (ptrs[0], None,
                                                       ptrs[1], None)
    out = torch.empty_like(q)
    # each chunk's (m, l) and accumulator, for rows of more than one chunk
    part_floats = b * nkv * -(-t // DECODE_CHUNK) * nh * (hd + 2) // nkv
    part = torch.empty(part_floats, dtype=torch.float32, device=q.device)
    err = _fn(_FLAT)(
        q.data_ptr(), out.data_ptr(), k_ptr, ks_ptr, v_ptr, vs_ptr,
        lengths.data_ptr(), None if starts is None else starts.data_ptr(),
        part.data_ptr(), counters(q.device, b * nkv).data_ptr(), b, nkv,
        nh // nkv, hd, t, _DTYPE_CODES[q.dtype], int(quant), DECODE_CHUNK,
        part_floats, hd ** -0.5, _stream(q))
    _raise_on(err, info)
    info.launches += 1
    return out
