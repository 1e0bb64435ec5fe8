"""The paged decode attention kernel B10, bound with ctypes.

Source ``onebit_tpu_torch/csrc/paged_attention.cu``, one kernel body with two
instances, each counted in its own ``KernelInfo``: float pages (the dtype of
q) and int8 pages with raw absmax scales. :func:`launch` checks its tensors,
launches the kernel on PyTorch's current stream and counts the launch. The
public wrapper and the plain PyTorch version live in
``kernels/paged_attention.py``.

B10 splits each row into chunks of ``PAGED_CHUNK`` positions from position 0
(``paged_attention.paged_attention_flat_chunked`` mirrors its arithmetic)
and merges them in the same launch through the ticket counters kept per
device (``bitlinear_cuda.counters``): two streams must not run it at once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from onebit_tpu_torch.kernels import build
from onebit_tpu_torch.kernels.bitlinear_cuda import (KernelInfo, _raise_on,
                                                     _stream, counters)
from onebit_tpu_torch.kernels.kv_attention_cuda import (_check_geometry,
                                                        _check_tensors)

_SOURCE = "paged_attention.cu"
_JAX = "onebit_tpu/kernels/paged_attention.py:140"
PAGED = KernelInfo("paged_attention_flat", "onebit_tpu_torch/csrc/" + _SOURCE,
                   _JAX, _SOURCE)
PAGED_INT8 = KernelInfo("paged_attention_flat_int8",
                        "onebit_tpu_torch/csrc/" + _SOURCE, _JAX, _SOURCE)
KERNELS = (PAGED, PAGED_INT8)

PAGED_CHUNK = 256    # positions a B10 CTA attends (the kernel's kChunk)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = k.graph_launches = 0


@functools.cache
def _fn():
    fn = build.load(_SOURCE).onebit_paged_attention
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 10 + [i] * 9 + [ctypes.c_longlong, f, p]
    fn.restype = i
    return fn


def smem_bytes(dtype: torch.dtype, quant: bool, hd: int, g: int) -> int:
    """The dynamic shared bytes a CTA of B10's instance asks for."""
    fn = build.load(_SOURCE).onebit_paged_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(_DTYPE_CODES[dtype], int(quant), hd, g)


def launch(q, pool, lengths, page_indices, layer: int, quant: bool
           ) -> torch.Tensor:
    """One launch of B10 on the CUDA tensors given: ``pool`` is
    ``(k_pages, v_pages)`` or, with ``quant``, ``(k_q, k_s, v_q, v_s)``.
    Returns ``out [B, nh, hd]`` float32."""
    info = PAGED_INT8 if quant else PAGED
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if len(pool) != (4 if quant else 2):
        raise ValueError(f"{info.name} takes {4 if quant else 2} pool "
                         f"tensors, got {len(pool)}")
    k_pages, v_pages = (pool[0], pool[2]) if quant else pool
    if q.dim() != 3 or k_pages.dim() != 5 or page_indices.dim() != 2:
        raise ValueError("q must be [B, nh, hd], the pages 5-d and "
                         "page_indices [B, mp]")
    b, nh, hd = q.shape
    n_layers, n_pages, nkv, ps = k_pages.shape[:4]
    mp = page_indices.shape[1]
    page_dtype = torch.int8 if quant else q.dtype
    shapes = {"k_pages": (n_layers, n_pages, nkv, ps, hd),
              "v_pages": (n_layers, n_pages, nkv, ps, hd),
              "k_scales": (n_layers, n_pages, nkv, ps, 1),
              "v_scales": (n_layers, n_pages, nkv, ps, 1),
              "lengths": (b,), "page_indices": (b, mp)}
    dtypes = {"q": q.dtype, "k_pages": page_dtype, "v_pages": page_dtype,
              "k_scales": torch.float32, "v_scales": torch.float32,
              "lengths": torch.int32, "page_indices": torch.int32}
    names = (("k_pages", "k_scales", "v_pages", "v_scales") if quant
             else ("k_pages", "v_pages"))
    named = [("q", q), *zip(names, pool), ("lengths", lengths),
             ("page_indices", page_indices)]
    _check_tensors(q, named, dtypes, shapes, f"q {tuple(q.shape)}")
    _check_geometry(info, hd, nh, nkv, layer, n_layers)
    if any(t.data_ptr() % 16 for t in pool):
        raise ValueError("the pages must be 16-byte aligned")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    # the layer's slices: the kernel sees one layer, with 64-bit offsets
    ptrs = [t[layer].data_ptr() for t in pool]
    k_ptr, ks_ptr, v_ptr, vs_ptr = ptrs if quant else (ptrs[0], None,
                                                       ptrs[1], None)
    # each chunk's (m, l) and accumulator, for rows of more than one chunk
    part_floats = b * nh * -(-(mp * ps) // PAGED_CHUNK) * (hd + 2)
    part = torch.empty(part_floats, dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), out.data_ptr(), k_ptr, ks_ptr, v_ptr, vs_ptr,
                lengths.data_ptr(), page_indices.data_ptr(), part.data_ptr(),
                counters(q.device, b * nkv).data_ptr(), b, nkv, nh // nkv,
                hd, ps, mp, _DTYPE_CODES[q.dtype], int(quant), PAGED_CHUNK,
                part_floats, hd ** -0.5, _stream(q))
    _raise_on(err, info)
    info.launches += 1
    return out
