"""The causal flash-attention kernel B11, bound with ctypes.

Source ``onebit_tpu_torch/csrc/flash_attention.cu``, one kernel body with two
instances, each counted in its own ``KernelInfo``: float32 (the eval dtype)
and bfloat16 (``forward``'s default). :func:`launch` checks its tensors,
launches the kernel on PyTorch's current stream and counts the launch. The
public wrapper and the plain PyTorch version live in
``kernels/attention.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from onebit_tpu_torch.kernels import build
from onebit_tpu_torch.kernels.bitlinear_cuda import (KernelInfo, _raise_on,
                                                     _stream)

_SOURCE = "flash_attention.cu"
_JAX = "onebit_tpu/kernels/attention.py:21"
FLASH_F32 = KernelInfo("flash_causal_attention_f32",
                       "onebit_tpu_torch/csrc/" + _SOURCE, _JAX, _SOURCE)
FLASH_BF16 = KernelInfo("flash_causal_attention_bf16",
                        "onebit_tpu_torch/csrc/" + _SOURCE, _JAX, _SOURCE)
KERNELS = (FLASH_F32, FLASH_BF16)

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
_INFO = {torch.float32: (FLASH_F32, 0), torch.bfloat16: (FLASH_BF16, 1)}


@functools.cache
def _fn():
    fn = build.load(_SOURCE).onebit_flash_causal_attention
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 4 + [i] * 5 + [ll] * 6 + [i, ctypes.c_float, p]
    fn.restype = i
    return fn


def launch(q, k, v, num_kv_groups: int) -> torch.Tensor:
    """One launch of B11 on the CUDA tensors given: q ``[B, S, nh, hd]``,
    k/v ``[B, S, nkv, hd]`` in q's dtype, each row's ``[n, hd]``
    contiguous (views of the projections' ``[B*S, n*hd]`` output are).
    Returns ``[B, S, nh, hd]`` in q's dtype."""
    if q.dtype not in _INFO:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    info, code = _INFO[q.dtype]
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, S, n, hd]")
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    if tuple(k.shape) != (b, s, nkv, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if nkv * num_kv_groups != nh:
        raise ValueError(f"nh={nh} is not nkv={nkv} x {num_kv_groups} groups")
    if hd not in HEAD_DIMS or num_kv_groups not in GROUPS:
        raise ValueError(f"{info.name} takes head_dim in {HEAD_DIMS} and "
                         f"nh/nkv in {GROUPS}, got hd={hd}, nh={nh}, "
                         f"nkv={nkv}")
    if b < 1 or s < 1:
        raise ValueError(f"{info.name} needs B >= 1 and S >= 1, got "
                         f"{tuple(q.shape)}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
        # a dimension of size 1 is never stepped over: its stride is moot
        if t.stride(3) != 1 or (t.shape[2] > 1 and t.stride(2) != hd):
            raise ValueError(f"{name}'s [n, hd] must be contiguous, strides "
                             f"{t.stride()}")
        if t.data_ptr() % 16 or any(t.shape[i] > 1 and t.stride(i) % vec
                                    for i in (0, 1)):
            raise ValueError(f"{name}'s rows must be 16-byte aligned")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, nh, nkv, hd, q.stride(0), q.stride(1), k.stride(0),
                k.stride(1), v.stride(0), v.stride(1), code, hd ** -0.5,
                _stream(q))
    _raise_on(err, info)
    info.launches += 1
    return out
