"""The causal flash-attention kernel B11 and its backward kernels B11-dkv and
B11-dq, bound with ctypes.

Sources ``onebit_tpu_torch/csrc/flash_attention.cu`` (the forward, with an
optional log-sum-exp output for the backward) and
``csrc/flash_attention_bwd.cu``. Each kernel body has two instances, each
counted in its own ``KernelInfo``: float32 (the eval dtype) and bfloat16
(``forward``'s and training's default). :func:`launch`,
:func:`launch_bwd_dkv` and :func:`launch_bwd_dq` check their tensors,
launch on PyTorch's current stream and count the launch. The public
wrapper, its autograd rule and the plain PyTorch version live in
``kernels/attention.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from onebit_tpu_torch.kernels import build
from onebit_tpu_torch.kernels.bitlinear_cuda import (KernelInfo, _raise_on,
                                                     _stream)

_SOURCE = "flash_attention.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
_JAX = "onebit_tpu/kernels/attention.py:21"
# the upstream Pallas kernels the JAX flash attention's custom_vjp runs
_UPSTREAM = "jax/experimental/pallas/ops/tpu/flash_attention.py"


def _info(name: str, source: str, replaces: str) -> KernelInfo:
    return KernelInfo(name, "onebit_tpu_torch/csrc/" + source, replaces,
                      source)


FLASH_F32 = _info("flash_causal_attention_f32", _SOURCE, _JAX)
FLASH_BF16 = _info("flash_causal_attention_bf16", _SOURCE, _JAX)
FLASH_DKV_F32 = _info("flash_causal_attention_bwd_dkv_f32", _BWD_SOURCE,
                      _UPSTREAM + ":941")
FLASH_DKV_BF16 = _info("flash_causal_attention_bwd_dkv_bf16", _BWD_SOURCE,
                       _UPSTREAM + ":941")
FLASH_DQ_F32 = _info("flash_causal_attention_bwd_dq_f32", _BWD_SOURCE,
                     _UPSTREAM + ":1287")
FLASH_DQ_BF16 = _info("flash_causal_attention_bwd_dq_bf16", _BWD_SOURCE,
                      _UPSTREAM + ":1287")
KERNELS = (FLASH_F32, FLASH_BF16, FLASH_DKV_F32, FLASH_DKV_BF16,
           FLASH_DQ_F32, FLASH_DQ_BF16)

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
# dtype -> (forward, dkv, dq) infos and the kernels' dtype code
_INFO = {torch.float32: ((FLASH_F32, FLASH_DKV_F32, FLASH_DQ_F32), 0),
         torch.bfloat16: ((FLASH_BF16, FLASH_DKV_BF16, FLASH_DQ_BF16), 1)}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _bind(source: str, name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(build.load(source), name)
    fn.argtypes = argtypes
    fn.restype = _I
    return fn


@functools.cache
def _fn():
    return _bind(_SOURCE, "onebit_flash_causal_attention",
                 [_P] * 5 + [_I] * 5 + [_LL] * 6 + [_I, ctypes.c_float, _P])


def smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """The dynamic shared bytes a CTA of B11's forward instance asks for."""
    fn = build.load(_SOURCE).onebit_flash_smem_bytes
    fn.argtypes = [_I, _I]
    fn.restype = _I
    return fn(hd, _INFO[dtype][1])


@functools.cache
def _fn_dkv():
    return _bind(_BWD_SOURCE, "onebit_flash_bwd_dkv",
                 [_P] * 8 + [_I] * 5 + [_LL] * 8 + [_I, ctypes.c_float, _P])


@functools.cache
def _fn_dq():
    return _bind(_BWD_SOURCE, "onebit_flash_bwd_dq",
                 [_P] * 7 + [_I] * 5 + [_LL] * 8 + [_I, ctypes.c_float, _P])


def _check(q, k, v, num_kv_groups: int, extra=()) -> Tuple[int, ...]:
    """Raise on tensors the kernels do not take; return (B, S, nh, nkv,
    hd). ``extra``: (name, tensor) pairs shaped like q (the backward's
    ``do``)."""
    if q.dtype not in _INFO:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    name = _INFO[q.dtype][0][0].name
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
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS} and "
                         f"nh/nkv in {GROUPS}, got hd={hd}, nh={nh}, "
                         f"nkv={nkv}")
    if b < 1 or s < 1:
        raise ValueError(f"{name} needs B >= 1 and S >= 1, got "
                         f"{tuple(q.shape)}")
    for tname, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.device != q.device:
            raise ValueError(f"{tname} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{tname} must be {q.dtype}, got {t.dtype}")
        if t.shape[2:] != (nh if tname in ("q", "do") else nkv, hd) \
                or t.shape[:2] != (b, s):
            raise ValueError(f"{tname} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
        if not _rows_contiguous(t):
            raise ValueError(f"{tname}'s [n, hd] must be contiguous, "
                             f"strides {t.stride()}")
        if not _rows_aligned(t):
            raise ValueError(f"{tname}'s rows must be 16-byte aligned")
    return b, s, nh, nkv, hd


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Each ``[n, hd]`` row of ``t [B, S, n, hd]`` contiguous (a dimension
    of size 1 is never stepped over: its stride is moot)."""
    return t.stride(3) == 1 and (t.shape[2] == 1
                                 or t.stride(2) == t.shape[3])


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every row starts on 16 bytes: the kernels' vector loads."""
    vec = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and not any(
        t.shape[i] > 1 and t.stride(i) % vec for i in (0, 1))


def _row_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it, else a contiguous copy:
    the gradient autograd hands the backward may be any view."""
    return t if _rows_contiguous(t) and _rows_aligned(t) else t.contiguous()


def launch(q, k, v, num_kv_groups: int, with_lse: bool = False):
    """One launch of B11 on the CUDA tensors given: q ``[B, S, nh, hd]``,
    k/v ``[B, S, nkv, hd]`` in q's dtype, each row's ``[n, hd]``
    contiguous (views of the projections' ``[B*S, n*hd]`` output are).
    Returns ``[B, S, nh, hd]`` in q's dtype, and with ``with_lse`` also the
    rows' fp32 log-sum-exp ``[B, nh, S]`` (the backward's residual)."""
    b, s, nh, nkv, hd = _check(q, k, v, num_kv_groups)
    (info, _, _), code = _INFO[q.dtype]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse: Optional[torch.Tensor] = None
    if with_lse:
        lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s, nh, nkv, hd,
                q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), code, hd ** -0.5, _stream(q))
    _raise_on(err, info)
    info.launches += 1
    return (out, lse) if with_lse else out


def _stats_check(lse, di, b, nh, s, device) -> None:
    for name, t in (("lse", lse), ("di", di)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, nh, s) \
                or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name} must be contiguous float32 [B, nh, S] "
                             f"= {(b, nh, s)} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _strides(q, k, v, do):
    return (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), do.stride(0), do.stride(1))


def launch_bwd_dkv(q, k, v, do, lse, di, num_kv_groups: int):
    """One launch of B11-dkv: ``(dk, dv)`` ``[B, S, nkv, hd]`` in q's dtype
    from q, k, v (as :func:`launch` takes them), ``do`` (q's shape; copied
    to a readable layout if it is not one), the forward's ``lse`` and
    ``di = Σ o·do``, both fp32 ``[B, nh, S]``."""
    do = _row_layout(do)
    b, s, nh, nkv, hd = _check(q, k, v, num_kv_groups, (("do", do),))
    _stats_check(lse, di, b, nh, s, q.device)
    (_, info, _), code = _INFO[q.dtype]
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    err = _fn_dkv()(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), b, s, nh, nkv, hd, *_strides(q, k, v, do),
                    code, hd ** -0.5, _stream(q))
    _raise_on(err, info)
    info.launches += 1
    return dk, dv


def launch_bwd_dq(q, k, v, do, lse, di, num_kv_groups: int):
    """One launch of B11-dq: ``dq [B, S, nh, hd]`` in q's dtype, from the
    inputs of :func:`launch_bwd_dkv`."""
    do = _row_layout(do)
    b, s, nh, nkv, hd = _check(q, k, v, num_kv_groups, (("do", do),))
    _stats_check(lse, di, b, nh, s, q.device)
    (_, _, info), code = _INFO[q.dtype]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _fn_dq()(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b, s, nh,
                   nkv, hd, *_strides(q, k, v, do), code, hd ** -0.5,
                   _stream(q))
    _raise_on(err, info)
    info.launches += 1
    return dq
