"""The packed OneBit linear as hand-written CUDA kernels, each beside its
plain PyTorch version.

Port of ``onebit_tpu/kernels/bitlinear_pallas.py``. Three kernels, sources in
``onebit_tpu_torch/csrc/`` (each source's header says what bounds it):

* K1 :func:`small_m`, for one projection at M <= 128 rows (o_proj, down_proj,
  and q/k/v when they are not fused);
* K2 :func:`fused_small_m`, for ``ns`` projections sharing x at M <= 128
  (q/k/v and gate/up after ``fuse_for_decode``);
* K3 :func:`large_m`, for M > 128 rows (prefill, and every projection of
  an fp32 eval window), single or fused, on the tensor cores (wgmma on a
  ±1 bf16 tile; the fp32 instance in three bf16 passes,
  :func:`split_bf16x3`); its launches are counted per dtype instance (bf16
  ``bitlinear_large_m``, fp32 ``bitlinear_large_m_f32``);
* B4, the raw projection of a tensor-parallel shard
  (``bitlinear_packed_raw_stacked`` / ``bitlinear_packed_raw``): K1 and K3
  with ``raw=True``, which skip the LayerNorm launch. Their launches are
  counted as B4's two instances, ``bitlinear_raw_small_m`` (M <= 128, fp32
  out) and ``bitlinear_raw_large_m`` (M > 128, z in x's dtype), never under
  K1 or K3.

Every kernel computes ``LayerNorm(((x ⊙ g_j) · S_jᵀ) ⊙ h_j) (+ bias)`` per
segment ``j``, with the signs in the port's K-major layout
(``core/packing.py``), and each LayerNorm runs over the segment's true width
``n_true``, never over pad columns. ``raw=True`` returns the projection
before the LayerNorm (B4).

A wrapper given CPU tensors returns its plain version (the reference's
strategy: unpack to a dense ±1 matrix, then matmul). Given CUDA tensors it
launches its kernel or raises; there is no fallback. Each wrapper counts its
launches in ``KernelInfo.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from onebit_tpu_torch.core.bitlinear import LN_EPS
from onebit_tpu_torch.core.packing import WORD_BITS, unpack_signs_kmajor
from onebit_tpu_torch.kernels import build

SMALL_M_MAX = 128   # rows; above it prefill takes K3 (bitlinear_pallas.py:51)
_SEG_ALIGN = 64     # fused segments: a multiple of both kernels' column tile
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass
class KernelInfo:
    name: str
    source: str      # path in the repository
    replaces: str    # file:line of the Pallas kernel it ports
    library: str     # source file under csrc/
    route: str = "cuda"
    launches: int = 0


SMALL_M = KernelInfo(
    "bitlinear_small_m", "onebit_tpu_torch/csrc/bitlinear_small_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:347", "bitlinear_small_m.cu")
FUSED_SMALL_M = KernelInfo(
    "bitlinear_fused_small_m", "onebit_tpu_torch/csrc/bitlinear_small_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:514", "bitlinear_small_m.cu")
LARGE_M = KernelInfo(
    "bitlinear_large_m", "onebit_tpu_torch/csrc/bitlinear_large_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:608", "bitlinear_large_m.cu")
LARGE_M_F32 = KernelInfo(
    "bitlinear_large_m_f32", "onebit_tpu_torch/csrc/bitlinear_large_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:608", "bitlinear_large_m.cu")
RAW_SMALL_M = KernelInfo(
    "bitlinear_raw_small_m", "onebit_tpu_torch/csrc/bitlinear_small_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:691", "bitlinear_small_m.cu")
RAW_LARGE_M = KernelInfo(
    "bitlinear_raw_large_m", "onebit_tpu_torch/csrc/bitlinear_large_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:691", "bitlinear_large_m.cu")
KERNELS = (SMALL_M, FUSED_SMALL_M, LARGE_M, LARGE_M_F32, RAW_SMALL_M,
           RAW_LARGE_M)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _project_torch(x2, packed, g, h, seg_pad: int) -> torch.Tensor:
    """fp32 ``z [M, N]``: segment j's columns use ``y_j = x ⊙ g[j]`` rounded
    to x.dtype; the dot accumulates in fp32."""
    sign = unpack_signs_kmajor(packed, dtype=torch.float32)     # [N, K]
    n = packed.shape[-1]
    z = torch.empty((x2.shape[0], n), dtype=torch.float32, device=x2.device)
    for j in range(g.shape[0]):
        cols = slice(j * seg_pad, min((j + 1) * seg_pad, n))
        y = (x2 * g[j]).float()
        z[:, cols] = y @ sign[cols].T
    return z * h


def _layernorm_segments_torch(z, bias, ns: int, seg_pad: int, n_true: int,
                              eps: float, dtype) -> torch.Tensor:
    """Two-pass fp32 row LayerNorm per segment -> ``[ns, M, n_true]``."""
    outs = []
    for j in range(ns):
        a = z[:, j * seg_pad:j * seg_pad + n_true].float()
        mean = a.mean(-1, keepdim=True)
        var = (a - mean).square().mean(-1, keepdim=True)
        r = (a - mean) * torch.rsqrt(var + eps)
        if bias is not None:
            r = r + bias
        outs.append(r.to(dtype))
    return torch.stack(outs)


def split_bf16x3(y: torch.Tensor):
    """The fp32 instance of K3's split of fp32 ``y = x ⊙ g`` into three bf16
    parts, ``hi = bf16(y)``, ``mid = bf16(y - hi)``, ``lo = bf16(y - hi -
    mid)``, as the kernel forms them in registers: together 24 mantissa
    bits, so ``hi + mid + lo == y`` wherever y's exponent leaves room for
    the parts (not near fp32's underflow). Each part's product with a ±1
    sign is exact, and the kernel sums the three products in fp32. A plain
    mirror of the kernel's arithmetic for the CPU tests; no path calls it."""
    hi = y.to(torch.bfloat16)
    r = y - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def large_m_block_n(n: int, ns: int) -> int:
    """K3's column tile for ``ns`` segments over ``n`` columns: 128, or 64
    where fused segments are not a multiple of 128, since a tile must not
    straddle a segment (its A operand depends on the segment's g). The
    kernel's launch applies the same rule (``block_n`` in
    ``csrc/bitlinear_large_m.cu``)."""
    return 128 if ns == 1 or (n // ns) % 128 == 0 else 64


def small_m_torch(x2, packed, g, h, bias=None, *, raw: bool = False,
                  eps: float = LN_EPS) -> torch.Tensor:
    n = packed.shape[-1]
    z = _project_torch(x2, packed, g[None], h, n)
    if raw:
        return z
    return _layernorm_segments_torch(z, bias, 1, n, n, eps, x2.dtype)[0]


def fused_small_m_torch(x2, packed, g, h, *, n_true: int,
                        eps: float = LN_EPS) -> torch.Tensor:
    ns = g.shape[0]
    seg_pad = packed.shape[-1] // ns
    z = _project_torch(x2, packed, g, h, seg_pad)
    return _layernorm_segments_torch(z, None, ns, seg_pad, n_true, eps,
                                     x2.dtype)


def large_m_torch(x2, packed, g, h, *, n_true: int, bias=None,
                  raw: bool = False, eps: float = LN_EPS) -> torch.Tensor:
    ns = g.shape[0]
    seg_pad = packed.shape[-1] // ns
    # z is stored in x.dtype, as _call_large_m stores it (bitlinear_pallas.py:632)
    z = _project_torch(x2, packed, g, h, seg_pad).to(x2.dtype)
    if raw:
        return z
    return _layernorm_segments_torch(z, bias, ns, seg_pad, n_true, eps,
                                     x2.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(x2, packed, g, h, bias, ns: int, n_true: int) -> None:
    if x2.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {x2.device}")
    if x2.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x2.device}, but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    tensors = [("x", x2), ("packed", packed), ("g", g), ("h", h)]
    if bias is not None:
        tensors.append(("bias", bias))
    for name, t in tensors:
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x2.dtype}")
    if g.dtype != x2.dtype:
        raise TypeError(f"g must be {x2.dtype}, got {g.dtype}")
    if packed.dtype != torch.int32:
        raise TypeError(f"packed must be int32, got {packed.dtype}")
    for name, t in (("h", h), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    m, k = x2.shape
    nw, n = packed.shape
    if m < 1 or k % WORD_BITS or nw * WORD_BITS != k:
        raise ValueError(f"x {tuple(x2.shape)} does not match packed "
                         f"{tuple(packed.shape)}")
    if g.shape != (ns, k) or h.shape != (n,):
        raise ValueError(f"g {tuple(g.shape)} / h {tuple(h.shape)} do not "
                         f"match ns={ns}, K={k}, N={n}")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} does not match N={n}")
    seg_pad = n // ns
    if ns > 1 and (seg_pad * ns != n or seg_pad % _SEG_ALIGN):
        raise ValueError(f"fused width {n} is not {ns} segments of a "
                         f"multiple of {_SEG_ALIGN}")
    if not 0 < n_true <= seg_pad:
        raise ValueError(f"n_true={n_true} outside (0, {seg_pad}]")


def _raise_on(err: int, kernel: KernelInfo) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA error {err} at launch")


@functools.cache
def _small_m_lib() -> ctypes.CDLL:
    lib = build.load(SMALL_M.library)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.onebit_bitlinear_small_m.argtypes = [p] * 7 + [i] * 5 + [f, p]
    lib.onebit_bitlinear_small_m.restype = i
    lib.onebit_bitlinear_fused_small_m.argtypes = [p] * 6 + [i] * 7 + [f, p]
    lib.onebit_bitlinear_fused_small_m.restype = i
    return lib


@functools.cache
def _large_m_lib() -> ctypes.CDLL:
    lib = build.load(LARGE_M.library)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.onebit_bitlinear_large_m.argtypes = [p] * 7 + [i] * 8 + [f, p]
    lib.onebit_bitlinear_large_m.restype = i
    lib.onebit_large_m_block_n.argtypes = [i, i]
    lib.onebit_large_m_block_n.restype = i
    return lib


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it starts on 16 bytes (K3's 16-byte copies), else a
    fresh copy, which does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def small_m(x2, packed, g, h, bias=None, *, raw: bool = False,
            eps: float = LN_EPS) -> torch.Tensor:
    """K1: ``x2 [M<=128, K]``, ``packed [K/32, N]``, ``g [K]`` (x.dtype),
    ``h [N]`` fp32, ``bias [N]`` fp32 or None -> ``[M, N]`` in x.dtype
    (with ``raw=True`` B4: fp32 ``z ⊙ h`` before the LayerNorm)."""
    if x2.device.type == "cpu":
        return small_m_torch(x2, packed, g, h, bias, raw=raw, eps=eps)
    _check(x2, packed, g[None], h, bias, 1, packed.shape[-1])
    m, k = x2.shape
    n = packed.shape[-1]
    if m > SMALL_M_MAX:
        raise ValueError(f"{SMALL_M.name} takes at most {SMALL_M_MAX} rows")
    z = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    out = z if raw else torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    err = _small_m_lib().onebit_bitlinear_small_m(
        x2.data_ptr(), g.data_ptr(), packed.data_ptr(), h.data_ptr(),
        _ptr(bias), z.data_ptr(), out.data_ptr(), m, k, n,
        _DTYPE_CODES[x2.dtype], int(raw), eps, _stream(x2))
    info = RAW_SMALL_M if raw else SMALL_M
    _raise_on(err, info)
    info.launches += 1
    return out


def fused_small_m(x2, packed, g, h, *, n_true: int,
                  eps: float = LN_EPS) -> torch.Tensor:
    """K2: ``x2 [M<=128, K]``, ``packed [K/32, ns*seg_pad]``, ``g [ns, K]``
    (x.dtype), ``h [ns*seg_pad]`` fp32 (0 on pads) -> ``[ns, M, n_true]``."""
    if x2.device.type == "cpu":
        return fused_small_m_torch(x2, packed, g, h, n_true=n_true, eps=eps)
    ns = g.shape[0]
    _check(x2, packed, g, h, None, ns, n_true)
    m, k = x2.shape
    n = packed.shape[-1]
    if m > SMALL_M_MAX:
        raise ValueError(f"{FUSED_SMALL_M.name} takes at most "
                         f"{SMALL_M_MAX} rows")
    z = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    out = torch.empty((ns, m, n_true), dtype=x2.dtype, device=x2.device)
    err = _small_m_lib().onebit_bitlinear_fused_small_m(
        x2.data_ptr(), g.data_ptr(), packed.data_ptr(), h.data_ptr(),
        z.data_ptr(), out.data_ptr(), m, k, n, ns, n // ns, n_true,
        _DTYPE_CODES[x2.dtype], eps, _stream(x2))
    _raise_on(err, FUSED_SMALL_M)
    FUSED_SMALL_M.launches += 1
    return out


def large_m(x2, packed, g, h, *, n_true: int, bias=None, raw: bool = False,
            eps: float = LN_EPS) -> torch.Tensor:
    """K3: ``x2 [M, K]`` (any M), ``packed [K/32, ns*seg_pad]``,
    ``g [ns, K]`` (x.dtype), ``h`` fp32, ``bias`` (ns = 1 only) ->
    ``[ns, M, n_true]`` in x.dtype (with ``raw=True`` B4:
    ``z ⊙ h [M, ns*seg_pad]`` in x.dtype). The column tile is
    :func:`large_m_block_n`'s."""
    if x2.device.type == "cpu":
        return large_m_torch(x2, packed, g, h, n_true=n_true, bias=bias,
                             raw=raw, eps=eps)
    ns = g.shape[0]
    if bias is not None and ns != 1:
        raise ValueError("bias is supported for a single projection only")
    _check(x2, packed, g, h, bias, ns, n_true)
    m, k = x2.shape
    n = packed.shape[-1]
    x2, g = _aligned16(x2), _aligned16(g)
    z = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    out = z if raw else torch.empty((ns, m, n_true), dtype=x2.dtype,
                                    device=x2.device)
    err = _large_m_lib().onebit_bitlinear_large_m(
        x2.data_ptr(), g.data_ptr(), packed.data_ptr(), h.data_ptr(),
        _ptr(bias), z.data_ptr(), out.data_ptr(), m, k, n, ns, n // ns,
        n_true, _DTYPE_CODES[x2.dtype], int(raw), eps, _stream(x2))
    if raw:
        info = RAW_LARGE_M
    else:
        info = LARGE_M_F32 if x2.dtype == torch.float32 else LARGE_M
    _raise_on(err, info)
    info.launches += 1
    return out
