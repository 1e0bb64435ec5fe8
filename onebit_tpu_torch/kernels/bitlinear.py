"""BitLinear dispatch: which kernel, or its plain version, serves a call.

Port of ``onebit_tpu/kernels/bitlinear.py``, its three weight modes:

* ``latent``: the full-precision latent weight ``[out, in]`` of training
  (QAT), its sign taken through the straight-through estimator
  (``core/bitlinear.py``). No kernel: a plain fp32-accumulated matmul, as
  the JAX package leaves it to XLA (``kernels/bitlinear.py:185-192``);
* ``dense_sign``: a materialized ±1 matrix;
* ``packed``: int32 sign words in the port's K-major layout ``[in//32,
  out]`` (``core/packing.py``), served by the kernels.

``impl``:

* ``"auto"``: the kernel wrappers of ``kernels/bitlinear_cuda.py``, which
  launch the CUDA kernel for CUDA tensors and run the plain version for CPU
  tensors;
* ``"torch"``: always the plain versions (unpack, then matmul), on any
  device. On the card only comparisons use it.

Dispatch follows the JAX thresholds: M <= 128 rows take the small-M kernels
(K1, K2), larger M the large-M kernel K3 and its LayerNorm
(``bitlinear_pallas.py:365-377, 533-539``). In torch ``packed[i]`` is a view,
so each ``_stacked`` variant is the unstacked call on layer ``i``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from onebit_tpu_torch.core.bitlinear import (LN_EPS, bitlinear_fwd,
                                             bitlinear_raw, sign_ste)
from onebit_tpu_torch.kernels import bitlinear_cuda as bc


class BitLinearWeights(NamedTuple):
    """One BitLinear projection; exactly one of ``latent``/``dense_sign``/
    ``packed``. The fields follow the JAX class's order, which is the order
    of a native checkpoint's arrays."""
    weight_scale: torch.Tensor                  # h [out]
    input_factor: torch.Tensor                  # g [in]
    latent: Optional[torch.Tensor] = None       # [out, in] fp
    dense_sign: Optional[torch.Tensor] = None   # [out, in] ±1
    packed: Optional[torch.Tensor] = None       # [in//32, out] int32
    bias: Optional[torch.Tensor] = None         # [out]

    @property
    def mode(self) -> str:
        if self.latent is not None:
            return "latent"
        if self.packed is not None:
            return "packed"
        if self.dense_sign is not None:
            return "dense_sign"
        raise ValueError("empty BitLinearWeights")


class FusedBitLinearWeights(NamedTuple):
    """``ns`` packed projections of equal width sharing one input,
    concatenated along N, each segment zero-padded to
    ``seg_pad = packed.shape[-1] // ns`` with ``h = 0`` on the pads."""
    weight_scale: torch.Tensor   # [ns*seg_pad] fp32
    input_factor: torch.Tensor   # [ns, in]
    packed: torch.Tensor         # [in//32, ns*seg_pad] int32

    @property
    def ns(self) -> int:
        return self.input_factor.shape[-2]


def _ops(impl: str):
    if impl == "auto":
        return bc.small_m, bc.fused_small_m, bc.large_m
    if impl == "torch":
        return bc.small_m_torch, bc.fused_small_m_torch, bc.large_m_torch
    raise ValueError(f"impl must be 'auto' or 'torch', got {impl!r}")


def _pick_layer(w, layer: int):
    return type(w)(*(None if a is None else a[layer] for a in w))


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def _opt_f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float().contiguous()


def bitlinear_apply(x: torch.Tensor, w: BitLinearWeights, *,
                    impl: str = "auto", eps: float = LN_EPS) -> torch.Tensor:
    """``x [..., in]`` -> ``[..., out]`` in x.dtype. The latent and
    dense-sign modes take the plain math whatever ``impl`` says."""
    if w.mode != "packed":
        sign_w = sign_ste(w.latent) if w.mode == "latent" else w.dense_sign
        return bitlinear_fwd(x, sign_w, w.input_factor, w.weight_scale,
                             bias=w.bias, eps=eps)
    small, _, large = _ops(impl)
    x2 = _rows(x)
    n = w.packed.shape[-1]
    g = w.input_factor.to(x.dtype).contiguous()
    h, bias = _opt_f32(w.weight_scale), _opt_f32(w.bias)
    if x2.shape[0] <= bc.SMALL_M_MAX:
        out = small(x2, w.packed, g, h, bias, eps=eps)
    else:
        out = large(x2, w.packed, g[None], h, n_true=n, bias=bias, eps=eps)[0]
    return out.reshape(*x.shape[:-1], n)


def fused_bitlinear_apply(x: torch.Tensor, w: FusedBitLinearWeights,
                          n_true: int, *, impl: str = "auto",
                          eps: float = LN_EPS) -> List[torch.Tensor]:
    """Apply ``ns`` fused projections -> list of ``ns`` ``[..., n_true]``."""
    _, fused, large = _ops(impl)
    x2 = _rows(x)
    g = w.input_factor.to(x.dtype).contiguous()
    h = _opt_f32(w.weight_scale)
    if x2.shape[0] <= bc.SMALL_M_MAX:
        out = fused(x2, w.packed, g, h, n_true=n_true, eps=eps)
    else:
        out = large(x2, w.packed, g, h, n_true=n_true, eps=eps)
    return [o.reshape(*x.shape[:-1], n_true) for o in out]


def bitlinear_apply_stacked(x, w: BitLinearWeights, layer: int, *,
                            impl: str = "auto", eps: float = LN_EPS):
    """Layer ``layer`` of a stacked BitLinear (leaves ``[L, ...]``)."""
    return bitlinear_apply(x, _pick_layer(w, layer), impl=impl, eps=eps)


def fused_bitlinear_apply_stacked(x, w: FusedBitLinearWeights, layer: int,
                                  n_true: int, *, impl: str = "auto",
                                  eps: float = LN_EPS):
    """Layer ``layer`` of stacked fused projections."""
    return fused_bitlinear_apply(x, _pick_layer(w, layer), n_true,
                                 impl=impl, eps=eps)


def bitlinear_packed_raw(x, packed, g, h, *, impl: str = "auto"
                         ) -> torch.Tensor:
    """``((x⊙g)·Sᵀ)⊙h`` without the LayerNorm on packed signs ``[K/32, N]``:
    B4 (``bitlinear_pallas.py:723``), the projection of a tensor-parallel
    shard, whose LayerNorm runs after the cross-shard reduction. fp32 for
    M <= 128 rows; above, in x.dtype, as the large-M kernel stores it."""
    small, _, large = _ops(impl)
    x2 = _rows(x)
    n = packed.shape[-1]
    g = g.to(x.dtype).contiguous()
    h = _opt_f32(h)
    if x2.shape[0] <= bc.SMALL_M_MAX:
        z = small(x2, packed, g, h, raw=True)
    else:
        z = large(x2, packed, g[None], h, n_true=n, raw=True)
    return z.reshape(*x.shape[:-1], n)


def bitlinear_apply_stacked_raw(x, w: BitLinearWeights, layer: int, *,
                                impl: str = "auto") -> torch.Tensor:
    """Layer ``layer`` of a stacked BitLinear without the LayerNorm: fp32
    ``((x⊙g)·Sᵀ)⊙h`` (``bitlinear_pallas.py:691``), the shard projection of
    the tensor-parallel layers (``model/tp_decode.py``); above 128 rows it
    is rounded to x.dtype first, as JAX's large-M kernel rounds it. Latent
    and dense-sign weights take the plain math."""
    wl = _pick_layer(w, layer)
    if wl.mode != "packed":
        sign_w = sign_ste(wl.latent) if wl.mode == "latent" \
            else wl.dense_sign
        return bitlinear_raw(x, sign_w, wl.input_factor, wl.weight_scale)
    return bitlinear_packed_raw(x, wl.packed, wl.input_factor,
                                wl.weight_scale, impl=impl).float()
