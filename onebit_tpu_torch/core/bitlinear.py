"""Reference OneBit linear math in PyTorch.

    y = LayerNorm_noaffine( ((x ⊙ g) · sign(W)ᵀ) ⊙ h ) (+ bias)

with ``g = input_factor [in]``, ``h = weight_scale [out]`` and LayerNorm over
the out-feature axis with no affine and torch's ``eps = 1e-5``. Counterpart
of ``onebit_tpu/core/bitlinear.py``. During QAT the latent full-precision
``W`` is kept and ``sign`` passes gradients through the reference's
soft-sign straight-through estimator (bitnet.py:14-24): the backward
multiplies by ``1.001 - tanh(W)²``.

The product ``(x ⊙ g) · sign(W)ᵀ`` (:func:`project_f32`, also the FP
teacher's ``kernels/linear.py``) accumulates in fp32 and returns fp32, as
JAX's ``preferred_element_type=float32``. On bf16 operands on the card it
runs on the tensor cores (:class:`_Bf16Product`); on fp32 operands, and on
the CPU, as the fp32 product of the upcast operands.
"""

from __future__ import annotations

import torch

from onebit_tpu_torch.utils.device import on_card

LN_EPS = 1e-5  # torch.nn.LayerNorm default, reference bitnet.py:47
STE_SLOPE_OFFSET = 1.001  # reference bitnet.py:23
BF16_MAX = torch.finfo(torch.bfloat16).max

# Projection products by path, one a forward (its backward's products take
# the same path): bf16 on the tensor cores, or fp32 on upcast operands.
tensor_core_products = 0
fp32_products = 0


class _SignSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        ctx.save_for_backward(w)
        return torch.sign(w)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g * (STE_SLOPE_OFFSET - torch.tanh(w) ** 2)


def sign_ste(w: torch.Tensor) -> torch.Tensor:
    """``sign(w)`` (``sign(0) = 0``) with the reference's soft-sign
    straight-through gradient ``g · (1.001 − tanh(w)²)``."""
    return _SignSTE.apply(w)


def layernorm_noaffine(x: torch.Tensor, eps: float = LN_EPS,
                       dim: int = -1) -> torch.Tensor:
    """LayerNorm without affine, biased variance; fp32 statistics, cast back."""
    x32 = x.float()
    mean = x32.mean(dim, keepdim=True)
    var = (x32 - mean).square().mean(dim, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b`` of two bf16 matrices, accumulated in fp32: on the card
    one tensor-core product with an fp32 result (``aten::mm.dtype``; a fake
    tensor of a memory plan makes its shape); on the CPU, which has no such
    product, the product of the fp32 upcasts, the same function (products of
    bf16 values are exact in fp32; only the order of the sums differs)."""
    if on_card(a):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def split_bf16(d: torch.Tensor, out: torch.Tensor) -> None:
    """Write fp32 ``d [M, N]`` into ``out [M, 2N]`` bf16 as ``hi | lo``:
    ``hi = bf16(d)`` (finite values past bf16's largest held at it), ``lo
    = bf16(d - hi)``. ``hi + lo`` is ``d`` to within ``2⁻¹⁷·|d|`` (and
    ``2⁻¹³⁴``, half bf16's least subnormal step, for the tiniest ``d``);
    infinities and NaNs carry through."""
    n = d.shape[-1]
    hi, lo = out[:, :n], out[:, n:]
    hi.copy_(d)
    torch.nan_to_num_(hi, nan=float("nan"), posinf=BF16_MAX,
                      neginf=-BF16_MAX)
    torch.sub(d, hi, out=lo)


class _Bf16Product(torch.autograd.Function):
    """fp32 ``a · bᵀ`` of bf16 ``a [M, K]`` and ``b [N, K]`` on the tensor
    cores. The backward gets an fp32 ``dZ`` and rounds each gradient to
    bf16 once (``a`` and ``b`` are bf16); it splits ``dZ`` into two bf16
    parts (:func:`split_bf16`) and takes each gradient as one product over
    the doubled reduction axis: ``da = [hi | lo] · [b; b]``, ``db = [hi |
    lo]ᵀ · a`` with ``(m, part)`` rows against ``a``'s rows twice. Only the
    bf16 operands are saved."""

    @staticmethod
    def forward(ctx, a, b):
        da, db = ctx.needs_input_grad
        ctx.save_for_backward(a if db else None, b if da else None)
        return _mm_f32(a, b.T)

    @staticmethod
    def backward(ctx, dz):
        a, b = ctx.saved_tensors
        m, n = dz.shape
        d2 = torch.empty((m, 2 * n), dtype=torch.bfloat16, device=dz.device)
        split_bf16(dz, d2)
        da = db = None
        if b is not None:
            da = _mm_f32(d2, torch.cat([b, b])).to(b.dtype)
        if a is not None:
            a2 = a.unsqueeze(1).expand(m, 2, a.shape[1]).reshape(2 * m, -1)
            db = _mm_f32(d2.view(2 * m, n).T, a2).to(a.dtype)
        return da, db


def _on_tensor_cores(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype == torch.bfloat16 and on_card(a)


def project_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ``a · wᵀ`` of ``a [..., K]`` and ``w [N, K]`` of one dtype,
    accumulated in fp32: bf16 operands on the card take the tensor cores
    (:class:`_Bf16Product`), any others the fp32 product of the upcast
    operands. Counted in ``tensor_core_products`` or ``fp32_products``."""
    global tensor_core_products, fp32_products
    if _on_tensor_cores(a, w):
        tensor_core_products += 1
        z = _Bf16Product.apply(a.reshape(-1, a.shape[-1]), w)
        return z.reshape(*a.shape[:-1], w.shape[0])
    fp32_products += 1
    return torch.matmul(a.float(), w.float().transpose(-1, -2))


def bitlinear_raw(x: torch.Tensor, sign_w: torch.Tensor, g: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """fp32 ``((x⊙g)·sign_wᵀ)⊙h`` on a dense ±1 sign matrix ``sign_w [out,
    in]``: ``x⊙g`` is rounded to ``x.dtype``, and so is the sign matrix
    (exact for ±1; its gradient is rounded there too, as JAX's cast does);
    the product (:func:`project_f32`) accumulates in fp32, as JAX's
    ``preferred_element_type=float32``: on the tensor cores for bf16 on the
    card, else on the fp32 upcasts."""
    y = x * g.to(x.dtype)
    z = project_f32(y, sign_w.to(x.dtype))
    return z * h.float()


def bitlinear_fwd(x: torch.Tensor, sign_w: torch.Tensor, g: torch.Tensor,
                  h: torch.Tensor, bias=None, *, eps: float = LN_EPS
                  ) -> torch.Tensor:
    """OneBit linear on a dense ±1 sign matrix ``sign_w [out, in]``:
    :func:`bitlinear_raw`, then the LayerNorm in fp32. Returns
    ``x.dtype``."""
    z = layernorm_noaffine(bitlinear_raw(x, sign_w, g, h), eps)
    if bias is not None:
        z = z + bias.float()
    return z.to(x.dtype)


def bitlinear_train_fwd(x, latent_w, g, h, bias=None, *, eps: float = LN_EPS):
    """QAT forward: latent fp weight -> sign through the STE -> the OneBit
    linear."""
    return bitlinear_fwd(x, sign_ste(latent_w), g, h, bias, eps=eps)
