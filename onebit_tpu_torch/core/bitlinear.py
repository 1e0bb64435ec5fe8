"""Reference OneBit linear math in PyTorch.

    y = LayerNorm_noaffine( ((x ⊙ g) · sign(W)ᵀ) ⊙ h ) (+ bias)

with ``g = input_factor [in]``, ``h = weight_scale [out]`` and LayerNorm over
the out-feature axis with no affine and torch's ``eps = 1e-5``. Counterpart
of ``onebit_tpu/core/bitlinear.py``. During QAT the latent full-precision
``W`` is kept and ``sign`` passes gradients through the reference's
soft-sign straight-through estimator (bitnet.py:14-24): the backward
multiplies by ``1.001 - tanh(W)²``.
"""

from __future__ import annotations

import torch

LN_EPS = 1e-5  # torch.nn.LayerNorm default, reference bitnet.py:47
STE_SLOPE_OFFSET = 1.001  # reference bitnet.py:23


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


def bitlinear_raw(x: torch.Tensor, sign_w: torch.Tensor, g: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """fp32 ``((x⊙g)·sign_wᵀ)⊙h`` on a dense ±1 sign matrix ``sign_w [out,
    in]``: ``x⊙g`` is rounded to ``x.dtype``, and so is the sign matrix
    (exact for ±1; its gradient is rounded there too, as JAX's cast does);
    the product accumulates in fp32 (the operands are upcast, so bf16
    products are exact, as in JAX's ``preferred_element_type=float32``)."""
    y = x * g.to(x.dtype)
    z = torch.matmul(y.float(), sign_w.to(x.dtype).float().transpose(-1, -2))
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
