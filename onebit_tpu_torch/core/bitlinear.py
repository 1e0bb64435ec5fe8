"""Reference OneBit linear math in PyTorch.

    y = LayerNorm_noaffine( ((x ⊙ g) · sign(W)ᵀ) ⊙ h ) (+ bias)

with ``g = input_factor [in]``, ``h = weight_scale [out]`` and LayerNorm over
the out-feature axis with no affine and torch's ``eps = 1e-5``. Counterpart
of ``onebit_tpu/core/bitlinear.py``; the straight-through sign and the
latent (training) mode wait for the training slice.
"""

from __future__ import annotations

import torch

LN_EPS = 1e-5  # torch.nn.LayerNorm default, reference bitnet.py:47


def layernorm_noaffine(x: torch.Tensor, eps: float = LN_EPS,
                       dim: int = -1) -> torch.Tensor:
    """LayerNorm without affine, biased variance; fp32 statistics, cast back."""
    x32 = x.float()
    mean = x32.mean(dim, keepdim=True)
    var = (x32 - mean).square().mean(dim, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def bitlinear_fwd(x: torch.Tensor, sign_w: torch.Tensor, g: torch.Tensor,
                  h: torch.Tensor, bias=None, *, eps: float = LN_EPS
                  ) -> torch.Tensor:
    """OneBit linear on a dense ±1 sign matrix ``sign_w [out, in]``.

    ``x⊙g`` is rounded to ``x.dtype``; the product accumulates in fp32 (the
    operands are upcast, so bf16 products are exact, as in JAX's
    ``preferred_element_type=float32``). Returns ``x.dtype``.
    """
    y = x * g.to(x.dtype)
    z = torch.matmul(y.float(), sign_w.float().transpose(-1, -2))
    z = layernorm_noaffine(z * h.float(), eps)
    if bias is not None:
        z = z + bias.float()
    return z.to(x.dtype)
