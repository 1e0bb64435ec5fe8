"""SVID: Sign-Value-Independent Decomposition initialization.

Port of ``onebit_tpu/core/svid.py``. For each linear weight ``W [out, in]``
the start checkpoint takes a rank-1 nonnegative factorization ``|W| ≈ h·gᵀ``
(the reference's sklearn ``NMF(n_components=1)``,
scripts/build_start_ckpt.py:21-34) and sets

    input_factor  g = H[0, :]        (len in)
    weight_scale  h = W_nmf[:, 0]    (len out)
    latent weight  = sign(W) * 0.01

By Perron-Frobenius the best rank-1 nonnegative approximation of a
nonnegative matrix is its leading singular pair, so :func:`rank1_power`
computes it by power iteration, batched over any leading axes (the stacked
layers of one projection family). :func:`rank1_nmf` runs the multiplicative
updates of the reference's algorithm family; it reaches the same fixed
point up to how the scale is split between h and g, which the forward
``LayerNorm(((x⊙g)·sign(W)ᵀ)⊙h)`` does not see (a scalar on h is normalized
away), so tests hold ``h·gᵀ`` against the JAX function's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

LATENT_SIGN_SCALE = 0.01  # reference build_start_ckpt.py:34


class SVIDResult(NamedTuple):
    sign_w: torch.Tensor        # ±1, [out, in]
    weight_scale: torch.Tensor  # h, [out]
    input_factor: torch.Tensor  # g, [in]


def rank1_power(a_abs: torch.Tensor, num_iters: int = 50
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leading singular pair of nonnegative ``a_abs [..., out, in]`` by power
    iteration -> ``(h [..., out], g [..., in])`` with ``a ≈ h gᵀ``, the
    singular value folded into ``h``. The JAX function's iteration, step
    for step, on each matrix of the leading axes at once."""
    a = a_abs.float()
    inp = a.shape[-1]
    g = torch.full((*a.shape[:-2], inp), 1.0 / inp ** 0.5,
                   dtype=torch.float32, device=a.device)

    def matvec(m, v):
        return torch.matmul(m, v[..., None])[..., 0]

    at = a.transpose(-1, -2)
    for _ in range(num_iters):
        h = matvec(a, g)
        h = h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-30)
        g = matvec(at, h)
        g = g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-30)
    return matvec(a, g), g


def rank1_nmf(a_abs: torch.Tensor, num_iters: int = 200,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-1 NMF of nonnegative ``a_abs [out, in]`` by multiplicative
    updates -> ``(h, g)``. The start is drawn from ``generator`` (JAX draws
    it from ``jax.random``, which torch cannot repeat); the fixed point is
    :func:`rank1_power`'s."""
    a = a_abs.float()
    out, inp = a.shape
    scale = a.mean().sqrt()
    h = torch.randn(out, generator=generator, device=a.device).abs() * scale
    g = torch.randn(inp, generator=generator, device=a.device).abs() * scale
    for _ in range(num_iters):
        h = h * (a @ g) / (h * (g @ g) + 1e-30)
        g = g * (a.T @ h) / (g * (h @ h) + 1e-30)
    return h, g


def svid(w: torch.Tensor, method: str = "power", num_iters: int = 50,
         generator: Optional[torch.Generator] = None) -> SVIDResult:
    """Decompose a full-precision weight into (sign matrix, h, g)."""
    a_abs = w.abs().float()
    if method == "power":
        h, g = rank1_power(a_abs, num_iters=num_iters)
    elif method == "nmf":
        h, g = rank1_nmf(a_abs, num_iters=max(num_iters, 200),
                         generator=generator)
    else:
        raise ValueError(f"unknown SVID method {method!r}")
    return SVIDResult(sign_w=torch.sign(w), weight_scale=h, input_factor=g)


def svid_latent_init(w: torch.Tensor, method: str = "power",
                     num_iters: int = 50,
                     generator: Optional[torch.Generator] = None):
    """Start-checkpoint init: latent weight = sign(W)·0.01, plus (h, g)."""
    r = svid(w, method=method, num_iters=num_iters, generator=generator)
    latent = (r.sign_w * LATENT_SIGN_SCALE).float()
    return latent, r.weight_scale, r.input_factor
