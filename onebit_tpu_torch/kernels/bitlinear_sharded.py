"""Tensor-parallel BitLinear: one rank's shard of a column-parallel
projection.

Port of ``onebit_tpu/kernels/bitlinear_sharded.py``. The out-feature axis is
split over the ranks of a :class:`~onebit_tpu_torch.parallel.mesh.TPGroup`:
each rank holds ``packed [K/32, N/mp]`` and ``h [N/mp]``, runs B4 (the raw
projection, no LayerNorm) on the replicated ``x``, and the LayerNorm over
the sharded axis needs only two numbers per row from every rank:

    local:       s1 = Σ z_local,  s2 = Σ z_local²     (per row)
    all-reduce:  S1, S2 over the ranks
    local:       y = (z - S1/N) * rsqrt(S2/N - (S1/N)² + eps)

This one-pass variance is the form JAX's TP uses; it is not swapped for the
two-pass LayerNorm of the single-device kernels, so the port's TP stays the
JAX TP's arithmetic.
"""

from __future__ import annotations

import torch

from onebit_tpu_torch.core.bitlinear import LN_EPS
from onebit_tpu_torch.kernels.bitlinear import bitlinear_packed_raw


def moment_layernorm(zs, group, n_totals, eps: float = LN_EPS):
    """The distributed LayerNorm of several column-parallel projections of
    one input, ``zs`` (fp32 ``[..., N_j/mp]`` each, over ``n_totals[j]``
    full features): their per-row moments cross the ranks in ONE
    all-reduce. Returns the normalised fp32 shards."""
    moments = torch.stack([m for z in zs
                           for m in (z.sum(-1), z.square().sum(-1))], -1)
    group.all_reduce(moments)
    out = []
    for j, (z, n) in enumerate(zip(zs, n_totals)):
        mean = moments[..., 2 * j, None] / n
        var = moments[..., 2 * j + 1, None] / n - mean.square()
        out.append((z - mean) * torch.rsqrt(var + eps))
    return out


def bitlinear_tp_shard(x, packed, g, h, bias=None, *, group,
                       eps: float = LN_EPS, impl: str = "auto"):
    """This rank's ``[..., N/mp]`` of a column-parallel BitLinear:
    ``x [..., K]`` replicated, ``packed [K/32, N/mp]`` and ``h [N/mp]`` (and
    ``bias [N/mp]``) the rank's out-feature shard, ``g [K]`` replicated
    (``bitlinear_sharded.py:32-65``). Returns x.dtype."""
    z = bitlinear_packed_raw(x, packed, g, h, impl=impl).float()
    out = moment_layernorm([z], group, [packed.shape[-1] * group.size],
                           eps)[0]
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
