"""Tensor-parallel BitLinear: one rank's shard of a column-parallel
projection, and the collectives of tensor-parallel training.

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

Training (``parallel/sharding.py`` on a ``(data, model)`` mesh) needs the
backward of every collective: the four autograd operators below, and the
two-pass LayerNorm of a column-parallel projection (:func:`tp_layernorm`)
and the row-parallel projection (:func:`row_parallel_train`) built on them.
"""

from __future__ import annotations

import torch

from onebit_tpu_torch.core.bitlinear import LN_EPS, layernorm_noaffine
from onebit_tpu_torch.kernels.bitlinear import bitlinear_packed_raw
from onebit_tpu_torch.parallel.mesh import DataGroup


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


# ---- the training side: Megatron's conjugate operators ---------------------
#
# A tensor-parallel training rank runs its own autograd graph. A value every
# rank of the model group holds whole (the residual stream, the losses) gets
# the whole gradient on every rank; a rank's shard (its out-features, its
# heads, its block of the vocabulary) gets only the gradient through that
# shard. So each collective's backward depends on what uses its result:
#
# * copy_to_model: before a column-parallel projection (q/k/v, gate/up, the
#   lm_head). Identity forward: the input is whole on every rank. All-reduce
#   backward: each rank's shard gives a part of ``dx``.
# * sum_stats: the LayerNorm statistics of a column-parallel projection.
#   All-reduce forward, and all-reduce backward: each rank's ``y`` shard
#   uses the global statistics, so their gradient is a sum over the shards.
# * reduce_from_model: the output of a row-parallel projection (o_proj,
#   down_proj) and a loss summed over heads. All-reduce forward, identity
#   backward: what follows is whole on every rank, which therefore already
#   holds the whole gradient. (``torch.distributed.nn.functional.
#   all_reduce`` sums the gradient here, and gives ``mp`` times it.)
# * gather_from_model: logits over a vocabulary split over the ranks.
#   All-gather forward, the rank's block of the gradient backward.
#
# Every collective runs on a copy: gloo reduces in place, and autograd may
# hold the input.


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, d):
        return ctx.group.all_reduce(d.clone()), None


class _SumStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, d):
        return ctx.group.all_reduce(d.clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return group.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, d):
        return d, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.n = group, t.shape[-1]
        blocks = DataGroup.of(group).all_gather(t[None])
        return torch.cat(blocks.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, d):
        return d.narrow(-1, ctx.group.rank * ctx.n, ctx.n), None


def copy_to_model(x, group):
    """``x`` (whole on every rank) into column-parallel projections."""
    return _CopyToModel.apply(x, group) if group.size > 1 else x


def sum_stats(t, group):
    """The sum over the ranks of per-row statistics that every rank's shard
    uses (a column-parallel LayerNorm's)."""
    return _SumStats.apply(t, group) if group.size > 1 else t


def reduce_from_model(t, group):
    """The sum over the ranks of partial results whose consumers are whole
    on every rank (a row-parallel product, a loss over split heads)."""
    return _ReduceFromModel.apply(t, group) if group.size > 1 else t


def gather_from_model(t, group):
    """Every rank's ``t`` concatenated along the last axis, rank order."""
    return _GatherFromModel.apply(t, group) if group.size > 1 else t


def tp_layernorm(zs, group, n_totals, eps: float = LN_EPS):
    """The LayerNorm of training over out-features split across the ranks,
    for several column-parallel projections of one input (fp32 ``zs``, the
    rank's ``[..., N_j/mp]`` each): the two-pass form of the single-device
    ``layernorm_noaffine``, the mean's sums in one all-reduce, then the
    centred squares' sums in another, both differentiable
    (:func:`sum_stats`). JAX trains the single-device program under GSPMD,
    two-pass; the one-pass moments of :func:`moment_layernorm` stay the
    serving form. The two-pass form is kept so that the step computes
    JAX's arithmetic; it costs one more all-reduce of ``[..., ns]`` a
    layer half."""
    s1 = sum_stats(torch.stack([z.sum(-1) for z in zs], -1), group)
    cs = [z - s1[..., j, None] / n
          for j, (z, n) in enumerate(zip(zs, n_totals))]
    s2 = sum_stats(torch.stack([c.square().sum(-1) for c in cs], -1), group)
    return [c * torch.rsqrt(s2[..., j, None] / n + eps)
            for j, (c, n) in enumerate(zip(cs, n_totals))]


def row_parallel_train(x_loc, sign_loc, g_loc, h, bias, group,
                       eps: float = LN_EPS):
    """A row-parallel BitLinear of training: ``x_loc [..., K/mp]``, the
    signs ``[N, K/mp]`` and ``g_loc`` the rank's in-feature block; the fp32
    partial products summed over the ranks (:func:`reduce_from_model`),
    then ``⊙ h``, the LayerNorm and the bias on every rank: the order of
    ``core/bitlinear.py`` ``bitlinear_fwd``, whose ``h`` follows the
    product. Returns x.dtype."""
    y = x_loc * g_loc.to(x_loc.dtype)
    p = torch.matmul(y.float(),
                     sign_loc.to(x_loc.dtype).float().transpose(-1, -2))
    z = layernorm_noaffine(reduce_from_model(p, group) * h.float(), eps)
    if bias is not None:
        z = z + bias.float()
    return z.to(x_loc.dtype)
