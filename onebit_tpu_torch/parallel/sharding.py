"""Fully sharded data parallelism: which leaf is split over the ranks of
the data axis, the ranks' shards, and a rank's forward over them.

Port of ``onebit_tpu/parallel/sharding.py`` on meshes ``(N, 1)``. JAX
shards every big plane over ``data`` as well as ``model``, so that params,
optimizer moments and the teacher are split over all N ranks (ZeRO-3), and
GSPMD gathers a layer's shards at use and reduce-scatters its gradient.
The port does both by hand, one process a rank (``parallel/mesh.py``
``DataGroup``). Its layout is its own; what matches JAX is the function
computed:

* a split leaf is cut into N equal blocks along one axis, block ``r`` on
  rank ``r``: axis 1 of a stacked layer plane (``[L, out, in]`` latent or
  teacher weights, ``[L, in/32, out]`` packed words), so that layer ``i``'s
  shard is one contiguous block, and axis 0 (the vocabulary) of
  ``embed_tokens`` and ``lm_head``;
* a leaf that does not divide by N, and every vector (norms, ``h``, ``g``),
  stays whole on every rank (``_shardable``'s rule);
* :func:`sharded_proj` is a rank's decoder strategy (``model/bitllama.py``
  ``Proj``): each projection gathers layer ``i``'s shards when it runs, in
  the forward and again in a remat's recomputation, and frees them after.
  A latent weight's gather moves its signs, in the compute dtype; its
  backward reduce-scatters the signs' gradient in fp32 and multiplies the
  shard by the straight-through factor ``1.001 − tanh(w)²`` (elementwise
  and the same on every rank, so it commutes with the sum over ranks),
  adding the result to the rank's gradient shard (:class:`ShardGrads`).
  So neither a full latent weight nor its full gradient outlives its
  layer.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from onebit_tpu_torch.core.bitlinear import STE_SLOPE_OFFSET
from onebit_tpu_torch.kernels.bitlinear import (BitLinearWeights,
                                                FusedBitLinearWeights,
                                                bitlinear_apply)
from onebit_tpu_torch.kernels.linear import LinearWeights, linear_apply
from onebit_tpu_torch.model.bitllama import Proj, _lm_head, rms_norm
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.parallel.mesh import DataGroup

Layout = Dict[str, int]      # native key -> the axis split over the ranks


def named_leaves(params: Dict[str, Any]) -> Iterator[Tuple[str, Any]]:
    """``(native checkpoint key, tensor)`` of every leaf: ``embed_tokens``,
    ``lm_head``, ``final_norm``, ``layers.<norm>``,
    ``layers.<projection>.<field>``."""
    for key in ("embed_tokens", "lm_head", "final_norm"):
        yield key, params[key]
    for name, val in params["layers"].items():
        if isinstance(val, tuple):
            for field, arr in val._asdict().items():
                if arr is not None:
                    yield f"layers.{name}.{field}", arr
        else:
            yield f"layers.{name}", val


def map_leaves(params: Dict[str, Any], fn) -> Dict[str, Any]:
    """The tree with each leaf ``t`` replaced by ``fn(key, t)``."""
    out = {k: fn(k, params[k]) for k in params if k != "layers"}
    layers = {}
    for name, val in params["layers"].items():
        if isinstance(val, tuple):
            layers[name] = type(val)(*(
                None if a is None else fn(f"layers.{name}.{f}", a)
                for f, a in zip(val._fields, val)))
        else:
            layers[name] = fn(f"layers.{name}", val)
    out["layers"] = layers
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Invert :func:`named_leaves`: a projection's wrapper follows from its
    field names, as ``onebit_tpu/ckpt/sharded.py`` ``_rewrap`` infers it."""
    tree: Dict[str, Any] = {"layers": {}}
    fields: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, val in flat.items():
        if not key.startswith("layers."):
            tree[key] = val
            continue
        rest = key[len("layers."):]
        if "." in rest:
            name, field = rest.split(".", 1)
            fields.setdefault(name, {})[field] = val
        else:
            tree["layers"][rest] = val
    for name, fd in fields.items():
        keys = set(fd)
        if keys <= set(LinearWeights._fields) and "weight" in keys:
            tree["layers"][name] = LinearWeights(**fd)
        elif (keys <= set(FusedBitLinearWeights._fields)
              and fd["input_factor"].dim() >= 3):
            tree["layers"][name] = FusedBitLinearWeights(**fd)
        else:
            tree["layers"][name] = BitLinearWeights(**fd)
    return tree


def split_axis(key: str, shape) -> Optional[int]:
    """The axis a leaf of this key and full shape is split on, before the
    divisibility check: 1 for a stacked layer plane, 0 for the embedding
    and the lm_head, None (whole on every rank) for vectors."""
    if key.startswith("layers."):
        return 1 if len(shape) >= 3 else None
    return 0 if len(shape) == 2 else None


def param_layout(shapes: Dict[str, Any], n: int) -> Layout:
    """The leaves split over ``n`` ranks, ``{key: axis}``, from a tree of
    full-shaped leaves or a ``{key: shape}`` dict: :func:`split_axis`'s
    axis where it divides by ``n`` (``param_specs`` with ``_shardable``)."""
    items = (named_leaves(shapes) if "layers" in shapes
             else shapes.items())
    layout = {}
    for key, leaf in items:
        shape = tuple(getattr(leaf, "shape", leaf))
        axis = split_axis(key, shape)
        if axis is not None and shape[axis] % n == 0:
            layout[key] = axis
    return layout


def block(t: torch.Tensor, axis: int, n: int, rank: int,
          device) -> torch.Tensor:
    """Block ``rank`` of ``n`` along ``axis``: a contiguous copy on
    ``device`` (never a view that keeps the full tensor alive)."""
    k = t.shape[axis] // n
    return t.detach().narrow(axis, rank * k, k).to(
        device=device, copy=True, memory_format=torch.contiguous_format)


def local_shape(shape, axis: Optional[int], n: int) -> tuple:
    shape = list(shape)
    if axis is not None:
        shape[axis] //= n
    return tuple(shape)


def shard_params(params: Dict[str, Any], group: DataGroup,
                 layout: Optional[Layout] = None) -> Dict[str, Any]:
    """This rank's tree of a full tree (``shard_params`` of JAX, :106-111):
    block ``group.rank`` of every split leaf, the rest whole, all on
    ``group.device``, every leaf a copy. ``layout`` defaults to
    :func:`param_layout`'s."""
    if layout is None:
        layout = param_layout(params, group.size)

    def place(key, t):
        if key in layout:
            return block(t, layout[key], group.size, group.rank,
                         group.device)
        return t.detach().to(group.device, copy=True)
    return map_leaves(params, place)


def gather_leaf(t: torch.Tensor, axis: Optional[int],
                group: DataGroup) -> torch.Tensor:
    """The full leaf from every rank's block along ``axis`` (collective;
    ``t`` itself when it is whole)."""
    if axis is None:
        return t
    moved = t.detach().movedim(axis, 0)
    return group.all_gather(moved).movedim(0, axis).contiguous()


def gather_params(params: Dict[str, Any], layout: Layout,
                  group: DataGroup, *, dst: Optional[int] = None
                  ) -> Optional[Dict[str, Any]]:
    """The full tree from the ranks' trees, a leaf at a time (a collective:
    every rank calls it). Every rank gets the tree on its device or, with
    ``dst``, rank ``dst`` alone on the host and the others None."""
    keep = dst is None or group.rank == dst

    def full(key, t):
        out = gather_leaf(t, layout.get(key), group)
        return out if dst is None else (out.cpu() if keep else None)
    tree = map_leaves(params, full)
    return tree if keep else None


class ShardGrads:
    """A rank's gradient shards of its split trainable leaves, a layer at
    a time: ``grads[key][i]`` is layer ``i``'s fp32 shard, made when the
    backward first reaches the layer (so the backward's early layers do
    not hold the whole leaf's gradient), or None."""

    def __init__(self):
        self.grads: Dict[str, list] = {}

    def add(self, key: str, leaf: torch.Tensor, i: int,
            part: torch.Tensor) -> None:
        layers = self.grads.setdefault(key, [None] * leaf.shape[0])
        layers[i] = part if layers[i] is None else layers[i] + part


class _GatherSigns(torch.autograd.Function):
    """Layer ``i`` of a split latent plane -> its full signs in ``dtype``
    (the straight-through sign of ``core/bitlinear.py`` ``sign_ste``, with
    the gather between); the backward reduce-scatters the signs' gradient
    and adds its shard, times the straight-through factor, to ``grads``."""

    @staticmethod
    def forward(ctx, stack, i, dtype, group, grads, key):
        ctx.i, ctx.group, ctx.grads, ctx.key = i, group, grads, key
        ctx.save_for_backward(stack)
        return group.all_gather(torch.sign(stack[i]).to(dtype))

    @staticmethod
    def backward(ctx, d):
        (stack,) = ctx.saved_tensors
        part = ctx.group.reduce_scatter(d.float())
        w = stack[ctx.i].detach()
        ctx.grads.add(ctx.key, stack, ctx.i,
                      part * (STE_SLOPE_OFFSET - torch.tanh(w) ** 2))
        return None, None, None, None, None, None


def _layer_weights(w, name: str, i: int, layout: Layout, group: DataGroup,
                   dtype, grads: Optional[ShardGrads]):
    """Layer ``i`` of projection ``name`` with its split fields gathered:
    a split latent becomes its gathered signs (``dense_sign``)."""
    fields = {}
    for field, a in zip(w._fields, w):
        if a is None:
            continue
        key = f"layers.{name}.{field}"
        if key not in layout:
            fields[field] = a[i]
        elif field == "latent":
            if a.requires_grad and torch.is_grad_enabled():
                if grads is None:
                    raise ValueError("a trainable split leaf needs a "
                                     "ShardGrads to take its gradient")
                fields["dense_sign"] = _GatherSigns.apply(
                    a, i, dtype, group, grads, key)
            else:
                fields["dense_sign"] = group.all_gather(
                    torch.sign(a[i].detach()).to(dtype))
        elif a.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{key}: a trainable split leaf must be a "
                             f"latent weight")
        else:
            fields[field] = group.all_gather(a[i].detach())
    return type(w)(**fields)


def sharded_proj(params: Dict[str, Any], layout: Layout,
                 config: BitLlamaConfig, group: DataGroup, *, impl: str,
                 compute_dtype, grads: Optional[ShardGrads] = None) -> Proj:
    """A data-parallel rank's strategy over its tree ``params`` (see the
    module docstring): ``forward(..., proj=sharded_proj(...))``. The
    embedding and the lm_head are gathered in the compute dtype when they
    are split (indexing and the cast commute, and ``_lm_head`` casts
    first). ``grads`` takes the split latent planes' gradient shards."""
    layers = params["layers"]
    eps = config.rms_norm_eps

    def project(x, name: str, i: int):
        w = _layer_weights(layers[name], name, i, layout, group,
                           compute_dtype, grads)
        if isinstance(w, LinearWeights):
            return linear_apply(x, w)
        return bitlinear_apply(x, w, impl=impl)

    def whole(key):
        t = params[key]
        if key not in layout:
            return t
        return group.all_gather(t.detach().to(compute_dtype))

    qkv = ("q_proj", "k_proj", "v_proj")
    return Proj(
        embed=lambda ids: whole("embed_tokens")[ids].to(compute_dtype),
        qkv=lambda hx, i: tuple(project(hx, n, i) for n in qkv),
        o=lambda v, i: project(v, "o_proj", i),
        gateup=lambda hx, i: tuple(project(hx, n, i)
                                   for n in ("gate_proj", "up_proj")),
        down=lambda v, i: project(v, "down_proj", i),
        ln=lambda x, name, i: rms_norm(x, layers[name][i], eps),
        final=lambda x: rms_norm(x, params["final_norm"], eps),
        nh=config.num_attention_heads, nkv=config.num_key_value_heads,
        head=lambda h: _lm_head(h, {"lm_head": whole("lm_head")},
                                compute_dtype))
