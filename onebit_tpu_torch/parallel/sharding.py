"""Fully sharded data parallelism and tensor-parallel training: which
leaf is split over which axis of a ``(data, model)`` mesh, the ranks'
shards, and a rank's forward over them.

Port of ``onebit_tpu/parallel/sharding.py``. JAX shards every big plane
over ``data`` as well as ``model``, so that params, optimizer moments and
the teacher are split over all ranks (ZeRO-3), and GSPMD gathers a layer's
shards at use, reduce-scatters its gradient and inserts the tensor-parallel
collectives. The port does all of it by hand, one process a rank, each
with its place on the mesh (``parallel/mesh.py`` ``Mesh2D``) and the
mesh's :class:`MeshLayout`. Its layout is its own; what matches JAX is
the function computed.

On the data axis (the whole story of a mesh ``(N, 1)``):

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

On a model axis of ``m > 1`` the model split comes first
(:func:`mesh_layout`), Megatron's layout as ``model/tp_decode.py`` serves
it:

* column-parallel projections (q, k, v, gate, up) split their out-features
  over ``model``: the latent ``[L, out, in]`` (the teacher's weight), h and
  a bias; g stays whole. A shard is whole heads: q's ``nh/m``, k's and v's
  ``nkv/m``. Where ``nkv`` does not divide by ``m``, k and v stay whole on
  every rank (JAX's ``_shardable`` replicates a leaf that does not divide)
  and each rank attends over the KV heads its query heads use
  (:func:`kv_heads`); ``nh`` must divide;
* row-parallel projections (o, down) split their in-features over
  ``model``: the latent on axis 2 and g; h and a bias stay whole;
* ``embed_tokens`` and ``lm_head`` split the vocabulary over ``model``, the
  norms stay whole;
* where the MLP's width does not divide by ``m``, gate, up and down stay
  whole, and every rank runs the whole MLP on its whole input (JAX's
  ``_shardable`` again).

The data axis then splits each model shard as above (:func:`param_layout`
on the shard's shape): a column plane's axis 1 again (the model block
outer, the data block inner), a row plane's axis 1, the vocabulary. A
rank's strategy (:func:`sharded_proj`, one for every mesh) gathers a
layer's data shards at use, and runs the column- and row-parallel layers
of training over its model group (``kernels/bitlinear_sharded.py``: the
LayerNorm statistics all-reduced forward and backward, the row-parallel
output all-reduced forward only), attention on its heads, and the lm_head
on its vocabulary block, whose logits are gathered over the model group.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from onebit_tpu_torch.core.bitlinear import (STE_SLOPE_OFFSET, bitlinear_raw,
                                             sign_ste)
from onebit_tpu_torch.kernels.bitlinear import (BitLinearWeights,
                                                FusedBitLinearWeights,
                                                bitlinear_apply)
from onebit_tpu_torch.kernels.bitlinear_sharded import (copy_to_model,
                                                        gather_from_model,
                                                        reduce_from_model,
                                                        row_parallel_train,
                                                        tp_layernorm)
from onebit_tpu_torch.kernels.linear import LinearWeights, linear_apply
from onebit_tpu_torch.model.bitllama import Proj, _lm_head, rms_norm
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.tp_decode import (COLUMN_PARALLEL, ROW_PARALLEL,
                                              tp_embed)
from onebit_tpu_torch.parallel.mesh import DataGroup, Mesh2D

Layout = Dict[str, int]      # native key -> the axis split over the ranks
_PLANES = ("latent", "dense_sign", "weight")
_MLP = ("gate_proj", "up_proj", "down_proj")


class MeshLayout(NamedTuple):
    """Where each split leaf of a ``(data, model)`` mesh is cut: ``model``
    over the model ranks, then ``data`` over the data ranks, of the model
    shard (``{native key: axis}`` each)."""
    data: Layout
    model: Layout


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


def model_axis(key: str, shape, config: BitLlamaConfig,
               m: int) -> Optional[int]:
    """The axis a leaf of this key and full shape is split on over ``m``
    model ranks (see the module docstring), or None (whole)."""
    if key in ("embed_tokens", "lm_head"):
        return 0 if shape[0] % m == 0 else None
    parts = key.split(".")
    if len(parts) != 3:
        return None                                   # the norms
    _, name, field = parts
    if field == "packed":
        raise ValueError(f"{key}: tensor-parallel training takes latent, "
                         f"dense-sign or plain weights, not packed words")
    if name in _MLP and config.intermediate_size % m:
        return None
    if name in COLUMN_PARALLEL:
        if name in ("k_proj", "v_proj") and config.num_key_value_heads % m:
            return None
        return None if field == "input_factor" else 1
    if name in ROW_PARALLEL:
        if field in _PLANES:
            return 2
        return 1 if field == "input_factor" else None
    return None


def mesh_layout(shapes: Dict[str, Any], config: BitLlamaConfig,
                shape) -> MeshLayout:
    """The layout of a ``(data, model)`` mesh, from a tree of full-shaped
    leaves or a ``{key: shape}`` dict: :func:`model_axis`'s splits, then
    :func:`param_layout`'s over the data ranks on the model shards'
    shapes. Raises where the query heads do not divide by the model
    axis."""
    d, m = (int(x) for x in shape)
    if m > 1 and config.num_attention_heads % m:
        raise ValueError(f"heads not divisible by model={m}")
    items = (named_leaves(shapes) if "layers" in shapes
             else shapes.items())
    model: Layout = {}
    local = {}
    for key, leaf in items:
        full = tuple(getattr(leaf, "shape", leaf))
        axis = model_axis(key, full, config, m) if m > 1 else None
        if axis is not None:
            model[key] = axis
        local[key] = local_shape(full, axis, m)
    return MeshLayout(param_layout(local, d) if d > 1 else {}, model)


def split_projections(layout: MeshLayout) -> set:
    """The projections whose weights are split over the model ranks."""
    return {k.split(".")[1] for k in layout.model if k.count(".") == 2}


def model_partial(key: str, layout: MeshLayout) -> bool:
    """A leaf whole over the model ranks of which each rank's backward
    gives only a part of the gradient: those of a column-parallel
    projection whose output each rank uses only in part (the g of a split
    one, and every leaf of k and v kept whole beside split query heads).
    Row-parallel leaves kept whole (h, a bias) act after the all-reduce,
    and a whole MLP runs whole on every rank: every rank gets their whole
    gradient."""
    parts = key.split(".")
    if (len(parts) != 3 or parts[1] not in COLUMN_PARALLEL
            or key in layout.model):
        return False
    split = split_projections(layout)
    return parts[1] in split or (parts[1] in ("k_proj", "v_proj")
                                 and "q_proj" in split)


def kv_heads(config: BitLlamaConfig, m: int, rank: int) -> list:
    """The KV heads that the query heads of model rank ``rank`` attend,
    where k and v stay whole (``nkv % m != 0``), one entry a local KV head:
    each head once when the rank's query heads are whole groups of those
    heads in order, else one a query head (groups of one)."""
    nh, g = config.num_attention_heads // m, config.num_kv_groups
    kv = [(rank * nh + j) // g for j in range(nh)]
    heads = sorted(set(kv))
    if nh % len(heads) == 0 and kv == [h for h in heads
                                       for _ in range(nh // len(heads))]:
        return heads
    return kv


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


def shard_params(params: Dict[str, Any], mesh: Mesh2D,
                 layout: MeshLayout) -> Dict[str, Any]:
    """This rank's tree of a full tree (``shard_params`` of JAX, :106-111):
    of every leaf split over the model ranks the block of the rank's model
    index, then of every leaf split over the data ranks the block of its
    data index, the rest whole, all on the rank's device, every leaf a
    copy."""
    data, model = mesh.data, mesh.model

    def place(key, t):
        if key in layout.model:
            t = block(t, layout.model[key], model.size, model.rank,
                      t.device)
        if key in layout.data:
            return block(t, layout.data[key], data.size, data.rank,
                         mesh.device)
        return t.detach().to(mesh.device, copy=True)
    return map_leaves(params, place)


def gather_leaf(t: torch.Tensor, axis: Optional[int],
                group: DataGroup) -> torch.Tensor:
    """The full leaf from every rank's block along ``axis`` (collective;
    ``t`` itself when it is whole)."""
    if axis is None:
        return t
    moved = t.detach().movedim(axis, 0)
    return group.all_gather(moved).movedim(0, axis).contiguous()


def gather_full(t: torch.Tensor, key: str, layout: MeshLayout,
                mesh: Mesh2D) -> torch.Tensor:
    """The full leaf ``key`` from the ranks' blocks: over the data group,
    then over the model group (collective; ``t`` itself when whole)."""
    t = gather_leaf(t, layout.data.get(key), mesh.data)
    return gather_leaf(t, layout.model.get(key), DataGroup.of(mesh.model))


def gather_params(params: Dict[str, Any], layout: MeshLayout,
                  mesh: Mesh2D, *,
                  dst: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """The full tree from the ranks' trees, a leaf at a time (a
    collective: every rank calls it). Every rank gets the tree on its
    device or, with ``dst``, rank ``dst`` alone on the host and the others
    None."""
    keep = dst is None or mesh.rank == dst

    def full(key, t):
        out = gather_full(t, key, layout, mesh)
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


def _signs(w):
    """The ±1 matrix of one layer's BitLinear (the latent's through the
    straight-through sign; ``model_axis`` refuses packed words)."""
    return w.dense_sign if w.latent is None else sign_ste(w.latent)


def _with_bias(y, bias, dtype):
    return (y if bias is None else y + bias.float()).to(dtype)


def sharded_proj(params: Dict[str, Any], layout: MeshLayout,
                 config: BitLlamaConfig, mesh: Mesh2D, *, impl: str,
                 compute_dtype, grads: Optional[ShardGrads] = None) -> Proj:
    """A sharded rank's strategy over its tree ``params`` (see the module
    docstring): ``forward(..., proj=sharded_proj(...))``. Each layer's data
    shards are gathered at use (a split latent as its signs); then the
    column-parallel projections of one input run behind one
    :func:`copy_to_model`, with their LayerNorm statistics shared
    (:func:`tp_layernorm`), the row-parallel ones through
    :func:`row_parallel_train`, attention on the rank's heads, the
    embedding and the lm_head on the rank's vocabulary block, whose logits
    are gathered. A projection whole over the model ranks runs as on one
    device (``bitlinear_apply``, ``linear_apply``). The teacher's plain
    projections take the same split, without a LayerNorm. The embedding
    and the lm_head are gathered over the data ranks in the compute dtype
    (indexing and the cast commute, and ``_lm_head`` casts first).
    ``grads`` takes the data-split latent planes' gradient shards."""
    layers = params["layers"]
    eps = config.rms_norm_eps
    model, m = mesh.model, mesh.model.size
    split = split_projections(layout)
    kv_sel = None
    nkv = config.num_key_value_heads // m
    if m > 1 and "k_proj" not in split:
        kv_sel = torch.tensor(kv_heads(config, m, model.rank),
                              device=mesh.device)
        nkv = len(kv_sel)

    def weights(name: str, i: int):
        return _layer_weights(layers[name], name, i, layout.data, mesh.data,
                              compute_dtype, grads)

    def whole(x, w):
        if isinstance(w, LinearWeights):
            return linear_apply(x, w)
        return bitlinear_apply(x, w, impl=impl)

    def column(hx, names, i: int):
        ws = [weights(n, i) for n in names]
        if not any(n in split for n in names):
            return [whole(hx, w) for w in ws]
        x = copy_to_model(hx, model)
        outs, zs, where = [None] * len(names), [], []
        for j, (name, w) in enumerate(zip(names, ws)):
            if name not in split or isinstance(w, LinearWeights):
                outs[j] = whole(x, w)
                continue
            zs.append(bitlinear_raw(x, _signs(w), w.input_factor,
                                    w.weight_scale))
            where.append(j)
        if zs:
            ys = tp_layernorm(zs, model, [z.shape[-1] * m for z in zs])
            for j, y in zip(where, ys):
                outs[j] = _with_bias(y, ws[j].bias, x.dtype)
        return outs

    def qkv(hx, i: int):
        q, k, v = column(hx, ("q_proj", "k_proj", "v_proj"), i)
        if kv_sel is not None:
            hd = config.head_dim
            k, v = (t.unflatten(-1, (-1, hd))[..., kv_sel, :].flatten(-2)
                    for t in (k, v))
        return q, k, v

    def row(v, name: str, i: int):
        w = weights(name, i)
        if name not in split:
            return whole(v, w)
        if isinstance(w, LinearWeights):
            p = torch.matmul(v.float(), w.weight.to(v.dtype).float().T)
            return _with_bias(reduce_from_model(p, model), w.bias, v.dtype)
        return row_parallel_train(v, _signs(w), w.input_factor,
                                  w.weight_scale, w.bias, model)

    def table(key: str):
        t = params[key]
        if key not in layout.data:
            return t
        return mesh.data.all_gather(t.detach().to(compute_dtype))

    def head(h):
        w = {"lm_head": table("lm_head")}
        if "lm_head" not in layout.model:
            return _lm_head(h, w, compute_dtype)
        return gather_from_model(
            _lm_head(copy_to_model(h, model), w, compute_dtype), model)

    return Proj(
        embed=lambda ids: tp_embed(table("embed_tokens"), ids,
                                   config.vocab_size, compute_dtype, model),
        qkv=qkv,
        o=lambda v, i: row(v, "o_proj", i),
        gateup=lambda hx, i: tuple(column(hx, ("gate_proj", "up_proj"), i)),
        down=lambda v, i: row(v, "down_proj", i),
        ln=lambda x, name, i: rms_norm(x, layers[name][i], eps),
        final=lambda x: rms_norm(x, params["final_norm"], eps),
        nh=config.num_attention_heads // m, nkv=nkv, head=head)
