"""Tensor-parallel decoder: Megatron column- and row-parallel OneBit
linears over a ``torch.distributed`` process group.

Port of ``onebit_tpu/model/tp_decode.py``. One process per shard runs the
same program (SPMD) on its slices of the weights; where JAX's shard_map
bodies psum over the ``model`` mesh axis, these call the collectives of a
:class:`~onebit_tpu_torch.parallel.mesh.TPGroup`:

* q/k/v and gate/up are **column parallel** (out-features split): each
  rank's shard runs B4, the raw projection, and the LayerNorm over the
  split axis all-reduces two moments per row
  (``kernels/bitlinear_sharded.py``); the projections of one input (q/k/v,
  gate/up) share that all-reduce;
* o_proj and down_proj are **row parallel** (in-features split): each rank's
  partial ``((x⊙g)·Sᵀ)⊙h`` (``h`` is elementwise over the outputs, so it
  commutes with the sum) is all-reduced, then normalised on every rank;
* attention runs on the rank's heads (``nh/mp`` query, ``nkv/mp`` KV), so
  the KV cache is head-sharded and the attention kernels (B5, B7, B9, B10)
  take the local head count from the pools' shapes;
* ``embed_tokens`` and ``lm_head`` are split over the vocabulary.

Per layer that is two moment all-reduces and two activation all-reduces.

There is no ``repack_row_parallel`` (``tp_decode.py:207``): the JAX
byte-plane layout spreads in-index ``k`` over the whole word axis, so a
row-parallel shard must be repacked there. The port's K-major layout keeps
``k`` in word row ``k // 32`` (``core/packing.py:22-27``), so a row-parallel
shard is a contiguous block of word rows, as long as ``K/mp`` is a multiple
of 32.
"""

from __future__ import annotations

from typing import Dict

import torch

from onebit_tpu_torch.core.bitlinear import LN_EPS, layernorm_noaffine
from onebit_tpu_torch.core.packing import WORD_BITS
from onebit_tpu_torch.kernels.bitlinear import (BitLinearWeights,
                                                bitlinear_apply_stacked_raw,
                                                bitlinear_packed_raw)
from onebit_tpu_torch.kernels.bitlinear_sharded import (bitlinear_tp_shard,
                                                        moment_layernorm)
from onebit_tpu_torch.model.bitllama import (Proj, _lm_head,
                                             decode_step_hidden, rms_norm)
from onebit_tpu_torch.model.config import BitLlamaConfig

COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW_PARALLEL = ("o_proj", "down_proj")


def check_heads(config: BitLlamaConfig, mp: int) -> None:
    if config.num_attention_heads % mp or config.num_key_value_heads % mp:
        raise ValueError(f"heads not divisible by model={mp}")


# ---- one projection ---------------------------------------------------------

def _column_parallel(x, w: BitLinearWeights, impl: str, group,
                     eps: float = LN_EPS):
    """One layer's column-parallel BitLinear (out-feature shard of ``w``)."""
    return bitlinear_tp_shard(x, w.packed, w.input_factor, w.weight_scale,
                              group=group, eps=eps, impl=impl)


def _row_parallel(x_loc, w: BitLinearWeights, impl: str, group,
                  eps: float = LN_EPS):
    """One layer's row-parallel BitLinear: ``x_loc`` and ``w`` the rank's
    in-feature shard; the partial products are all-reduced, then
    normalised on every rank."""
    z = bitlinear_packed_raw(x_loc, w.packed, w.input_factor, w.weight_scale,
                             impl=impl).float()
    group.all_reduce(z)
    return layernorm_noaffine(z, eps).to(x_loc.dtype)


# ---- layer i of the stacked shards ------------------------------------------

def _col_parallel_flat(x, layers, names, i: int, impl: str, group,
                       eps: float = LN_EPS):
    """Layer ``i`` of the column-parallel projections ``names`` of one
    input ``x``: B4 on each, then one all-reduce of all their moments."""
    zs = [bitlinear_apply_stacked_raw(x, layers[n], i, impl=impl)
          for n in names]
    ys = moment_layernorm(zs, group, [z.shape[-1] * group.size for z in zs],
                          eps)
    return tuple(y.to(x.dtype) for y in ys)


def _row_parallel_flat(x_loc, layers, name: str, i: int, impl: str, group,
                       eps: float = LN_EPS):
    """Layer ``i`` of the row-parallel projection ``name``: B4 on the
    rank's in-feature block, the partial sums all-reduced (above 128 rows
    in x.dtype first, as JAX's large-M kernel rounds them), then the
    LayerNorm on every rank."""
    z = bitlinear_apply_stacked_raw(x_loc, layers[name], i, impl=impl)
    group.all_reduce(z)
    return layernorm_noaffine(z, eps).to(x_loc.dtype)


def tp_embed(embed, ids, vocab_size: int, compute_dtype, group):
    """The token embedding from a replicated table ``[V, d]``, or from the
    rank's vocab shard ``[V/mp, d]``: each rank looks up its own rows and
    one all-reduce combines them (exactly one rank adds a nonzero row per
    token, so the sum is exact)."""
    if embed.shape[0] == vocab_size:
        return embed[ids].to(compute_dtype)
    v_local = embed.shape[0]
    loc = ids - group.rank * v_local
    ok = (loc >= 0) & (loc < v_local)
    x = torch.where(ok[..., None],
                    embed[torch.where(ok, loc, 0)].to(compute_dtype), 0)
    return group.all_reduce(x.contiguous())


# ---- the rank's params ------------------------------------------------------

def _block(t: torch.Tensor, axis: int, mp: int, rank: int, device):
    """Block ``rank`` of ``mp`` along ``axis``, contiguous on ``device``."""
    n = t.shape[axis] // mp
    return t.narrow(axis, rank * n, n).contiguous().to(device)


def shard_tp_params(params, group) -> Dict:
    """This rank's slices of unfused packed params, on ``group.device``:
    column-parallel packed words and ``h`` split along N, row-parallel words
    along their word rows with ``g``, ``embed_tokens`` and ``lm_head`` along
    the vocabulary; the norms replicated. Each slice is made contiguous
    once, here (the kernels take contiguous operands)."""
    mp, rank, dev = group.size, group.rank, group.device
    layers = params["layers"]
    fused = [n for n in ("qkv_proj", "gateup_proj") if n in layers]
    if fused:
        raise ValueError(f"tensor parallelism shards each projection on its "
                         f"own; pass params without fuse_for_decode (found "
                         f"{fused})")
    vocab = params["lm_head"].shape[0]
    if vocab % mp:
        raise ValueError(f"lm_head is split over the vocabulary: {vocab} is "
                         f"not divisible by model={mp}")
    out = {"embed_tokens": _block(params["embed_tokens"], 0, mp, rank, dev),
           "lm_head": _block(params["lm_head"], 0, mp, rank, dev),
           "final_norm": params["final_norm"].to(dev)}
    sharded = {name: layers[name].to(dev)
               for name in ("input_layernorm", "post_attention_layernorm")}
    for name in COLUMN_PARALLEL + ROW_PARALLEL:
        w = layers[name]
        if not isinstance(w, BitLinearWeights) or w.mode != "packed" or \
                w.bias is not None:
            raise ValueError(f"tensor parallelism takes packed, bias-free "
                             f"BitLinear projections; {name} is not one")
        words, n = w.packed.shape[-2:]
        if name in COLUMN_PARALLEL:
            if n % mp:
                raise ValueError(f"{name}: {n} out-features are not "
                                 f"divisible by model={mp}")
            sharded[name] = BitLinearWeights(
                weight_scale=_block(w.weight_scale, -1, mp, rank, dev),
                input_factor=w.input_factor.to(dev),
                packed=_block(w.packed, -1, mp, rank, dev))
        else:
            k = words * WORD_BITS
            if k % (mp * WORD_BITS):
                raise ValueError(f"{name}: K/mp = {k}/{mp} is not a multiple "
                                 f"of {WORD_BITS}, the sign words' width")
            sharded[name] = BitLinearWeights(
                weight_scale=w.weight_scale.to(dev),
                input_factor=_block(w.input_factor, -1, mp, rank, dev),
                packed=_block(w.packed, -2, mp, rank, dev))
    out["layers"] = sharded
    return out


# ---- the strategy, the lm_head and the steps --------------------------------

def tp_proj(params, config: BitLlamaConfig, impl: str, compute_dtype,
            group) -> Proj:
    """A rank's projection strategy (``tp_backend.py:89``) over its shards
    ``params`` (:func:`shard_tp_params`): column-parallel q/k/v and
    gate/up, row-parallel o and down, the vocab-sharded embedding, and the
    rank's head counts."""
    layers = params["layers"]
    eps = config.rms_norm_eps
    return Proj(
        embed=lambda ids: tp_embed(params["embed_tokens"], ids,
                                   config.vocab_size, compute_dtype, group),
        qkv=lambda hx, i: _col_parallel_flat(
            hx, layers, ("q_proj", "k_proj", "v_proj"), i, impl, group),
        o=lambda v, i: _row_parallel_flat(v, layers, "o_proj", i, impl,
                                          group),
        gateup=lambda hx, i: _col_parallel_flat(
            hx, layers, ("gate_proj", "up_proj"), i, impl, group),
        down=lambda v, i: _row_parallel_flat(v, layers, "down_proj", i,
                                             impl, group),
        ln=lambda x, name, i: rms_norm(x, layers[name][i], eps),
        final=lambda x: rms_norm(x, params["final_norm"], eps),
        nh=config.num_attention_heads // group.size,
        nkv=config.num_key_value_heads // group.size)


def _gathered_logits(x, params, compute_dtype, group) -> torch.Tensor:
    """fp32 logits ``[..., V]``: the rank's vocab shard of the lm_head,
    then an all-gather (``tp_backend.py:515``)."""
    return group.all_gather(_lm_head(x, params, compute_dtype), dim=-1)


def _greedy_token(x, params, compute_dtype, group) -> torch.Tensor:
    """Greedy next tokens ``[B]`` from ``x [B, d]`` without gathering the
    logits (``tp_backend.py:523``): each rank takes the argmax of its
    ``V/mp`` logits, and only the ``mp`` (max, global index) pairs per row
    cross the ranks. Ties go to the lowest global index, as ``argmax`` of
    the full row does: the first rank among equal maxima, the first index
    within it."""
    logits = _lm_head(x, params, compute_dtype)               # [B, V/mp]
    arg = logits.argmax(-1)
    best = logits.gather(-1, arg[:, None])[:, 0]
    pair = torch.stack([best.double(),
                        (arg + group.rank * logits.shape[-1]).double()])
    pairs = group.all_gather(pair[None], dim=0)               # [mp, 2, B]
    rank = pairs[:, 0].argmax(0)                              # [B]
    return pairs[rank, 1, torch.arange(x.shape[0], device=x.device)].long()


def tp_decode_step(params, cache, input_ids, cache_index: int,
                   config: BitLlamaConfig, group, *, impl: str = "auto",
                   compute_dtype=torch.bfloat16):
    """``decode_step`` on the rank's shards and its head-sharded cache
    (``KVCache`` with ``nkv/mp`` heads, updated in place): the counterpart
    of ``make_tp_decode_step`` (``tp_decode.py:255``). Returns
    ``(logits [B, s, V] fp32, cache)``, the logits gathered on every
    rank."""
    check_heads(config, group.size)
    x = decode_step_hidden(tp_proj(params, config, impl, compute_dtype,
                                   group),
                           cache, input_ids, cache_index, config, impl=impl,
                           compute_dtype=compute_dtype)
    return _gathered_logits(x, params, compute_dtype, group), cache


def tp_greedy_step(params, cache, input_ids, cache_index: int,
                   config: BitLlamaConfig, group, *, impl: str = "auto",
                   compute_dtype=torch.bfloat16):
    """:func:`tp_decode_step` returning the greedy next tokens ``[B]`` of
    the last position, without gathering the logits: the counterpart of
    ``make_tp_greedy_step`` (``tp_decode.py:308``)."""
    check_heads(config, group.size)
    x = decode_step_hidden(tp_proj(params, config, impl, compute_dtype,
                                   group),
                           cache, input_ids, cache_index, config, impl=impl,
                           compute_dtype=compute_dtype)
    return _greedy_token(x[:, -1], params, compute_dtype, group), cache
