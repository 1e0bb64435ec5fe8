"""Paged KV cache: page pools, a refcounting page allocator, and the paged
decode step, batched prefill and chunk append.

Port of ``onebit_tpu/engine/paged.py``. The cores (``_window_core``,
``_prefill_rows_core``) take a projection strategy (``model/bitllama.py``
``Proj``): one device's, or a tensor-parallel rank's over the pool's
``nkv / mp`` heads (``engine/tp_backend.py``). K/V live in
fixed-size pages ``[L, num_pages, n_kv, page_size, head_dim]``; each sequence
owns a list of logical pages (``page_indices [B, pages_per_seq]``, shared by
all layers) and its length. A (layer, page) block is one contiguous
``[n_kv, ps, hd]`` slab. Pages are allocated and freed by a host-side
refcounting free list, so sequences of different lengths share the pool and
prefix caching shares read-only prompt pages between sequences
(``engine/batching.py``).

Decode attention (one query position per row) runs kernel B10
(``kernels/paged_attention.py``) for CUDA pools with any ``impl`` other than
``"torch"``: a CTA reads its row's page table and loads the pages itself.
With ``impl="torch"`` and on the CPU it gathers the rows' pages from the
layer and attends over them, the JAX package's default; int8 pages attend
on the gathered integers with the scales folded in (``_attention_quant``).
Windows of W > 1 positions (chunk appends) always take the gather.

PyTorch runs eagerly: the layer loop is a Python loop, and the pools are
updated **in place**, one bulk index write per leaf and layer (the JAX
functions return a new cache; these return the same cache, mutated).

Int8 pages use the third KV scale convention of the JAX package: the raw
absmax ``h = max(|x|, 1e-6)`` is stored, values are ``rint(x * 127.5 / h)``
(saturated to int8), and dequantization is ``q * h / 127.5``.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from onebit_tpu_torch.engine.sampler import sample_token
from onebit_tpu_torch.kernels.kv_attention import _attention_quant
from onebit_tpu_torch.kernels.paged_attention import (_MAX_INT8,
                                                      _gather_seq_kv,
                                                      paged_attention_flat)
from onebit_tpu_torch.model import bitllama
from onebit_tpu_torch.model.bitllama import (Proj, _decoder_layer, _lm_head,
                                             default_proj)
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.ragged_decode import decode_block
from onebit_tpu_torch.model.rope import apply_rope, rope_cos_sin
from onebit_tpu_torch.utils.device import resolve_device

ENGINE_OPTIONS_WAIT = "the engine options of ROADMAP.md §1 item 5"


class PagedKVCache(NamedTuple):
    """Pages in one float dtype, layers stacked on axis 0."""
    k_pages: torch.Tensor  # [L, num_pages, n_kv, page_size, head_dim]
    v_pages: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def num_pages(self) -> int:
        """Logical pages per layer (the allocator's pool size)."""
        return self.k_pages.shape[1]


class QuantPagedKVCache(NamedTuple):
    """int8 pages + per-(layer, page, head, slot) raw absmax scales."""
    k_q: torch.Tensor  # [L, num_pages, n_kv, page_size, head_dim] int8
    k_s: torch.Tensor  # [L, num_pages, n_kv, page_size, 1] f32
    v_q: torch.Tensor
    v_s: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_q.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k_q.shape[1]


def init_paged_kv_cache(config: BitLlamaConfig, num_pages: int,
                        page_size: int = 16, dtype=torch.bfloat16,
                        quantized=False, device=None, num_kv_heads=None):
    """``quantized``: False (pages in ``dtype``) or True / "int8" (int8
    pages + raw absmax scales). fp8 pages are not ported yet.
    ``num_kv_heads`` overrides the config's head count (a tensor-parallel
    rank holds ``nkv / mp`` heads)."""
    if quantized == "fp8":
        raise NotImplementedError(
            f"fp8 pages are not ported yet: they wait for "
            f"{ENGINE_OPTIONS_WAIT}")
    device = resolve_device(device)
    shape = (config.num_hidden_layers, num_pages,
             num_kv_heads or config.num_key_value_heads, page_size,
             config.head_dim)
    z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    if quantized:
        sshape = shape[:-1] + (1,)
        return QuantPagedKVCache(z(shape, torch.int8),
                                 z(sshape, torch.float32),
                                 z(shape, torch.int8),
                                 z(sshape, torch.float32))
    return PagedKVCache(z(shape, dtype), z(shape, dtype))


def _quantize_kv_int8(x):
    """``[..., hd]`` -> (int8 values, raw absmax scales ``[..., 1]``):
    ``rint(x * (127.5 / h))`` with ``h = max(absmax, 1e-6)``, rounded half
    to even and saturated to [-128, 127] as the JAX conversion saturates."""
    x = x.float()
    scales = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6)
    # a true division: a Python scalar over a tensor would multiply by the
    # tensor's reciprocal and round differently
    q = torch.round(x * (torch.full_like(scales, _MAX_INT8) / scales))
    q = q.clamp(-128, 127)
    return q.to(torch.int8), scales


def _dequantize_kv_int8(q, scales, dtype=torch.float32):
    return (q.float() * (scales / _MAX_INT8)).to(dtype)


class PageAllocator:
    """Host-side free list of logical pages with reference counts (page 0
    is the reserved null page, never handed out).

    ``retain`` adds a reference (a page shared through the prefix cache);
    ``release`` drops one and returns the page to the free list when the
    last reference goes."""

    def __init__(self, num_pages: int):
        self.free: List[int] = list(range(num_pages - 1, 0, -1))
        self.refcount = {}

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError("out of KV pages")
        p = self.free.pop()
        self.refcount[p] = 1
        return p

    def retain(self, page: int) -> None:
        self.refcount[int(page)] += 1

    def release(self, pages) -> None:
        for p in pages:
            p = int(p)
            if p <= 0:
                continue
            rc = self.refcount.get(p, 1) - 1
            if rc <= 0:
                self.refcount.pop(p, None)
                self.free.append(p)
            else:
                self.refcount[p] = rc


# ---------------------------------------------------------------------------
# Attention over the pages
# ---------------------------------------------------------------------------

def _paged_attend_window(q, leaves, quant: bool, mask, page_indices,
                         layer: int, compute_dtype) -> torch.Tensor:
    """Attention for a W-position window over gathered pages: q
    ``[B, W, nh, hd]``, mask ``[B, 1, W, T]`` (T = max_pages * ps). Int8
    pages attend on the gathered integers with the scales ``/ 127.5``
    folded into scores and P: no dequantized copy of the pages."""
    nh = q.shape[2]
    if quant:
        k_q, k_s, v_q, v_s = (_gather_seq_kv(x[layer], page_indices)
                              for x in leaves)
        inv = 1.0 / _MAX_INT8
        return _attention_quant(q.to(compute_dtype), k_q, k_s[..., 0] * inv,
                                v_q, v_s[..., 0] * inv, mask,
                                num_kv_groups=nh // k_q.shape[2])
    kf = _gather_seq_kv(leaves[0][layer], page_indices)
    vf = _gather_seq_kv(leaves[1][layer], page_indices)
    return bitllama._attention(q, kf.to(q.dtype), vf.to(q.dtype), mask,
                               num_kv_groups=nh // kf.shape[2])


def _write_pages(cache, i: int, pages, slots, k, v) -> None:
    """Write K/V ``[..., nkv, hd]`` of layer ``i`` at (pages, slots), each
    ``[...]``: one bulk index write per leaf, quantized into int8 pages."""
    if isinstance(cache, QuantPagedKVCache):
        k_i8, k_sc = _quantize_kv_int8(k)
        v_i8, v_sc = _quantize_kv_int8(v)
        for leaf, val in zip(cache, (k_i8, k_sc, v_i8, v_sc)):
            leaf[i][pages, :, slots] = val
        return
    cache.k_pages[i][pages, :, slots] = k.to(cache.k_pages.dtype)
    cache.v_pages[i][pages, :, slots] = v.to(cache.v_pages.dtype)


def _cos_sin(positions, config: BitLlamaConfig, compute_dtype):
    return rope_cos_sin(positions, config.head_dim, config.rope_theta,
                        config.rope_scaling, config.max_position_embeddings,
                        seq_len=config.max_position_embeddings,
                        dtype=compute_dtype)


def _use_kernel(cache, impl: str) -> bool:
    """B10 serves decode on the card unless ``impl="torch"``."""
    return cache[0].device.type == "cuda" and impl != "torch"


# ---------------------------------------------------------------------------
# Cores: the window (decode and chunk append) and the batched prefill
# ---------------------------------------------------------------------------

def _window_core(proj: Proj, cache, tokens, lengths, page_indices,
                 config: BitLlamaConfig, impl: str, compute_dtype):
    """W tokens per row written at ``lengths .. lengths+W-1``, attending to
    each row's pages as just updated. ``tokens [B, W]``, ``lengths [B]``
    write-start positions, ``page_indices [B, max_pages]`` int32, all on
    the cache's device. Returns the final-normed hidden ``[B, W, d]``.

    W = 1 is the decode step (B10 on the card); W > 1 a chunk append. The
    projections are ``proj``'s: one device's, or a tensor-parallel rank's
    over the pool's ``nkv / mp`` heads."""
    w = tokens.shape[1]
    ps, mp = cache.page_size, page_indices.shape[1]
    positions = lengths[:, None] + torch.arange(w, device=tokens.device)
    pages = torch.take_along_dim(
        page_indices.long(), (positions // ps).clamp(max=mp - 1), dim=1)
    # positions past the table go to the reserved null page 0, never onto a
    # live page (the JAX _window_core's rule)
    pages = torch.where(positions < mp * ps, pages, 0)
    slots = positions % ps
    x = proj.embed(tokens)
    cos, sin = _cos_sin(positions, config, compute_dtype)
    quant = isinstance(cache, QuantPagedKVCache)
    use_kernel = w == 1 and _use_kernel(cache, impl)
    if use_kernel:
        attn_lengths = (lengths + 1).to(torch.int32)
    else:
        kj = torch.arange(mp * ps, device=tokens.device)
        mask = (kj[None, None, None, :] <= positions[:, None, :, None])

    for i in range(config.num_hidden_layers):
        def attend(q, k, v, i=i):
            q, k = apply_rope(q, k, cos, sin)
            _write_pages(cache, i, pages, slots, k, v)
            if use_kernel:
                return paged_attention_flat(
                    q[:, 0], *cache, lengths=attn_lengths,
                    page_indices=page_indices, layer=i,
                    quant=quant).to(compute_dtype)[:, None]
            return _paged_attend_window(q, cache, quant, mask, page_indices,
                                        i, compute_dtype)
        x = _decoder_layer(x, proj, i, attend)
    return proj.final(x)


def _prefill_rows_core(proj: Proj, cache, ids, lengths, page_indices,
                       config: BitLlamaConfig, impl: str, compute_dtype):
    """Batched self-contained prefill: rows attend only within themselves
    (full-precision K/V); their K/V go into their pages. Returns the
    final-normed hidden ``[R, S_pad, d]``."""
    r, s_pad = ids.shape
    ps = cache.page_size
    positions = torch.arange(s_pad, device=ids.device)
    pages = torch.take_along_dim(page_indices.long(),
                                 (positions // ps)[None, :].expand(r, s_pad),
                                 dim=1)                         # [R, S]
    slots = (positions % ps)[None, :].expand(r, s_pad)          # [R, S]
    attn = positions[None, :] < lengths[:, None]
    x = proj.embed(ids)
    cos, sin = _cos_sin(positions[None, :], config, compute_dtype)
    mask = bitllama._causal_mask(s_pad, s_pad, 0, ids.device) & \
        attn[:, None, None, :]
    for i in range(config.num_hidden_layers):
        def attend(q, k, v, i=i):
            q, k = apply_rope(q, k, cos, sin)
            _write_pages(cache, i, pages, slots, k, v)
            return bitllama._attention(q, k, v, mask,
                                       num_kv_groups=config.num_kv_groups)
        x = _decoder_layer(x, proj, i, attend)
    return proj.final(x)


def _on(cache, x, dtype) -> torch.Tensor:
    """``x`` (tensor, array or scalar) as a tensor on the cache's device."""
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                           ).to(device=cache[0].device, dtype=dtype)


def _tables(cache, page_indices) -> torch.Tensor:
    """Page tables as contiguous int32 on the cache's device. Tables given
    on the host are checked there to hold page ids in ``[0, P)``: B10 reads
    pages at the ids it is given."""
    if not torch.is_tensor(page_indices) or page_indices.device.type == "cpu":
        ids = np.asarray(page_indices)
        if ids.size and (ids.min() < 0 or ids.max() >= cache.num_pages):
            raise ValueError(f"page ids must lie in [0, {cache.num_pages}), "
                             f"got [{ids.min()}, {ids.max()}]")
    return _on(cache, page_indices, torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Public programs
# ---------------------------------------------------------------------------

def paged_decode_step(params, cache, input_ids, lengths, page_indices,
                      config: BitLlamaConfig, *, impl: str = "auto",
                      compute_dtype=torch.bfloat16):
    """One token per row with paged KV. ``input_ids [B, 1]``, ``lengths
    [B]`` each row's current length (its write position), ``page_indices
    [B, max_pages]`` (tensors or arrays; copied to the cache's device once
    per step). Every row is written and attends, inactive rows through
    all-zero tables onto the null page 0. Returns ``(logits [B, 1, V]
    fp32, cache)``, the cache updated in place."""
    if input_ids.shape[1] != 1:
        raise ValueError(f"paged_decode_step takes one token per row, got "
                         f"{input_ids.shape[1]}")
    x = _window_core(default_proj(params, config, impl, compute_dtype), cache,
                     _on(cache, input_ids, torch.long),
                     _on(cache, lengths, torch.long),
                     _tables(cache, page_indices), config, impl,
                     compute_dtype)
    return _lm_head(x, params, compute_dtype), cache


def paged_decode_block(params, cache, next_token, lengths, page_indices,
                       active, budget, generator, config: BitLlamaConfig, *,
                       sampling, n_steps: int, impl: str = "auto",
                       compute_dtype=torch.bfloat16):
    """``n_steps`` paged decode+sample steps on device tensors
    (paged.py:575-613), EOS and per-row budgets handled on the device as in
    :func:`~onebit_tpu_torch.model.ragged_decode.ragged_decode_block`:
    ``next_token``, ``lengths``, ``budget`` ``[B]`` long, ``active [B]``
    bool, ``page_indices [B, max_pages]`` int32, all on the cache's device
    (host tables are checked and copied once). Every row is written and
    attends, as in :func:`paged_decode_step`; the page tables hold for the
    whole block (only admission changes them, and admission flushes the
    engine's pipeline). Returns ``(toks [n_steps, B], valid [n_steps, B],
    cache, finals=(tok, lens, done, budget))``."""
    proj = default_proj(params, config, impl, compute_dtype)
    tables = _tables(cache, page_indices)

    def step(tok, lens, valid):
        x = _window_core(proj, cache, tok[:, None], lens, tables, config,
                         impl, compute_dtype)
        return sample_token(_lm_head(x, params, compute_dtype)[:, 0],
                            generator, sampling)

    toks, valid, finals = decode_block(step, next_token, lengths, active,
                                       budget, n_steps=n_steps,
                                       eos=config.eos_token_id)
    return toks, valid, cache, finals


def paged_prefill_rows(params, cache, ids, lengths, page_indices,
                       config: BitLlamaConfig, *, impl: str = "auto",
                       compute_dtype=torch.bfloat16):
    """Prefill several rows' pages in one call (batched paged admission):
    ``ids [R, S_pad]`` right-padded prompts, ``lengths [R]``,
    ``page_indices [R, max_pages]``. Pad rows may repeat a real row (its
    duplicate writes are identical). Returns ``(last_logits [R, V] fp32,
    cache)``."""
    lengths = _on(cache, lengths, torch.long)
    x = _prefill_rows_core(default_proj(params, config, impl, compute_dtype),
                           cache, _on(cache, ids, torch.long),
                           lengths, _tables(cache, page_indices),
                           config, impl, compute_dtype)
    last = x[torch.arange(x.shape[0], device=x.device),
             (lengths - 1).clamp(min=0)]
    return _lm_head(last, params, compute_dtype), cache


def paged_chunk_append_row(params, cache, ids, start: int, length: int,
                           page_indices_row, config: BitLlamaConfig, *,
                           impl: str = "auto", compute_dtype=torch.bfloat16):
    """Append a prompt chunk to ONE row's pages: ``ids [C]`` right-padded,
    written from position ``start``, ``length`` of them valid. The chunk
    attends to the row's earlier pages and to itself. Returns
    ``(logits [V] fp32 at the last valid token, cache)``."""
    x = _window_core(default_proj(params, config, impl, compute_dtype), cache,
                     _on(cache, ids, torch.long)[None, :],
                     _on(cache, [start], torch.long),
                     _tables(cache, page_indices_row)[None, :],
                     config, impl, compute_dtype)
    return _lm_head(x[0, length - 1], params, compute_dtype), cache


def paged_chunked_prefill_row(params, cache, prompt, page_indices_row,
                              config: BitLlamaConfig, *, chunk_size: int = 64,
                              impl: str = "auto",
                              compute_dtype=torch.bfloat16, start: int = 0,
                              step_fn=None):
    """Chunked paged prefill of one row: a host loop of
    :func:`paged_chunk_append_row` over ``prompt[start:]`` in chunks of
    ``chunk_size``. ``start`` skips tokens whose K/V already sit in the
    row's (shared) pages (prefix caching). ``step_fn(params, cache, ids,
    start, length, table_row)`` replaces the chunk program (the
    tensor-parallel engine passes ``TPServing.paged_chunk_append``).
    Returns ``(logits [V], cache)`` of the last chunk."""
    if step_fn is None:
        def step_fn(params, cache, ids, ci, length, table):
            return paged_chunk_append_row(params, cache, ids, ci, length,
                                          table, config, impl=impl,
                                          compute_dtype=compute_dtype)
    prompt = list(prompt)
    logits = None
    for ci in range(start, len(prompt), chunk_size):
        chunk = prompt[ci:ci + chunk_size]
        padded = np.zeros(chunk_size, np.int64)
        padded[:len(chunk)] = chunk
        logits, cache = step_fn(params, cache, padded, ci, len(chunk),
                                page_indices_row)
    return logits, cache
