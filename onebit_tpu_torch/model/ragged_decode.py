"""Ragged decode step and batched prefill over a dense or quantized KV
cache.

Port of ``onebit_tpu/model/ragged_decode.py`` for the dense ``KVCache`` and
the quantized ``QuantKVCacheKT`` (int8) and ``QuantKVCacheKT4`` (int4)
pools: each batch row carries its own cache position, so rows admitted at
different times decode together. PyTorch runs eagerly, so the layer loop is
a Python loop and the cache is updated **in place** (the JAX functions
return a new cache; these return the same cache object, mutated).

With a quantized cache every decode layer quantizes its new K/V and makes
one call of the fused append+attend wrapper (``kernels/kv_attention.py``,
B5 or B7), which writes the pools and attends; ``impl="torch"`` takes the
wrappers' plain versions. The kernels take any T (int4: any even T), so
the reference's short-cache fallback is not needed. With the dense cache on
the card each decode layer writes its row positions, then attends the whole
pool in kernel B9 over each row's length; on the CPU and with
``impl="torch"`` it attends the length-aware window of the reference.

Several tokens a row at once take the plain masked attention over the
row's whole cache, as JAX's XLA computes them: ``chunk_append_row`` (the
chunked prefill's chunk, driven by ``chunked_prefill_row``) and
``ragged_verify_window`` (speculative decoding's verify step), on the
dense and the int8 KT cache. Writes at ``max_len`` or past it are dropped,
as JAX's scatter drops them (a speculative round near a full row), and
such a position attends every key.

``ragged_decode_hidden``, ``prefill_rows_hidden`` and
``chunk_append_hidden`` run the same steps through a projection strategy
up to the final norm: a tensor-parallel rank's, on its shards and
head-sharded cache (``engine/tp_backend.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from onebit_tpu_torch.engine.sampler import sample_token
from onebit_tpu_torch.kernels.kv_attention import (PLAIN, _attention_quant,
                                                   kv_attention_append_kt,
                                                   kv_attention_append_kt4,
                                                   kv_attention_decode)
from onebit_tpu_torch.model import bitllama
from onebit_tpu_torch.model.bitllama import (KVCache, Proj, _decoder_layer,
                                             _lm_head, default_proj)
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.kv_cache import (QuantKVCacheKT, QuantKVCacheKT4,
                                             merge_nibbles, quantize_kv,
                                             quantize_kv4)
from onebit_tpu_torch.model.rope import apply_rope, rope_cos_sin
from onebit_tpu_torch.utils.device import on_card


def attention_widths(max_len: int):
    """The window ladder: powers of two from 128 up to ``max_len``."""
    if max_len < 128:
        return [max_len]
    widths, w = [], 128
    while w < max_len:
        widths.append(w)
        w *= 2
    return widths + [max_len]


def attention_width(row_pos: np.ndarray, active: np.ndarray,
                    max_len: int) -> int:
    """The smallest ladder width covering ``max(active row_pos) + 1``,
    chosen on the host (ragged_decode.py:79-92)."""
    need = int(np.max(np.where(active, row_pos, 0))) + 1
    return next((w for w in attention_widths(max_len) if w >= need), max_len)


def _quant_family(cache):
    """(quantize, fused append+attend) of a quantized cache, else None."""
    if isinstance(cache, QuantKVCacheKT4):
        return quantize_kv4, kv_attention_append_kt4
    if isinstance(cache, QuantKVCacheKT):
        return quantize_kv, kv_attention_append_kt
    return None


def _decode_attention(cache, pos, act, width, cos, sin,
                      config: BitLlamaConfig, impl: str,
                      overflow: bool = False):
    """``attend_at(i)``: layer ``i``'s attention for one decode step, with
    what every layer shares computed once. ``width`` bounds the window of
    the plain branch (None: the whole cache). ``overflow`` (a dense cache
    only): some position may be ``max_len`` or past it; its write is
    dropped and it attends every key."""
    b = pos.shape[0]
    family = _quant_family(cache)
    if family is not None:
        quantize, fused = family
        if impl == "torch":
            fused = PLAIN[fused]
        # per-row lengths (ragged_decode.py:77) and write positions, on the
        # device once per step for all layers
        lengths = torch.where(act, pos + 1, 0).to(torch.int32)
        pos32 = pos.to(torch.int32)

        def attend_at(i):
            def attend(q, k, v):
                q, k = apply_rope(q, k, cos, sin)
                nkq, nks = quantize(k[:, 0])
                nvq, nvs = quantize(v[:, 0])
                # the wrapper writes the pools at pos (inactive rows too)
                # and attends over [0, lengths)
                return fused(q[:, 0].contiguous(), nkq, nks, nvq, nvs,
                             *cache, lengths, i, pos32)[:, None]
            return attend
        return attend_at

    rows = torch.arange(b, device=pos.device)
    max_len = cache.max_len
    if overflow:
        # a speculative round's positions may pass the cache: JAX's scatter
        # drops those writes and its mask then covers every key, so the
        # write at a clamped slot keeps the slot's old value
        keep = (pos < max_len)[:, None, None]
        pos = pos.clamp(max=max_len - 1)

    def write(i, k, v):
        for pool, new in ((cache.k, k), (cache.v, v)):
            new = new[:, 0].to(pool.dtype)
            if overflow:
                new = torch.where(keep, new, pool[i, rows, pos])
            pool[i, rows, pos] = new

    if on_card(cache.k) and impl != "torch":
        # B9 over the whole pool: each row's positions [0, length) only
        lengths = torch.where(act, pos + 1, 0).to(torch.int32)

        def attend_at(i):
            def attend(q, k, v):
                q, k = apply_rope(q, k, cos, sin)
                write(i, k, v)
                return kv_attention_decode(q[:, 0].contiguous(), cache.k,
                                           None, cache.v, None, lengths,
                                           i)[:, None]
            return attend
        return attend_at

    kj = torch.arange(max_len, device=pos.device)
    mask = ((kj[None, :] <= pos[:, None]) & act[:, None])[:, None, None, :]
    width = max_len if width is None else width

    def attend_at(i):
        def attend(q, k, v):
            q, k = apply_rope(q, k, cos, sin)
            write(i, k, v)
            # positions past a row's length are masked exactly; the window
            # only bounds how much of the cache is read
            return bitllama._attention(
                q, cache.k[i, :, :width].to(q.dtype),
                cache.v[i, :, :width].to(q.dtype), mask[..., :width],
                num_kv_groups=config.num_kv_groups)
        return attend
    return attend_at


def ragged_decode_core(proj: Proj, cache, input_ids, pos, act,
                       config: BitLlamaConfig, *, impl: str = "auto",
                       compute_dtype=torch.bfloat16, width=None,
                       overflow: bool = False) -> torch.Tensor:
    """One decode step on device tensors only, up to the final norm:
    ``input_ids [B, 1]``, ``pos [B]`` long and ``act [B]`` bool on the
    cache's device; returns the hidden ``[B, 1, d]``. Nothing is read back
    to the host, so a decode block runs it inside a CUDA graph. ``width``
    (a host int) bounds the plain branch's window; None reads the whole
    cache, which masks the same positions and only regroups the
    reduction. ``overflow``: some row's position may reach ``max_len``
    (a speculative round's draft near a full row)."""
    x = proj.embed(input_ids)
    cos, sin = rope_cos_sin(pos[:, None], config.head_dim, config.rope_theta,
                            config.rope_scaling,
                            config.max_position_embeddings,
                            seq_len=cache.max_len, dtype=compute_dtype)
    attend_at = _decode_attention(cache, pos, act, width, cos, sin, config,
                                  impl, overflow)
    for i in range(config.num_hidden_layers):
        x = _decoder_layer(x, proj, i, attend_at(i))
    return proj.final(x)


def ragged_decode_hidden(proj: Proj, cache, input_ids, row_pos, active,
                         config: BitLlamaConfig, *, impl: str = "auto",
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`ragged_decode_step` through the projection strategy ``proj``,
    up to the final norm: returns the hidden ``[B, 1, d]``. The attention
    runs on the heads the cache holds (a tensor-parallel rank's
    ``nkv / mp``)."""
    s = input_ids.shape[1]
    if s != 1:
        raise ValueError(f"ragged_decode_step takes one token per row, got {s}")
    device = cache[0].device
    pos_np, act_np = np.asarray(row_pos), np.asarray(active, bool)
    overflow = bool((pos_np >= cache.max_len).any())
    if overflow and not isinstance(cache, KVCache):
        raise ValueError(f"positions past max_len {cache.max_len} are "
                         "served by the dense cache only (a draft's)")
    pos = torch.as_tensor(pos_np, dtype=torch.long).to(device)
    act = torch.as_tensor(act_np).to(device)
    return ragged_decode_core(
        proj, cache, input_ids, pos, act, config, impl=impl,
        compute_dtype=compute_dtype,
        width=attention_width(pos_np, act_np, cache.max_len),
        overflow=overflow)


def ragged_decode_step(params, cache, input_ids, row_pos, active,
                       config: BitLlamaConfig, *, impl: str = "auto",
                       compute_dtype=torch.bfloat16):
    """One token per row at per-row positions.

    ``cache`` is a ``KVCache``, ``QuantKVCacheKT`` or ``QuantKVCacheKT4``;
    ``input_ids [B, 1]`` tensor on the cache's device; ``row_pos [B]`` each
    row's length (its cache write slot) and ``active [B]`` bool, as numpy
    arrays (host values: the attention window is chosen from them without
    a device read). Inactive rows are fully masked, but their cache row is
    still written at ``row_pos``. Returns ``(logits [B, 1, V] fp32, cache)``.
    """
    x = ragged_decode_hidden(default_proj(params, config, impl, compute_dtype),
                             cache, input_ids, row_pos, active, config,
                             impl=impl, compute_dtype=compute_dtype)
    return _lm_head(x, params, compute_dtype), cache


def decode_block(step, next_token, row_pos, active, budget, *,
                 n_steps: int, eos: int):
    """The body of the JAX blocks' ``lax.scan`` (ragged_decode.py:495-507)
    as a loop over device tensors: ``step(tok [B], pos [B], valid [B])``
    runs one decode step and returns the sampled next tokens ``[B]``. A row
    that emits ``eos`` or spends its ``budget`` is frozen: it still runs
    the model, and ``torch.where`` holds its token and position. Returns
    ``(toks [n_steps, B], valid [n_steps, B], (tok, pos, done, budget))``,
    the finals from which the next block chains."""
    tok, pos, bud, done = next_token, row_pos, budget, ~active
    toks, valids = [], []
    for _ in range(n_steps):
        valid = active & ~done
        nxt = torch.where(valid, step(tok, pos, valid), tok)
        pos = torch.where(valid, pos + 1, pos)
        bud = torch.where(valid, bud - 1, bud)
        done = done | (valid & ((nxt == eos) | (bud <= 0)))
        tok = nxt
        toks.append(nxt)
        valids.append(valid)
    return torch.stack(toks), torch.stack(valids), (tok, pos, done, bud)


def ragged_decode_block(params, cache, next_token, row_pos, active, budget,
                        generator, config: BitLlamaConfig, *, sampling,
                        n_steps: int, impl: str = "auto",
                        compute_dtype=torch.bfloat16):
    """``n_steps`` decode+sample steps on device tensors
    (ragged_decode.py:465-513), EOS and per-row budgets handled on the
    device: ``next_token``, ``row_pos``, ``budget`` ``[B]`` long and
    ``active [B]`` bool on the cache's device, ``generator`` the sampler's
    ``torch.Generator``. ``cache`` is a ``KVCache``, ``QuantKVCacheKT`` or
    ``QuantKVCacheKT4``, updated in place. Nothing is read back to the
    host, so the engine captures it as one CUDA graph
    (``engine/block_graph.py``); run eagerly it is the CPU's block and
    what the graph is held against. Returns ``(toks [n_steps, B], valid
    [n_steps, B], cache, finals=(tok, pos, done, budget))``."""
    proj = default_proj(params, config, impl, compute_dtype)

    def step(tok, pos, valid):
        x = ragged_decode_core(proj, cache, tok[:, None], pos, valid, config,
                               impl=impl, compute_dtype=compute_dtype)
        return sample_token(_lm_head(x, params, compute_dtype)[:, 0],
                            generator, sampling)

    toks, valid, finals = decode_block(step, next_token, row_pos, active,
                                       budget, n_steps=n_steps,
                                       eos=config.eos_token_id)
    return toks, valid, cache, finals


def _prefill_write(cache, i: int, rows, k, v) -> None:
    """Write the prompt K/V ``[R, S_pad, nkv, hd]`` of layer ``i`` into
    rows ``rows`` of the cache, positions ``[0, S_pad)``: as they are into a
    dense cache, quantized into a quantized one (ragged_decode.py:383-437).
    One bulk write per layer, by plain indexing."""
    s_pad = k.shape[1]
    if isinstance(cache, KVCache):
        cache.k[i, rows, :s_pad] = k.to(cache.k.dtype)
        cache.v[i, rows, :s_pad] = v.to(cache.v.dtype)
        return
    quantize, _ = _quant_family(cache)
    nkq, nks = quantize(k)
    nvq, nvs = quantize(v)
    k_pool, k_st, v_pool, v_s = cache
    k_st[i, rows, :, :s_pad] = nks.transpose(1, 2)
    v_s[i, rows, :s_pad] = nvs
    nkq_t = nkq.permute(0, 2, 3, 1)                    # [R, nkv, hd, S_pad]
    if isinstance(cache, QuantKVCacheKT):
        k_pool[i, rows, :, :, :s_pad] = nkq_t
        v_pool[i, rows, :s_pad] = nvq
        return
    # int4 half plane: position p < T/2 goes to byte p's low nibble, p >= T/2
    # to byte p - T/2's high nibble; each merge keeps the partner nibble
    # (stale bytes of a slot's previous occupant are masked by length)
    t_half = cache.max_len // 2
    for hi, p0 in ((False, 0), (True, t_half)):
        n = min(s_pad - p0, t_half)        # this plane's prompt positions
        if n <= 0:
            continue
        k_pool[i, rows, :, :, :n] = merge_nibbles(
            k_pool[i, rows, :, :, :n], nkq_t[..., p0:p0 + n], hi)
        v_pool[i, rows, :n] = merge_nibbles(
            v_pool[i, rows, :n], nvq[:, p0:p0 + n], hi)


def prefill_rows_hidden(proj: Proj, cache, ids, lengths, rows,
                        config: BitLlamaConfig, *, impl: str = "auto",
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`prefill_rows` through the projection strategy ``proj``, up to
    the final norm: returns each row's last hidden ``[R, d]``."""
    r, s_pad = ids.shape
    device = cache[0].device
    lengths = lengths.to(device=device, dtype=torch.long)
    rows = rows.to(device=device, dtype=torch.long)
    x = proj.embed(ids)
    positions = torch.arange(s_pad, device=device)
    cos, sin = rope_cos_sin(positions[None, :], config.head_dim,
                            config.rope_theta, config.rope_scaling,
                            config.max_position_embeddings,
                            seq_len=cache.max_len, dtype=compute_dtype)
    attn = positions[None, :] < lengths[:, None]
    mask = bitllama._causal_mask(s_pad, s_pad, 0, device) & \
        attn[:, None, None, :]

    for i in range(config.num_hidden_layers):
        def attend(q, k, v, i=i):
            q, k = apply_rope(q, k, cos, sin)
            _prefill_write(cache, i, rows, k, v)
            return bitllama._attention(q, k, v, mask,
                                       num_kv_groups=config.num_kv_groups)
        x = _decoder_layer(x, proj, i, attend)

    x = proj.final(x)
    return x[torch.arange(r, device=device), (lengths - 1).clamp(min=0)]


def prefill_rows(params, cache, ids, lengths, rows,
                 config: BitLlamaConfig, *, impl: str = "auto",
                 compute_dtype=torch.bfloat16):
    """Prefill several cache slots at once (batched admission).

    ``cache`` is a ``KVCache``, ``QuantKVCacheKT`` or ``QuantKVCacheKT4``;
    ``ids [R, S_pad]`` right-padded prompts, ``lengths [R]`` true lengths,
    ``rows [R]`` slot indices (tensors on the cache's device). Rows attend
    only within themselves. Prompt K/V are written to the cache in place
    (quantized at insertion into a quantized cache); attention within the
    prefill uses the full-precision K/V. Returns
    ``(last_logits [R, V] fp32, cache)``.
    """
    last = prefill_rows_hidden(
        default_proj(params, config, impl, compute_dtype), cache, ids,
        lengths, rows, config, impl=impl, compute_dtype=compute_dtype)
    return _lm_head(last, params, compute_dtype), cache


def prefill_row(params, cache, ids, length, row, config: BitLlamaConfig, *,
                impl: str = "auto", compute_dtype=torch.bfloat16):
    """Prefill ONE slot ``row`` of the cache with the right-padded prompt
    ``ids [S_pad]`` of true length ``length`` (ragged_decode.py:273):
    :func:`prefill_rows` with one row. Returns ``(last_logits [V] fp32,
    cache)``, the cache written in place."""
    device = cache[0].device
    as_row = lambda x: torch.as_tensor(x, device=device).reshape(1)  # noqa
    logits, cache = prefill_rows(params, cache, ids.reshape(1, -1),
                                 as_row(length), as_row(row), config,
                                 impl=impl, compute_dtype=compute_dtype)
    return logits[0], cache


# ---- chunked prefill and the verify window (several tokens a row) ----------

def _window_write(cache, i: int, rows, positions, k, v) -> None:
    """Write the window K/V ``[R, W, nkv, hd]`` of layer ``i`` at
    ``(rows [R, W], positions [R, W])`` into a dense or int8 KT cache, the
    values JAX's scatters write (ragged_decode.py:736-756). Index tensors
    on the cache's device; positions are in range (the caller drops the
    others)."""
    if isinstance(cache, KVCache):
        cache.k[i, rows, positions] = k.to(cache.k.dtype)
        cache.v[i, rows, positions] = v.to(cache.v.dtype)
        return
    nkq, nks = quantize_kv(k)
    nvq, nvs = quantize_kv(v)
    # mixed advanced indexing: the indexed dimensions go first, so the
    # values keep the window's [R, W, ...] shape, as in JAX
    cache.k_qt[i, rows, :, :, positions] = nkq
    cache.k_st[i, rows, :, positions] = nks
    cache.v_q[i, rows, positions] = nvq
    cache.v_s[i, rows, positions] = nvs


def _window_attend(cache, i: int, rows: slice, q, mask,
                   config: BitLlamaConfig):
    """The window's queries ``[R, W, nh, hd]`` over the whole of their
    rows (the slice ``rows``), under ``mask [R, 1, W, T]``: the plain masked
    attention, on the int8 pools with their scales folded in for a KT
    cache, as JAX computes it (XLA, not a kernel)."""
    g = config.num_kv_groups
    if isinstance(cache, KVCache):
        return bitllama._attention(q, cache.k[i, rows].to(q.dtype),
                                   cache.v[i, rows].to(q.dtype), mask,
                                   num_kv_groups=g)
    return _attention_quant(q, cache.k_qt[i, rows].permute(0, 3, 1, 2),
                            cache.k_st[i, rows].transpose(1, 2),
                            cache.v_q[i, rows], cache.v_s[i, rows], mask,
                            num_kv_groups=g)


def _window_hidden(proj: Proj, cache, tokens, row_pos, rows: slice,
                   config: BitLlamaConfig, *, compute_dtype, active=None):
    """``tokens [R, W]`` of the cache rows ``rows`` (a slice) at positions
    ``row_pos[r] .. row_pos[r] + W - 1`` (host ints), each query attending
    its row's keys ``j <= position`` (none for a row whose ``active [R]``
    is False); returns the final-normed hidden ``[R, W, d]``.
    Writes at ``max_len`` or past it are dropped, as JAX's scatter drops
    them; the mask then covers every key. A dense or int8 KT cache,
    written in place."""
    r, w = tokens.shape
    device = cache[0].device
    max_len = cache.max_len
    pos_np = np.asarray(row_pos, np.int64)[:, None] + np.arange(w)
    positions = torch.from_numpy(pos_np).to(device)
    cos, sin = rope_cos_sin(positions, config.head_dim, config.rope_theta,
                            config.rope_scaling,
                            config.max_position_embeddings, seq_len=max_len,
                            dtype=compute_dtype)
    kj = torch.arange(max_len, device=device)
    mask = (kj <= positions[:, :, None])[:, None]             # [R, 1, W, T]
    if active is not None:
        mask = mask & active[:, None, None, None]
    rows_np = np.arange(cache[0].shape[1])[rows]
    keep = pos_np < max_len
    # the in-range (row, position) pairs, chosen on the host
    w_rows = torch.from_numpy(np.broadcast_to(rows_np[:, None], pos_np.shape)
                              [keep]).to(device)
    w_pos = torch.from_numpy(pos_np[keep]).to(device)
    w_keep = None if keep.all() else torch.from_numpy(keep).to(device)
    x = proj.embed(tokens)
    for i in range(config.num_hidden_layers):
        def attend(q, k, v, i=i):
            q, k = apply_rope(q, k, cos, sin)
            if w_keep is None:
                _window_write(cache, i, w_rows.view(r, w),
                              w_pos.view(r, w), k, v)
            else:
                _window_write(cache, i, w_rows, w_pos, k[w_keep], v[w_keep])
            return _window_attend(cache, i, rows, q, mask, config)
        x = _decoder_layer(x, proj, i, attend)
    return proj.final(x)


def _check_window_cache(cache, what: str) -> None:
    if not isinstance(cache, (KVCache, QuantKVCacheKT)):
        raise TypeError(f"{what} takes a KVCache or a QuantKVCacheKT, got "
                        f"{type(cache).__name__}")


def chunk_append_hidden(proj: Proj, cache, ids, start: int, length: int,
                        row: int, config: BitLlamaConfig, *,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`chunk_append_row` through the projection strategy ``proj``
    (a tensor-parallel rank's over its head-sharded cache): returns the
    final-normed hidden ``[d]`` of the chunk's last valid token."""
    _check_window_cache(cache, "chunk_append_row")
    ids = torch.as_tensor(np.asarray(ids) if not torch.is_tensor(ids)
                          else ids).to(cache[0].device, torch.long)
    row = int(row)
    x = _window_hidden(proj, cache, ids.reshape(1, -1), [int(start)],
                       slice(row, row + 1), config,
                       compute_dtype=compute_dtype)
    return x[0, int(length) - 1]


def chunk_append_row(params, cache, ids, start: int, length: int, row: int,
                     config: BitLlamaConfig, *, impl: str = "auto",
                     compute_dtype=torch.bfloat16):
    """Append a fixed-size chunk of prompt tokens to ONE cache row
    (ragged_decode.py:514-672): ``ids [C]`` right-padded, written from
    position ``start`` (a host int), ``length`` of them valid, into slot
    ``row``. The chunk attends to the row's earlier cache and to itself
    (causal), over the plain masked attention; a ``QuantKVCacheKT`` takes
    the chunk's K/V quantized at insertion and attends its int8 pools.
    Pad positions past ``max_len`` are dropped; JAX's
    ``dynamic_update_slice`` instead moves the whole chunk back over
    earlier prompt positions (ROADMAP.md §3). Returns
    ``(last_valid_logits [V] fp32, cache)``, the cache written in place."""
    x = chunk_append_hidden(default_proj(params, config, impl, compute_dtype),
                            cache, ids, start, length, row, config,
                            compute_dtype=compute_dtype)
    return _lm_head(x, params, compute_dtype), cache


def chunked_prefill_row(params, cache, prompt, row: int,
                        config: BitLlamaConfig, *, chunk_size: int = 64,
                        impl: str = "auto", compute_dtype=torch.bfloat16,
                        step_fn=None):
    """Prefill one slot in fixed-size chunks, a host loop of
    :func:`chunk_append_row` (ragged_decode.py:782-817). ``step_fn(params,
    cache, ids, start, length, row) -> (logits, cache)`` replaces the chunk
    program (the tensor-parallel engine passes ``TPServing.chunk_append``).
    Returns ``(logits [V] of the last prompt token, cache)``."""
    if step_fn is None:
        def step_fn(params, cache, ids, ci, length, row_):
            return chunk_append_row(params, cache, ids, ci, length, row_,
                                    config, impl=impl,
                                    compute_dtype=compute_dtype)
    prompt = list(prompt)
    logits = None
    for ci in range(0, len(prompt), chunk_size):
        chunk = prompt[ci:ci + chunk_size]
        padded = np.zeros(chunk_size, np.int64)
        padded[:len(chunk)] = chunk
        logits, cache = step_fn(params, cache, padded, ci, len(chunk), row)
    return logits, cache


def ragged_verify_window(params, cache, tokens, row_pos, active,
                         config: BitLlamaConfig, *, impl: str = "auto",
                         compute_dtype=torch.bfloat16):
    """W tokens a row at per-row positions, logits at every position
    (ragged_decode.py:673-779): the speculative round's verify step.
    ``tokens [B, W]`` on the cache's device are consumed at ``row_pos[b]
    .. row_pos[b] + W - 1`` (``row_pos``, ``active`` host arrays); their
    K/V go into the cache (quantized at insertion into a
    ``QuantKVCacheKT``), writes at ``max_len`` or past it dropped. Each
    query attends its row's keys up to its position through the plain
    masked attention, as JAX's XLA does; inactive rows are masked whole.
    Returns ``(logits [B, W, V] fp32, cache)``."""
    x = verify_window_hidden(default_proj(params, config, impl,
                                          compute_dtype),
                             cache, tokens, row_pos, active, config,
                             compute_dtype=compute_dtype)
    return _lm_head(x, params, compute_dtype), cache


def verify_window_hidden(proj: Proj, cache, tokens, row_pos, active,
                         config: BitLlamaConfig, *,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`ragged_verify_window` through the projection strategy
    ``proj`` (a tensor-parallel rank's over its head-sharded cache, the
    counterpart of JAX's ``_dense_core(attend_cache=True)`` and
    ``_kt_window_core``, ``tp_backend.py:248-300``): returns the
    final-normed hidden ``[B, W, d]``."""
    _check_window_cache(cache, "ragged_verify_window")
    act = torch.as_tensor(np.asarray(active, bool)).to(cache[0].device)
    return _window_hidden(proj, cache, tokens, row_pos, slice(None), config,
                          compute_dtype=compute_dtype, active=act)
