"""Ragged decode step and batched prefill over a dense KV cache.

Port of the dense branch of ``onebit_tpu/model/ragged_decode.py``: each
batch row carries its own cache position, so rows admitted at different
times decode together. PyTorch runs eagerly, so the layer loop is a Python
loop and the cache is updated **in place** (the JAX functions return a new
cache; these return the same ``KVCache`` object, mutated).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from onebit_tpu_torch.model import bitllama
from onebit_tpu_torch.model.bitllama import (
    KVCache,
    _project_flat,
    _project_gateup_flat,
    _project_qkv_flat,
)
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.rope import apply_rope, rope_cos_sin


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


def _layer_body(x, layers, i, config, impl, attend, rows_shape):
    """One decoder layer around ``attend(q, k, v) -> ctx``."""
    b, s = rows_shape
    nh, nkv, hd = (config.num_attention_heads, config.num_key_value_heads,
                   config.head_dim)
    residual = x
    hx = bitllama.rms_norm(x, layers["input_layernorm"][i],
                           config.rms_norm_eps)
    q, k, v = _project_qkv_flat(hx, layers, i, impl, nkv * hd)
    ctx = attend(q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd),
                 v.reshape(b, s, nkv, hd))
    x = residual + _project_flat(ctx.reshape(b, s, nh * hd), layers,
                                 "o_proj", i, impl)
    residual = x
    hx = bitllama.rms_norm(x, layers["post_attention_layernorm"][i],
                           config.rms_norm_eps)
    gate, up = _project_gateup_flat(hx, layers, i, impl,
                                    config.intermediate_size)
    return residual + _project_flat(F.silu(gate) * up, layers, "down_proj",
                                    i, impl)


def _lm_head(x, params, compute_dtype) -> torch.Tensor:
    """fp32-accumulated logits (ragged_decode.py:265-267)."""
    w = params["lm_head"].to(compute_dtype)
    return torch.matmul(x.float(), w.float().T)


def ragged_decode_step(params, cache: KVCache, input_ids, row_pos, active,
                       config: BitLlamaConfig, *, impl: str = "auto",
                       compute_dtype=torch.bfloat16):
    """One token per row at per-row positions.

    ``input_ids [B, 1]`` tensor on the cache's device; ``row_pos [B]`` each
    row's length (its cache write slot) and ``active [B]`` bool, as numpy
    arrays (host values: the attention window is chosen from them without
    a device read). Inactive rows are fully masked, but their cache row is
    still written at ``row_pos``. Returns ``(logits [B, 1, V] fp32, cache)``.
    """
    b, s = input_ids.shape
    if s != 1:
        raise ValueError(f"ragged_decode_step takes one token per row, got {s}")
    device = cache.k.device
    max_len = cache.max_len
    pos_np, act_np = np.asarray(row_pos), np.asarray(active, bool)
    pos = torch.as_tensor(pos_np, dtype=torch.long).to(device)
    act = torch.as_tensor(act_np).to(device)

    x = params["embed_tokens"][input_ids].to(compute_dtype)
    cos, sin = rope_cos_sin(pos[:, None], config.head_dim, config.rope_theta,
                            config.rope_scaling,
                            config.max_position_embeddings, seq_len=max_len,
                            dtype=compute_dtype)
    kj = torch.arange(max_len, device=device)
    mask = ((kj[None, :] <= pos[:, None]) & act[:, None])[:, None, None, :]
    width = attention_width(pos_np, act_np, max_len)
    rows = torch.arange(b, device=device)
    layers = params["layers"]

    for i in range(config.num_hidden_layers):
        def attend(q, k, v, i=i):
            q, k = apply_rope(q, k, cos, sin)
            cache.k[i, rows, pos] = k[:, 0].to(cache.k.dtype)
            cache.v[i, rows, pos] = v[:, 0].to(cache.v.dtype)
            # positions past a row's length are masked exactly; the window
            # only bounds how much of the cache is read
            return bitllama._attention(
                q, cache.k[i, :, :width].to(q.dtype),
                cache.v[i, :, :width].to(q.dtype), mask[..., :width],
                num_kv_groups=config.num_kv_groups)
        x = _layer_body(x, layers, i, config, impl, attend, (b, 1))

    x = bitllama.rms_norm(x, params["final_norm"], config.rms_norm_eps)
    return _lm_head(x, params, compute_dtype), cache


def prefill_rows(params, cache: KVCache, ids, lengths, rows,
                 config: BitLlamaConfig, *, impl: str = "auto",
                 compute_dtype=torch.bfloat16):
    """Prefill several cache slots at once (batched admission).

    ``ids [R, S_pad]`` right-padded prompts, ``lengths [R]`` true lengths,
    ``rows [R]`` slot indices (tensors on the cache's device). Rows attend
    only within themselves. Prompt K/V are written to the cache in place;
    attention within the prefill uses the full-precision K/V. Returns
    ``(last_logits [R, V] fp32, cache)``.
    """
    r, s_pad = ids.shape
    device = cache.k.device
    lengths = lengths.to(device=device, dtype=torch.long)
    rows = rows.to(device=device, dtype=torch.long)
    x = params["embed_tokens"][ids].to(compute_dtype)
    positions = torch.arange(s_pad, device=device)
    cos, sin = rope_cos_sin(positions[None, :], config.head_dim,
                            config.rope_theta, config.rope_scaling,
                            config.max_position_embeddings,
                            seq_len=cache.max_len, dtype=compute_dtype)
    attn = positions[None, :] < lengths[:, None]
    mask = bitllama._causal_mask(s_pad, s_pad, 0, device) & \
        attn[:, None, None, :]
    layers = params["layers"]

    for i in range(config.num_hidden_layers):
        def attend(q, k, v, i=i):
            q, k = apply_rope(q, k, cos, sin)
            cache.k[i, rows, :s_pad] = k.to(cache.k.dtype)
            cache.v[i, rows, :s_pad] = v.to(cache.v.dtype)
            return bitllama._attention(q, k, v, mask,
                                       num_kv_groups=config.num_kv_groups)
        x = _layer_body(x, layers, i, config, impl, attend, (r, s_pad))

    x = bitllama.rms_norm(x, params["final_norm"], config.rms_norm_eps)
    last = x[torch.arange(r, device=device), (lengths - 1).clamp(min=0)]
    return _lm_head(last, params, compute_dtype), cache
