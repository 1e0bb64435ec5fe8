"""Batch generation: one prefill of the left-padded prompt batch, then a
decode loop over a preallocated KV cache.

Port of ``onebit_tpu/engine/generate.py``. The prompts are left-padded to a
common length, so every row's last prompt token sits at the same cache
slot; the prefill masks the pads and gives each row its true positions, and
the decode loop masks the pad slots (``key_start``) and advances each row's
own position. Each decode step is one ``decode_step`` of every row at the
shared cache index, its attention over the dense cache in kernel B9 on the
card. The loop runs all its steps with no device-to-host read (a row that
has emitted EOS emits EOS again); the tokens come to the host once, at the
end, and each row is cut after its first EOS.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from onebit_tpu_torch.engine.sampler import SamplingConfig, sample_token
from onebit_tpu_torch.model.bitllama import (_attention, _causal_mask,
                                             _decoder_layer, _lm_head,
                                             decode_step, default_proj,
                                             init_kv_cache)
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.rope import apply_rope, rope_cos_sin


def _prefill(params, cache, ids, attn_mask, config: BitLlamaConfig, *,
             impl: str = "auto", compute_dtype=torch.bfloat16):
    """Prefill ``cache[:, :, 0:S]`` with the left-padded ``ids [B, S]``
    under the 1/0 padding mask ``attn_mask [B, S]``: positions
    ``max(cumsum(mask) - 1, 0)``, pad keys masked, each layer's attention
    over the whole cache as the reference's (generate.py:124-157). Returns
    the last position's logits ``[B, V]`` fp32; the cache is written in
    place."""
    b, s = ids.shape
    max_len = cache.max_len
    device = ids.device
    proj = default_proj(params, config, impl, compute_dtype)
    x = proj.embed(ids)
    positions = (torch.cumsum(attn_mask, dim=1) - 1).clamp(min=0)
    cos, sin = rope_cos_sin(positions, config.head_dim, config.rope_theta,
                            config.rope_scaling,
                            config.max_position_embeddings, seq_len=max_len,
                            dtype=compute_dtype)
    key_pad = torch.zeros(b, max_len, dtype=torch.bool, device=device)
    key_pad[:, :s] = attn_mask > 0
    mask = _causal_mask(s, max_len, 0, device) & key_pad[:, None, None, :]
    for i in range(config.num_hidden_layers):
        def attend(q, k, v, i=i):
            q, k = apply_rope(q, k, cos, sin)
            cache.k[i, :, :s] = k.to(cache.k.dtype)
            cache.v[i, :, :s] = v.to(cache.v.dtype)
            return _attention(q, cache.k[i].to(q.dtype),
                              cache.v[i].to(q.dtype), mask,
                              num_kv_groups=config.num_kv_groups)
        x = _decoder_layer(x, proj, i, attend)
    return _lm_head(proj.final(x[:, -1]), params, compute_dtype)


def _decode_loop(params, cache, last_token, start_index: int, prompt_len,
                 generator: torch.Generator, config: BitLlamaConfig, *,
                 sampling: SamplingConfig, num_steps: int,
                 impl: str = "auto", compute_dtype=torch.bfloat16,
                 eos_id: int = 2):
    """``num_steps`` decode steps for the whole batch (generate.py:25-60).

    ``last_token [B, 1]`` on the cache's device; ``start_index`` the host
    int cache fill; ``prompt_len [B]`` each row's true prompt length, so
    row ``b`` continues at position ``prompt_len[b]`` and masks the pad
    slots below ``start_index - prompt_len[b]``. A row that emitted EOS
    emits EOS. Every step runs, with no read of the device. Returns
    ``(tokens [B, num_steps], done [B], cache)`` on the device."""
    device = cache.k.device
    b = last_token.shape[0]
    prompt_len = torch.as_tensor(prompt_len, device=device)
    key_start = (start_index - prompt_len).to(torch.int32)
    pos = prompt_len.to(torch.long)
    tok = last_token
    done = torch.zeros(b, dtype=torch.bool, device=device)
    out = []
    for step in range(num_steps):
        logits, cache = decode_step(params, cache, tok, start_index + step,
                                    config, impl=impl,
                                    compute_dtype=compute_dtype,
                                    positions=pos[:, None],
                                    key_start=key_start)
        nxt = sample_token(logits[:, -1], generator, sampling)
        nxt = torch.where(done, eos_id, nxt)
        done = done | (nxt == eos_id)
        out.append(nxt)
        tok, pos = nxt[:, None], pos + 1
    toks = (torch.stack(out, dim=1) if out
            else torch.zeros(b, 0, dtype=torch.long, device=device))
    return toks, done, cache


def left_pad(prompts: Sequence[Sequence[int]]):
    """``(ids [B, S], mask [B, S])`` int64 numpy arrays: the prompts
    left-padded with 0 to the longest, and the 1/0 mask of their tokens."""
    plens = np.asarray([len(p) for p in prompts])
    ids = np.zeros((len(prompts), plens.max()), np.int64)
    for r, p in enumerate(prompts):
        ids[r, ids.shape[1] - len(p):] = p
    mask = np.arange(ids.shape[1])[None, :] >= (ids.shape[1] - plens)[:, None]
    return ids, mask.astype(np.int64)


def generate(params, config: BitLlamaConfig,
             prompts: Sequence[Sequence[int]], *, max_new_tokens: int = 64,
             sampling: Optional[SamplingConfig] = None, impl: str = "auto",
             compute_dtype=torch.bfloat16, eos_id: Optional[int] = None,
             seed: int = 0, max_len: Optional[int] = None
             ) -> List[List[int]]:
    """New tokens for each prompt (generate.py:63-121), on the params'
    device: greedy, or sampled from a ``torch.Generator`` seeded with
    ``seed`` (its stream is not JAX's, so sampled tokens agree with the JAX
    package in distribution only). Each row is cut after its first EOS.

    The cache holds ``max_len`` positions, by default the next power of two
    of the longest prompt plus ``max_new_tokens``; a given ``max_len`` that
    is too short raises ``ValueError``."""
    sampling = sampling or SamplingConfig(greedy=True)
    eos_id = config.eos_token_id if eos_id is None else eos_id
    b = len(prompts)
    plens = [len(p) for p in prompts]
    maxp = max(plens)
    total = maxp + max_new_tokens
    if max_len is None:
        max_len = 1 << (total - 1).bit_length()
    elif total > max_len:
        raise ValueError(
            f"prompt ({maxp}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds max_len {max_len}; the cache would silently clamp "
            "writes past the end")
    device = params["embed_tokens"].device
    ids, attn = (torch.from_numpy(a).to(device) for a in left_pad(prompts))
    cache = init_kv_cache(config, b, max_len, dtype=compute_dtype,
                          device=device)
    logits = _prefill(params, cache, ids, attn, config, impl=impl,
                      compute_dtype=compute_dtype)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    last = sample_token(logits, generator, sampling)[:, None]
    toks, _, _ = _decode_loop(
        params, cache, last, maxp, plens, generator, config,
        sampling=sampling, num_steps=max_new_tokens - 1, impl=impl,
        compute_dtype=compute_dtype, eos_id=eos_id)
    out = torch.cat([last, toks], dim=1).tolist()
    return [row[:row.index(eos_id) + 1] if eos_id in row else row
            for row in out]
