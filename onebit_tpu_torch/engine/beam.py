"""Beam search over a preallocated dense cache.

Port of ``onebit_tpu/engine/beam.py``, the reference's beam path (HF
``generate(num_beams=...)``, whose ``_reorder_cache`` shuffles the cache by
beam every step):

* the prompts are prefilled once, left-padded (``engine/generate.py``
  ``_prefill``), and each row's cache is repeated to its ``K`` beams on the
  batch axis (``B*K`` rows);
* each step is one ``decode_step`` of every beam at the shared cache index
  (its attention in kernel B9 on the card), then the cache is gathered by
  each beam's parent;
* the alive/finished split of flax/t5x: each step draws ``2K`` candidates,
  so that EOS hits retire into the finished set without starving the alive
  one; a finished hypothesis scores ``sum_logp / len ** length_penalty``.

Selections are stable sorts, which break ties toward the lower index, as
``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from onebit_tpu_torch.engine.generate import _prefill, left_pad
from onebit_tpu_torch.model.bitllama import decode_step, init_kv_cache
from onebit_tpu_torch.model.config import BitLlamaConfig

NEG_INF = -1.0e7


def _top_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis, the
    lower index first among equals."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_beams(x, parent, b: int, k: int, dim: int = 0):
    """Beam-major rows of ``x`` (``B*K`` along ``dim``) gathered by
    ``parent [B, K]``."""
    flat = (torch.arange(b, device=x.device)[:, None] * k + parent).reshape(-1)
    return x.index_select(dim, flat)


def _take(x, idx):
    """``x [B, N, ...]`` at ``idx [B, K]`` along axis 1."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _beam_loop(params, cache, first_logits, start_index: int, prompt_len,
               config: BitLlamaConfig, *, num_beams: int, num_steps: int,
               eos_id: int, length_penalty: float, impl: str = "auto",
               compute_dtype=torch.bfloat16):
    """Beam search for ``num_steps`` tokens (beam.py:40-155). ``cache``
    holds each prompt expanded to its beams (``[L, B*K, ...]``), and is
    written and reordered in place; ``first_logits [B, V]`` are the
    prompts' next-token logits, ``prompt_len [B]`` their true lengths.
    Returns ``(sequences [B, K, num_steps], scores [B, K], lengths [B,
    K])``, the finished set sorted by penalized score."""
    b, v = first_logits.shape
    k = num_beams
    dev = first_logits.device
    prompt_len = torch.as_tensor(prompt_len, device=dev)
    key_start = (start_index - prompt_len).repeat_interleave(k).to(
        torch.int32)
    pos = prompt_len.repeat_interleave(k).long()

    # step 0: the prompt's distribution expanded into the first K beams
    logp0 = torch.log_softmax(first_logits.float(), dim=-1)
    scores0, toks0 = _top_k(logp0, k)                       # [B, K]
    alive_seq = torch.zeros(b, k, num_steps, dtype=torch.long, device=dev)
    alive_seq[:, :, 0] = toks0
    alive_score = torch.where(toks0 == eos_id, NEG_INF, scores0)
    eos0 = toks0 == eos_id
    fin_seq = torch.where(eos0[:, :, None], alive_seq, 0)
    fin_score = torch.where(eos0, scores0 / (1.0 ** length_penalty),
                            torch.full_like(scores0, NEG_INF))
    fin_len = torch.ones(b, k, dtype=torch.long, device=dev)
    steps = torch.arange(num_steps, device=dev)

    for t in range(1, num_steps):
        # step t-1's token: its K/V at cache slot start_index + t - 1, its
        # rope position prompt_len + t - 1
        last = alive_seq.reshape(b * k, num_steps)[:, t - 1:t]
        logits, cache = decode_step(params, cache, last, start_index + t - 1,
                                    config, impl=impl,
                                    compute_dtype=compute_dtype,
                                    positions=pos[:, None],
                                    key_start=key_start)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        cand = alive_score[:, :, None] + logp.reshape(b, k, v)
        # 2K candidates, so that EOS retirements cannot starve the alive set
        c_score, c_flat = _top_k(cand.reshape(b, k * v), 2 * k)
        c_parent, c_tok = c_flat // v, c_flat % v
        seq2k = torch.where(steps == t, c_tok[:, :, None],
                            _take(alive_seq, c_parent))     # [B, 2K, T]
        is_eos = c_tok == eos_id
        # the finished pool: the K held and the new EOS candidates
        new_fin = torch.where(is_eos, c_score / float(t + 1) ** length_penalty,
                              NEG_INF)
        pool_score = torch.cat([fin_score, new_fin], dim=1)
        pool_seq = torch.cat([fin_seq, seq2k], dim=1)
        pool_len = torch.cat([fin_len, torch.full_like(c_tok, t + 1)], dim=1)
        fin_score, fin_idx = _top_k(pool_score, k)
        fin_seq, fin_len = _take(pool_seq, fin_idx), _take(pool_len, fin_idx)
        # the alive pool: the best K candidates that are not EOS
        alive_score, a_idx = _top_k(torch.where(is_eos, NEG_INF, c_score), k)
        alive_seq = _take(seq2k, a_idx)
        parent = _take(c_parent, a_idx)                     # [B, K]
        # _reorder_cache: each beam's rows from its parent
        for arr in cache:
            arr.copy_(_gather_beams(arr, parent, b, k, dim=1))
        pos = pos + 1

    # unfinished alive beams join the pool at full length
    alive_final = alive_score / (float(num_steps) ** length_penalty)
    pool_score = torch.cat([fin_score, alive_final], dim=1)
    pool_seq = torch.cat([fin_seq, alive_seq], dim=1)
    pool_len = torch.cat([fin_len, torch.full_like(fin_len, num_steps)],
                         dim=1)
    score, idx = _top_k(pool_score, k)
    return _take(pool_seq, idx), score, _take(pool_len, idx)


def beam_generate(params, config: BitLlamaConfig,
                  prompts: Sequence[Sequence[int]], *, num_beams: int = 4,
                  max_new_tokens: int = 64, length_penalty: float = 1.0,
                  num_return_sequences: int = 1,
                  eos_id: Optional[int] = None, impl: str = "auto",
                  compute_dtype=torch.bfloat16,
                  max_len: Optional[int] = None
                  ) -> List[List[Tuple[List[int], float]]]:
    """Beam-search continuations on the params' device (beam.py:158-200):
    for each prompt the top ``num_return_sequences`` ``(tokens,
    penalized_score)`` pairs, best first. The cache holds ``max_len``
    positions, by default the next power of two of the longest prompt plus
    ``max_new_tokens``."""
    if num_return_sequences > num_beams:
        raise ValueError("num_return_sequences must be <= num_beams")
    eos_id = config.eos_token_id if eos_id is None else eos_id
    b, k = len(prompts), num_beams
    plens = [len(p) for p in prompts]
    maxp = max(plens)
    total = maxp + max_new_tokens
    if max_len is None:
        max_len = 1 << (total - 1).bit_length()
    elif total > max_len:
        raise ValueError(f"prompt+new ({total}) exceeds max_len {max_len}")
    device = params["embed_tokens"].device
    ids, attn = (torch.from_numpy(a).to(device) for a in left_pad(prompts))
    cache = init_kv_cache(config, b, max_len, dtype=compute_dtype,
                          device=device)
    logits = _prefill(params, cache, ids, attn, config, impl=impl,
                      compute_dtype=compute_dtype)
    # the prompt cache repeated to the beams: [L, B, ...] -> [L, B*K, ...]
    cache = type(cache)(*(arr.repeat_interleave(k, dim=1) for arr in cache))
    seq, score, length = _beam_loop(
        params, cache, logits, maxp, plens, config, num_beams=k,
        num_steps=max_new_tokens, eos_id=eos_id,
        length_penalty=length_penalty, impl=impl,
        compute_dtype=compute_dtype)
    seq, score, length = seq.tolist(), score.tolist(), length.tolist()
    return [[(seq[r][j][:length[r][j]], float(score[r][j]))
             for j in range(num_return_sequences)] for r in range(b)]
