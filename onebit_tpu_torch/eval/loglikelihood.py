"""Batched loglikelihood scoring: the lm-eval-harness request API.

Port of ``onebit_tpu/eval/loglikelihood.py``. Requests are (context,
continuation) token pairs; each is scored by one forward over
``ctx + cont[:-1]``, summing the log-probs of the continuation tokens, with
an ``is_greedy`` flag (whether the continuation is the argmax decoding).
Requests are sorted by length (longest first) and right-padded with -1 into
power-of-two length buckets from 64, as the JAX package buckets them for
jit. Every batch carries a padding mask, so its attention is the masked
``_attention``, never B11.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from onebit_tpu_torch.model import bitllama
from onebit_tpu_torch.model.config import BitLlamaConfig


def _score_batch(params, tokens, cont_mask, config: BitLlamaConfig, *,
                 impl="auto", compute_dtype=torch.float32):
    """tokens ``[B, T]`` (ctx+cont, right-padded with -1), cont_mask
    ``[B, T]`` marks continuation positions (on the *label* axis). Returns
    (ll_sum ``[B]``, greedy_ok ``[B]``)."""
    attn = (tokens >= 0).to(torch.int32)
    safe = tokens.clamp(min=0)
    logits = bitllama.forward(params, safe, config, attention_mask=attn,
                              impl=impl, compute_dtype=compute_dtype)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    labels = safe[:, 1:]
    mask = cont_mask[:, 1:].float()
    tok_ll = logp.gather(-1, labels[..., None])[..., 0]
    ll = (tok_ll * mask).sum(dim=-1)
    greedy = logp.argmax(dim=-1) == labels
    greedy_ok = torch.where(mask > 0, greedy, True).all(dim=-1)
    return ll, greedy_ok


def _bucket_len(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def loglikelihood(params, config: BitLlamaConfig,
                  requests: Sequence[Tuple[Sequence[int], Sequence[int]]],
                  *, batch_size: int = 16, impl: str = "auto",
                  compute_dtype=torch.float32,
                  max_length: int = 2048) -> List[Tuple[float, bool]]:
    """Score (context_tokens, continuation_tokens) pairs.

    Returns ``[(ll_sum, is_greedy)]`` in the input order. Sequences longer
    than ``max_length`` keep their rightmost ``max_length`` tokens
    (reference truncation, base.py:294-306); an empty context stands in as
    ``[0]``."""
    items = []
    for idx, (ctx, cont) in enumerate(requests):
        ctx = list(ctx)
        cont = list(cont)
        if not cont:
            raise ValueError("empty continuation")
        if not ctx:
            ctx = [0]  # reference uses eot as empty-context stand-in
        toks = (ctx + cont)[-max_length:]
        n_cont = min(len(cont), len(toks))
        items.append((idx, toks, n_cont))

    # sort by padded length desc so buckets fill densely
    items.sort(key=lambda it: -len(it[1]))
    results: List[Tuple[float, bool]] = [None] * len(items)
    device = params["embed_tokens"].device

    for start in range(0, len(items), batch_size):
        chunk = items[start:start + batch_size]
        blen = _bucket_len(max(len(t) for _, t, _ in chunk))
        toks = np.full((batch_size, blen), -1, np.int64)
        cmask = np.zeros((batch_size, blen), np.int32)
        for r, (_, t, nc) in enumerate(chunk):
            toks[r, :len(t)] = t
            cmask[r, len(t) - nc:len(t)] = 1
        ll, greedy = _score_batch(params, torch.from_numpy(toks).to(device),
                                  torch.from_numpy(cmask).to(device), config,
                                  impl=impl, compute_dtype=compute_dtype)
        ll, greedy = ll.cpu().numpy(), greedy.cpu().numpy()
        for r, (idx, _, _) in enumerate(chunk):
            results[idx] = (float(ll[r]), bool(greedy[r]))
    return results
