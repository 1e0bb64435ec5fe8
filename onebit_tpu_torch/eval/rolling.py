"""Rolling-window loglikelihood and greedy generation until a stop string,
the rest of the BaseLM request API.

Port of ``onebit_tpu/eval/rolling.py``: ``loglikelihood_rolling`` scores a
whole document with every token predicted exactly once, in non-overlapping
max-context windows, except the last window, which is given a full-sized
context and scored only on its unseen tail (reference base.py:49-79).
``rolling_windows`` is the JAX package's own (framework-free) function,
copied. ``greedy_until`` runs batches of prompts through ``generate``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from onebit_tpu_torch.engine.generate import generate
from onebit_tpu_torch.engine.sampler import SamplingConfig
from onebit_tpu_torch.eval.loglikelihood import loglikelihood
from onebit_tpu_torch.model.config import BitLlamaConfig


def rolling_windows(tokens: Sequence[int], max_len: int,
                    prefix_token: int = 0) -> List[Tuple[List[int], List[int]]]:
    """(context, continuation) pairs per reference base.py:58-75.

    Each window is (ctx, cont) where scoring cont under ctx predicts each
    document token exactly once; the final window gets a full context.
    """
    toks = list(tokens)
    n = len(toks)
    pairs = []
    pos = 0
    while pos < n:
        cont = toks[pos:pos + max_len]
        if pos == 0:
            ctx = [prefix_token]
        else:
            # context fills the model input up to max_len total positions:
            # full windows keep 1 token of context, the final short window
            # re-reads earlier tokens so its input is still full-sized
            ctx_len = max_len - len(cont) + 1
            ctx = toks[max(0, pos - ctx_len):pos]
        pos += len(cont)
        pairs.append((ctx, cont))
    return pairs


def loglikelihood_rolling(params, config: BitLlamaConfig,
                          documents: Sequence[Sequence[int]], *,
                          max_length: Optional[int] = None,
                          batch_size: int = 8,
                          prefix_token: int = 0,
                          compute_dtype=None) -> List[float]:
    """Per-document total loglikelihood (each token scored exactly once)."""
    compute_dtype = compute_dtype or torch.float32
    max_length = max_length or config.max_position_embeddings

    all_pairs = []
    spans = []
    for doc in documents:
        # full windows score max_length tokens each (reference
        # get_rolling_token_windows with max_seq_len = max_length); the
        # scorer gets max_length+1 total tokens (ctx 1 + cont max_length),
        # whose model input is the first max_length of them
        pairs = rolling_windows(doc, max_length, prefix_token)
        spans.append((len(all_pairs), len(all_pairs) + len(pairs)))
        all_pairs.extend(pairs)
    results = loglikelihood(params, config, all_pairs,
                            batch_size=batch_size,
                            compute_dtype=compute_dtype,
                            max_length=max_length + 1)
    return [sum(results[i][0] for i in range(s, e)) for s, e in spans]


def greedy_until(params, config: BitLlamaConfig,
                 requests: Sequence[Tuple[Sequence[int], Sequence[str]]],
                 detokenize: Callable, *, max_new_tokens: int = 256,
                 batch_size: int = 8) -> List[str]:
    """Generate greedily until any stop string appears (the reference's
    ``greedy_until`` request type). ``requests``: (prompt tokens, stops);
    each text is cut before the first occurrence of each stop in turn."""
    outs: List[str] = []
    for start in range(0, len(requests), batch_size):
        chunk = requests[start:start + batch_size]
        gen = generate(params, config, [list(p) for p, _ in chunk],
                       max_new_tokens=max_new_tokens,
                       sampling=SamplingConfig(greedy=True))
        for (_, stops), toks in zip(chunk, gen):
            text = detokenize(toks)
            for stop in stops:
                idx = text.find(stop)
                if idx >= 0:
                    text = text[:idx]
            outs.append(text)
    return outs
