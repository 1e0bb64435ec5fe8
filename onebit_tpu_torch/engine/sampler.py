"""Token samplers: greedy, temperature, top-k, top-p.

Port of ``onebit_tpu/engine/sampler.py``. Randomness comes from an explicit
``torch.Generator``; it gives other numbers than ``jax.random`` for the same
seed, so non-greedy sampling agrees with the JAX package in distribution,
not token by token.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 1.0
    top_k: int = 0           # 0 = disabled
    top_p: float = 1.0       # 1.0 = disabled
    greedy: bool = False


def warp_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Temperature / top-k / top-p warping -> fp32 logits of the sampled
    distribution ([..., V], excluded tokens ``-inf``)."""
    logits = logits.float() / max(cfg.temperature, 1e-6)
    if cfg.top_k and cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative probability exceeds top_p
        # (the top-1 token is always kept)
        keep = cum - probs < cfg.top_p
        kth_idx = keep.sum(-1, keepdim=True) - 1
        threshold = torch.gather(sorted_logits, -1, kth_idx)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    return logits


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 cfg: SamplingConfig) -> torch.Tensor:
    """logits ``[B, V]`` -> token ids ``[B]`` (int64).

    A draw is ``argmax(p / e)`` with ``e`` exponential: what
    ``torch.multinomial(p, 1)`` computes, the same tokens from the same
    generator state, without its host read of the probabilities' range,
    which a CUDA graph cannot capture."""
    if cfg.greedy or cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(warp_logits(logits, cfg), dim=-1)
    e = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / e, dim=-1)
