"""Rotary position embeddings with linear / dynamic-NTK scaling.

Port of ``onebit_tpu/model/rope.py``: ``inv_freq_i = theta^(-2i/d)``, the
table from ``cat(freqs, freqs)``, ``rotate_half`` mixing the two halves.
Linear scaling divides positions by ``factor``; dynamic NTK rescales theta
when ``seq_len > max_position_embeddings``. cos and sin are computed in
fp32 and cast to the requested dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0, rope_scaling: Optional[dict] = None,
                 max_position_embeddings: int = 2048,
                 seq_len: Optional[int] = None, dtype=torch.float32):
    """cos/sin for integer ``positions [...]`` -> two ``[..., head_dim]``."""
    positions = positions.to(torch.float32)
    if rope_scaling is not None:
        kind, factor = rope_scaling["type"], float(rope_scaling["factor"])
        if kind == "linear":
            positions = positions / factor
        elif kind == "dynamic":
            sl = seq_len if seq_len is not None else max_position_embeddings
            if sl > max_position_embeddings:
                theta = theta * (
                    (factor * sl / max_position_embeddings) - (factor - 1)
                ) ** (head_dim / (head_dim - 2))
        else:
            raise ValueError(f"unknown rope_scaling type {kind!r}")
    inv_freq = rope_inv_freq(head_dim, theta, device=positions.device)
    freqs = positions[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    """q/k ``[..., seq, heads, head_dim]``; cos/sin ``[..., seq, head_dim]``
    broadcast over heads."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    q_out = q * cos + rotate_half(q) * sin
    k_out = k * cos + rotate_half(k) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
