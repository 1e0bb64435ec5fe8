"""S²-Attn (shift short attention): the teacher-side long-context patch.

Port of ``onebit_tpu/kernels/shift_attention.py``, the reference's
``LlamaShiftShortAttention`` (llama_factory/llamafactory/llama_patch.py:
19-97): sequences split into groups of ``group_size``; half the heads are
rolled by ``group_size // 2`` positions so that information crosses the
groups' boundaries, attention runs causally within each group, and the
shifted half is rolled back. Plain torch, as JAX's is plain jnp: the
block-diagonal attention is a batched attention over the groups. Nothing
in either package calls it yet.
"""

from __future__ import annotations

import torch


def shift_short_attention(q, k, v, *, group_size: int,
                          num_kv_groups: int = 1) -> torch.Tensor:
    """q ``[B, S, nh, hd]``, k/v ``[B, S, nkv, hd]`` (after RoPE) ->
    ``[B, S, nh, hd]`` in v's dtype. Requires ``S % group_size == 0``. The
    scores and the softmax are fp32; the probabilities are cast to v's
    dtype before the product with v, as JAX casts them."""
    b, s, nh, hd = q.shape
    if s % group_size:
        raise ValueError(f"seq {s} not divisible by group {group_size}")
    if num_kv_groups > 1:
        k = k.repeat_interleave(num_kv_groups, dim=2)
        v = v.repeat_interleave(num_kv_groups, dim=2)
    half = nh // 2
    shift = group_size // 2

    def roll_heads(x, amount):
        lo, hi = x[:, :, :half], x[:, :, half:]
        return torch.cat([lo, torch.roll(hi, amount, dims=1)], dim=2)

    q, k, v = (roll_heads(x, -shift) for x in (q, k, v))
    g = s // group_size

    def to_groups(x):
        return x.reshape(b * g, group_size, nh, hd)

    qg, kg, vg = map(to_groups, (q, k, v))
    scores = torch.einsum("bsnh,btnh->bnst", qg.float(), kg.float())
    scores = scores * (hd ** -0.5)
    causal = torch.tril(torch.ones((group_size, group_size), dtype=torch.bool,
                                   device=q.device))
    scores = torch.where(causal[None, None], scores,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(vg.dtype)
    ctx = torch.einsum("bnst,btnh->bsnh", probs, vg)
    return roll_heads(ctx.reshape(b, s, nh, hd), shift)
