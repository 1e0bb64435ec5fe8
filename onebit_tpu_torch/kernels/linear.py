"""Plain (full-precision) linear projection weights.

Port of ``onebit_tpu/kernels/linear.py``: the projections of the FP teacher
model, which ``eval`` scores as a baseline and the KD trainer distills from.
The BitLlama decoder runs either kind; ``model/bitllama.py`` dispatches on
the weight type. No kernel: a plain matmul with fp32 accumulation, as the
JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LinearWeights(NamedTuple):
    weight: torch.Tensor                  # [out, in]
    bias: Optional[torch.Tensor] = None   # [out]


def linear_apply(x: torch.Tensor, w: LinearWeights) -> torch.Tensor:
    """``x [..., in]`` -> ``[..., out]`` in x.dtype: the product of x and
    the weight cast to x's dtype, accumulated in fp32, plus the bias."""
    y = torch.matmul(x.float(), w.weight.to(x.dtype).float().T)
    if w.bias is not None:
        y = y + w.bias.float()
    return y.to(x.dtype)
