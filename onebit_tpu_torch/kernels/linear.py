"""Plain (full-precision) linear projection weights.

Port of ``onebit_tpu/kernels/linear.py``: the projections of the FP teacher
model, which ``eval`` scores as a baseline and the KD trainer distills from.
The BitLlama decoder runs either kind; ``model/bitllama.py`` dispatches on
the weight type. No kernel of its own: the product accumulates in fp32, as
the JAX package leaves it to XLA, through ``core/bitlinear.py``
``project_f32`` (bf16 on the card: one tensor-core product with an fp32
result; fp32, or on the CPU: the fp32 product of the upcast operands).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from onebit_tpu_torch.core.bitlinear import project_f32


class LinearWeights(NamedTuple):
    weight: torch.Tensor                  # [out, in]
    bias: Optional[torch.Tensor] = None   # [out]


def linear_apply(x: torch.Tensor, w: LinearWeights) -> torch.Tensor:
    """``x [..., in]`` -> ``[..., out]`` in x.dtype: the product of x and
    the weight cast to x's dtype, accumulated in fp32
    (:func:`project_f32`), plus the bias."""
    y = project_f32(x, w.weight.to(x.dtype))
    if w.bias is not None:
        y = y + w.bias.float()
    return y.to(x.dtype)
