"""Build the KD start checkpoint from a full-precision teacher (SVID init).

Port of ``onebit_tpu/core/build_start.py``. The reference
(scripts/build_start_ckpt.py) fits a rank-1 NMF of ``|W|`` on the CPU for
each of the 7 projections of every layer in turn; here the rank-1
factorization is one batched power iteration per projection family over the
stacked layer axis, on the params' device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from onebit_tpu_torch.core.svid import (LATENT_SIGN_SCALE, rank1_nmf,
                                        rank1_power)
from onebit_tpu_torch.kernels.bitlinear import BitLinearWeights
from onebit_tpu_torch.kernels.linear import LinearWeights
from onebit_tpu_torch.model.bitllama import PROJ_NAMES


@torch.no_grad()
def build_start_params(teacher_params: Dict[str, Any], *,
                       method: str = "power", num_iters: int = 50,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, Any]:
    """Plain-LLaMA params -> BitLlama latent start params.

    Per projection (reference build_start_ckpt.py:25-34): input_factor <- g,
    weight_scale <- h with ``|W| ≈ h·gᵀ``, latent weight <- sign(W)·0.01,
    all fp32. Embeddings, lm_head and norms pass through unchanged (the same
    tensors). ``method="nmf"`` draws each layer's start from ``generator``.
    """
    out = dict(teacher_params)
    layers = dict(teacher_params["layers"])
    for name in PROJ_NAMES:
        lw = layers[name]
        w = lw.weight if isinstance(lw, LinearWeights) else lw.latent
        a_abs = w.float().abs()
        if method == "power":
            h, g = rank1_power(a_abs, num_iters=num_iters)
        else:
            hg = [rank1_nmf(a, num_iters=num_iters, generator=generator)
                  for a in a_abs]
            h = torch.stack([x for x, _ in hg])
            g = torch.stack([x for _, x in hg])
        del a_abs
        latent = torch.sign(w).float() * LATENT_SIGN_SCALE
        layers[name] = BitLinearWeights(weight_scale=h, input_factor=g,
                                        latent=latent)
    out["layers"] = layers
    return out
