"""The draft model of speculative decoding: sliced from a 1-bit student,
then distilled against it.

Port of ``onebit_tpu/train/draft.py``. The serving engine's speculative
path (``engine/speculative.py``, ``ContinuousBatchingEngine(draft_params=,
draft_config=)``) takes any draft that shares the target's vocabulary;
this module makes one:

1. :func:`slice_draft_params` keeps ``num_layers`` of the student's
   decoder layers (stacked on axis 0, fused for decode or not) and shares
   ``embed_tokens``, ``lm_head`` and ``final_norm`` with it, so the draft
   costs ``num_layers / L`` of the target's sign weights;
2. :func:`distill_draft` trains the slice against the full student with
   the KD loop (``train/run_kd.py``), the student in the teacher's role,
   on the logits only (hidden states of unequal depths do not pair).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from onebit_tpu_torch.core.packing import unpack_signs_kmajor
from onebit_tpu_torch.kernels.bitlinear import BitLinearWeights
from onebit_tpu_torch.model.config import BitLlamaConfig


def draft_config(config: BitLlamaConfig, num_layers: int) -> BitLlamaConfig:
    """The draft's config: the student's geometry at ``num_layers`` depth."""
    if not 1 <= num_layers <= config.num_hidden_layers:
        raise ValueError(f"num_layers {num_layers} outside "
                         f"[1, {config.num_hidden_layers}]")
    return dataclasses.replace(config, num_hidden_layers=num_layers)


def draft_layer_ids(n_total: int, num_layers: int,
                    strategy: str = "spread") -> Tuple[int, ...]:
    """The student layers that seed the draft: ``"first"`` the prefix,
    ``"spread"`` evenly spaced ids that keep layer 0 and layer
    ``n_total - 1`` (the one that feeds the shared ``lm_head``)."""
    if num_layers == n_total:
        return tuple(range(n_total))
    if strategy == "first":
        return tuple(range(num_layers))
    if strategy == "spread":
        if num_layers == 1:
            return (n_total - 1,)
        ids = np.round(np.linspace(0, n_total - 1, num_layers)).astype(int)
        # linspace can collide at tiny n_total: force strictly increasing
        for i in range(1, len(ids)):
            ids[i] = max(ids[i], ids[i - 1] + 1)
        return tuple(int(i) for i in ids)
    raise ValueError(f"unknown strategy {strategy!r}")


def _take_layers(leaf, ids: torch.Tensor):
    if isinstance(leaf, tuple):            # a weights NamedTuple
        return type(leaf)(*(None if a is None else _take_layers(a, ids)
                            for a in leaf))
    return leaf.index_select(0, ids.to(leaf.device))


def slice_draft_params(params: Dict[str, Any],
                       layer_ids: Sequence[int]) -> Dict[str, Any]:
    """Stacked per-layer params (axis 0) at ``layer_ids``, fused or not;
    ``embed_tokens``, ``lm_head`` and ``final_norm`` shared with the
    student (the same tensors)."""
    ids = torch.as_tensor(tuple(layer_ids), dtype=torch.long)
    out = dict(params)
    out["layers"] = {name: _take_layers(leaf, ids)
                     for name, leaf in params["layers"].items()}
    return out


def latentize_params(params: Dict[str, Any],
                     init_scale: float = 0.01) -> Dict[str, Any]:
    """A packed tree made trainable: ``latent = sign * init_scale`` (the
    reference's start-checkpoint convention) with ``g``, ``h`` and the bias
    kept; other projections pass through."""
    def fix(w):
        if isinstance(w, BitLinearWeights) and w.packed is not None:
            latent = unpack_signs_kmajor(w.packed, torch.float32) * init_scale
            return BitLinearWeights(weight_scale=w.weight_scale,
                                    input_factor=w.input_factor,
                                    latent=latent, bias=w.bias)
        return w

    out = dict(params)
    out["layers"] = {k: fix(v) for k, v in params["layers"].items()}
    return out


def build_draft(params: Dict[str, Any], config: BitLlamaConfig,
                num_layers: int, *, strategy: str = "spread",
                for_training: bool = False
                ) -> Tuple[BitLlamaConfig, Dict[str, Any]]:
    """One-call slice: the student (latent or packed) -> ``(draft_config,
    params)``; ``for_training`` latentizes packed slices, a start point for
    :func:`distill_draft`."""
    ids = draft_layer_ids(config.num_hidden_layers, num_layers, strategy)
    d_params = slice_draft_params(params, ids)
    if for_training:
        d_params = latentize_params(d_params)
    return draft_config(config, num_layers), d_params


def distill_draft(student_params: Dict[str, Any], config: BitLlamaConfig,
                  blocks: np.ndarray, *, num_layers: int = 2,
                  strategy: str = "spread", kd_cfg=None, train_cfg=None,
                  run_cfg=None, eval_blocks: Optional[np.ndarray] = None):
    """Distill a ``num_layers`` draft from a trained 1-bit student, which
    is both the slice's source and the KD teacher. Returns
    ``(draft_config, TrainState)``; pack the state's params with
    ``pack_model_params`` to serve them."""
    from onebit_tpu_torch.train.losses import KDConfig
    from onebit_tpu_torch.train.run_kd import KDRunConfig, run_kd
    from onebit_tpu_torch.train.trainer import TrainConfig

    if kd_cfg is None:
        kd_cfg = KDConfig(kd_alpha=1.0, kd_beta=0.0, kd_gamma=0.0)
    if kd_cfg.kd_beta > 0 or kd_cfg.kd_gamma > 0:
        raise ValueError("draft distillation is logits-only: kd_beta / "
                         "kd_gamma pair per-layer states across unequal "
                         "depths")
    d_config, d_params = build_draft(student_params, config, num_layers,
                                     strategy=strategy, for_training=True)
    state = run_kd(d_config, d_params, student_params, blocks,
                   kd_cfg=kd_cfg, train_cfg=train_cfg or TrainConfig(),
                   run_cfg=run_cfg or KDRunConfig(),
                   eval_blocks=eval_blocks)
    return d_config, state
