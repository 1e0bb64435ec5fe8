"""Native checkpoints: ``config.json`` plus ``params.npz``, in the JAX
package's on-disk format.

Port of ``save_native`` / ``load_native`` of ``onebit_tpu/ckpt/writer.py``.
The ``.npz`` holds ``embed_tokens``, ``lm_head``, ``final_norm``,
``layers.<norm>`` and ``layers.<projection>.<field>`` arrays, layers stacked
on axis 0. Packed sign words are stored in the TPU byte-plane layout
(``core/packing.py``): :func:`load_native` converts them to the port's
K-major layout once, at load (through ``params_from_jax``), and
:func:`save_native` converts them back, so a JAX reader gets the bytes the
JAX writer would have written. numpy has no bfloat16: bfloat16 leaves are
written as the raw 2-byte records (``|V2``) numpy makes of the JAX writer's
bfloat16 arrays, and such records load as bfloat16.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch

from onebit_tpu_torch.convert import params_from_jax
from onebit_tpu_torch.core.packing import kmajor_to_device
from onebit_tpu_torch.kernels.bitlinear import (BitLinearWeights,
                                                FusedBitLinearWeights)
from onebit_tpu_torch.kernels.linear import LinearWeights
from onebit_tpu_torch.model.config import BitLlamaConfig

TRAIN_SLICE = 5   # latent (QAT) projections come with training


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    flat = {key: _to_numpy(params[key])
            for key in ("embed_tokens", "lm_head", "final_norm")}
    for name, val in params["layers"].items():
        if isinstance(val, FusedBitLinearWeights):
            raise ValueError(f"{name}: save the params before "
                             "fuse_for_decode")
        if isinstance(val, BitLinearWeights) and val.packed is not None:
            val = val._replace(packed=torch.stack(
                [kmajor_to_device(w) for w in val.packed]))
        if isinstance(val, (BitLinearWeights, LinearWeights)):
            for field, arr in val._asdict().items():
                if arr is not None:
                    flat[f"layers.{name}.{field}"] = _to_numpy(arr)
        else:
            flat[f"layers.{name}"] = _to_numpy(val)
    return flat


def save_native(path: str, config: BitLlamaConfig,
                params: Dict[str, Any]) -> None:
    """Write ``params`` (the port's, unfused) and ``config`` under
    ``path``."""
    os.makedirs(path, exist_ok=True)
    config.save_json(os.path.join(path, "config.json"))
    np.savez(os.path.join(path, "params.npz"), **_flatten(params))


def load_native(path: str, device=None) -> Dict[str, Any]:
    """``{"config", "params"}`` of a native checkpoint, the params on
    ``device`` (the card unless ``"cpu"``) in their stored dtypes. Latent
    (training) checkpoints wait for slice 5."""
    config = BitLlamaConfig.from_json(os.path.join(path, "config.json"))
    tree: Dict[str, Any] = {"layers": {}}
    fields: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(os.path.join(path, "params.npz")) as data:
        for key in data.files:
            if not key.startswith("layers."):
                tree[key] = data[key]
                continue
            rest = key[len("layers."):]
            if "." in rest:
                name, field = rest.split(".", 1)
                fields.setdefault(name, {})[field] = data[key]
            else:
                tree["layers"][rest] = data[key]
    for name, fd in fields.items():
        if "latent" in fd:
            raise NotImplementedError(
                f"{name}: latent projections (training checkpoints) come "
                f"with training, slice {TRAIN_SLICE} of the PyTorch port "
                "(ROADMAP.md)")
        tree["layers"][name] = SimpleNamespace(**fd)
    return {"config": config,
            "params": params_from_jax(tree, config, device=device)}
