"""Native checkpoints: ``config.json`` plus ``params.npz``, in the JAX
package's on-disk format; and the export to the reference's int8 format.

Port of ``save_native`` / ``load_native`` / ``export_reference_int8`` of
``onebit_tpu/ckpt/writer.py``.
The ``.npz`` holds ``embed_tokens``, ``lm_head``, ``final_norm``,
``layers.<norm>`` and ``layers.<projection>.<field>`` arrays, layers stacked
on axis 0; a projection is packed (inference), latent (training) or plain
(the teacher). Packed sign words are stored in the TPU byte-plane layout
(``core/packing.py``): :func:`load_native` converts them to the port's
K-major layout once, at load (through ``params_from_jax``), and
:func:`save_native` converts them back, so a JAX reader gets the bytes the
JAX writer would have written. numpy has no bfloat16: bfloat16 leaves are
written as the raw 2-byte records (``|V2``) numpy makes of the JAX writer's
bfloat16 arrays, and such records load as bfloat16.

:func:`export_reference_int8` writes a Hugging Face directory
(``model.safetensors`` and ``config.json``) in the reference's BitLinearInf
byte format (scripts/convert_llama_to_infer_ckpt.py:7-15), which
``ckpt/hf_reader.py`` and the reference read back bit-exactly.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np

from onebit_tpu_torch.ckpt.hf_reader import PROJ_PARENT
from onebit_tpu_torch.convert import params_from_jax, params_to_numpy
from onebit_tpu_torch.core.packing import pack_signs_int8_np
from onebit_tpu_torch.model.bitllama import PROJ_NAMES
from onebit_tpu_torch.model.config import BitLlamaConfig


def _flatten(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The ``.npz`` arrays, keyed and ordered as the JAX writer keys and
    orders them."""
    tree = params_to_numpy(params)
    flat = {key: tree[key] for key in ("embed_tokens", "lm_head",
                                       "final_norm")}
    for name, val in tree["layers"].items():
        if isinstance(val, dict):
            for field, arr in val.items():
                flat[f"layers.{name}.{field}"] = arr
        else:
            flat[f"layers.{name}"] = val
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
    ``device`` (the card unless ``"cpu"``) in their stored dtypes: packed
    (inference), latent (training) or plain (teacher) projections."""
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
        tree["layers"][name] = SimpleNamespace(**fd)
    return {"config": config,
            "params": params_from_jax(tree, config, device=device)}


def export_reference_int8(path: str, config: BitLlamaConfig,
                          params: Dict[str, Any],
                          value_dtype=np.float32) -> None:
    """Write ``params`` (the port's, unfused; packed, latent or dense-sign
    projections) as a reference BitLinearInf checkpoint under ``path``:
    each projection's signs as int8 bytes ``[out, in//8]`` (a K-major word
    column is four little-endian bytes of the row; latent weights are
    signed first), every float leaf in ``value_dtype``."""
    from safetensors.numpy import save_file

    def value(t) -> np.ndarray:
        return t.detach().float().cpu().numpy().astype(value_dtype)

    os.makedirs(path, exist_ok=True)
    config.save_json(os.path.join(path, "config.json"))
    layers = params["layers"]
    out: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": value(params["embed_tokens"]),
        "lm_head.weight": value(params["lm_head"]),
        "model.norm.weight": value(params["final_norm"]),
    }
    for i in range(config.num_hidden_layers):
        pre = f"model.layers.{i}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[f"{pre}.{norm}.weight"] = value(layers[norm][i])
        for name in PROJ_NAMES:
            w = layers[name]
            key = f"{pre}.{PROJ_PARENT[name]}.{name}"
            if w.packed is not None:
                words = w.packed[i].T.contiguous().cpu().numpy()
                signs = words.astype("<i4").view(np.int8)
            else:
                dense = w.latent if w.latent is not None else w.dense_sign
                signs = pack_signs_int8_np(
                    np.sign(dense[i].detach().float().cpu().numpy()))
            out[f"{key}.weight"] = signs
            out[f"{key}.weight_scale"] = value(w.weight_scale[i])
            out[f"{key}.input_factor"] = value(w.input_factor[i])
    save_file(out, os.path.join(path, "model.safetensors"))
