"""Convert the JAX package's params into the port's, and back to numpy.

``params_from_jax`` takes the params tree of ``onebit_tpu`` after
``jax.tree.map(np.asarray, params)`` (numpy leaves) and returns the port's
params on ``device``. It is duck-typed: a projection is any object with
``weight_scale``, ``input_factor`` and ``bias`` attributes and either
``packed`` or ``latent`` (a training projection), so this module imports
nothing of the JAX package. A plain projection (the FP teacher's
``LinearWeights``) is any object with ``weight`` and ``bias``. Packed words
arrive in the TPU byte-plane layout and are converted to the port's K-major
layout once, here, one layer at a time on the target device.
``params_to_numpy`` is the reverse: the JAX tree's arrays, packed words in
the TPU layout again.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from onebit_tpu_torch.core.packing import device_to_kmajor, kmajor_to_device
from onebit_tpu_torch.kernels.bitlinear import (BitLinearWeights,
                                                FusedBitLinearWeights)
from onebit_tpu_torch.kernels.linear import LinearWeights
from onebit_tpu_torch.model.bitllama import PROJ_NAMES, _proj_dims
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.utils.device import resolve_device


def to_tensor(a, device, dtype=None) -> torch.Tensor:
    """numpy array (bfloat16 included) -> tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:             # arrays viewed from jax
        a = a.copy()
    # ml_dtypes' bfloat16, as jax gives it, or its bits as numpy saves them
    if a.dtype.name == "bfloat16" or a.dtype.str == "|V2":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _convert_words(packed: np.ndarray, device) -> torch.Tensor:
    words = torch.empty(packed.shape, dtype=torch.int32, device=device)
    for layer in range(packed.shape[0]):
        words[layer] = device_to_kmajor(to_tensor(packed[layer], device))
    return words


def _linear(w, name: str, config: BitLlamaConfig, device, dtype
            ) -> LinearWeights:
    out, inp = _proj_dims(config)[name]
    L = config.num_hidden_layers
    weight = to_tensor(w.weight, device, dtype)
    if tuple(weight.shape) != (L, out, inp):
        raise ValueError(f"{name}: weight {tuple(weight.shape)}, want "
                         f"{(L, out, inp)}")
    bias = getattr(w, "bias", None)
    return LinearWeights(weight=weight, bias=None if bias is None else
                         to_tensor(bias, device, torch.float32))


def _latent(w, name: str, shape, device) -> BitLinearWeights:
    latent = to_tensor(w.latent, device)
    if tuple(latent.shape) != shape:
        raise ValueError(f"{name}: latent {tuple(latent.shape)}, want "
                         f"{shape}")
    bias = getattr(w, "bias", None)
    return BitLinearWeights(
        weight_scale=to_tensor(w.weight_scale, device),
        input_factor=to_tensor(w.input_factor, device), latent=latent,
        bias=None if bias is None else to_tensor(bias, device))


def params_from_jax(tree: Dict[str, Any], config: BitLlamaConfig,
                    device=None, dtype=None) -> Dict[str, Any]:
    """The port's params from the JAX package's params.

    Float leaves keep their dtype unless ``dtype`` is given; weight scales
    and biases of packed projections are stored in fp32, as the kernels
    read them. Latent (training) projections keep every leaf's dtype (the
    JAX package's fp32), whatever ``dtype`` says. Unfused packed and latent
    projections and plain ``LinearWeights`` convert (apply the port's
    ``fuse_for_decode`` after).
    """
    device = resolve_device(device)
    src = tree["layers"]
    for name in ("qkv_proj", "gateup_proj"):
        if name in src:
            raise ValueError(f"{name}: convert the params before "
                             "fuse_for_decode, then fuse with the port's")
    layers: Dict[str, Any] = {
        n: to_tensor(src[n], device, dtype)
        for n in ("input_layernorm", "post_attention_layernorm")}
    L = config.num_hidden_layers
    for name in PROJ_NAMES:
        w = src[name]
        if hasattr(w, "weight"):
            layers[name] = _linear(w, name, config, device, dtype)
            continue
        out, inp = _proj_dims(config)[name]
        if getattr(w, "latent", None) is not None:
            layers[name] = _latent(w, name, (L, out, inp), device)
            continue
        packed = getattr(w, "packed", None)
        if packed is None:
            raise ValueError(f"{name}: only packed, latent or plain "
                             "projections convert")
        packed = np.asarray(packed)
        if packed.shape != (L, inp // 32, out) or packed.dtype != np.int32:
            raise ValueError(f"{name}: packed {packed.shape} {packed.dtype}, "
                             f"want {(L, inp // 32, out)} int32")
        bias = getattr(w, "bias", None)
        layers[name] = BitLinearWeights(
            weight_scale=to_tensor(w.weight_scale, device, torch.float32),
            input_factor=to_tensor(w.input_factor, device, dtype),
            packed=_convert_words(packed, device),
            bias=None if bias is None else to_tensor(bias, device,
                                                     torch.float32))
    return {
        "embed_tokens": to_tensor(tree["embed_tokens"], device, dtype),
        "lm_head": to_tensor(tree["lm_head"], device, dtype),
        "final_norm": to_tensor(tree["final_norm"], device, dtype),
        "layers": layers,
    }


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's array; bfloat16 as the raw 2-byte records (``|V2``) that
    numpy makes of the JAX package's bfloat16 arrays."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's (unfused) params as the JAX package's tree of numpy
    arrays: ``{"embed_tokens", "lm_head", "final_norm", "layers": {norm:
    array, projection: {field: array}}}``, each projection's fields in the
    JAX class's order, None fields left out, packed words in the TPU
    byte-plane layout."""
    tree: Dict[str, Any] = {key: _to_numpy(params[key])
                            for key in ("embed_tokens", "lm_head",
                                        "final_norm")}
    layers: Dict[str, Any] = {}
    for name, val in params["layers"].items():
        if isinstance(val, FusedBitLinearWeights):
            raise ValueError(f"{name}: convert the params before "
                             "fuse_for_decode")
        if isinstance(val, BitLinearWeights) and val.packed is not None:
            val = val._replace(packed=torch.stack(
                [kmajor_to_device(w) for w in val.packed]))
        if isinstance(val, (BitLinearWeights, LinearWeights)):
            layers[name] = {field: _to_numpy(arr)
                            for field, arr in val._asdict().items()
                            if arr is not None}
        else:
            layers[name] = _to_numpy(val)
    tree["layers"] = layers
    return tree
