"""Readers of the reference's Hugging Face checkpoints, bit-exact.

Port of ``onebit_tpu/ckpt/hf_reader.py``. The reference makes three
checkpoint kinds, all ``save_pretrained`` directories (``config.json`` and
``pytorch_model*.bin`` or ``*.safetensors``):

1. the start checkpoint: BitLinear latent weights ``sign(W) * 0.01`` and the
   SVID value vectors (scripts/build_start_ckpt.py:25-37);
2. the train checkpoint: the same tensors after KD training;
3. the inference checkpoint: BitLinearInf int8 sign bytes ``[out, in//8]``
   (scripts/convert_llama_to_infer_ckpt.py:26-37) and the value vectors;

and the plain FP16 LLaMA teacher. Each loads into the port's params, layers
stacked on axis 0: latent and plain weights as float tensors
(``BitLinearWeights(latent=...)``, ``LinearWeights``), int8 sign bytes as
the port's K-major words (four bytes of a row are one canonical word, read
little-endian, then transposed: a pure bit permutation, exact).
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from onebit_tpu_torch.convert import to_tensor
from onebit_tpu_torch.core.packing import int8_bytes_to_words_np
from onebit_tpu_torch.kernels.bitlinear import BitLinearWeights
from onebit_tpu_torch.kernels.linear import LinearWeights
from onebit_tpu_torch.model.bitllama import PROJ_NAMES
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.utils.device import resolve_device

PROJ_PARENT = {
    "q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
    "o_proj": "self_attn",
    "gate_proj": "mlp", "up_proj": "mlp", "down_proj": "mlp",
}


def load_hf_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a checkpoint directory as numpy arrays:
    ``*.safetensors`` when there are any, else every ``pytorch_model*.bin``
    (sharded bins included), read with ``torch.load(weights_only=True)``;
    bfloat16 tensors become float32."""
    tensors: Dict[str, np.ndarray] = {}
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    bin_files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if st_files:
        from safetensors.numpy import load_file
        for f in st_files:
            tensors.update(load_file(f))
    elif bin_files:
        for f in bin_files:
            sd = torch.load(f, map_location="cpu", weights_only=True)
            for k, v in sd.items():
                tensors[k] = (v.float() if v.dtype == torch.bfloat16
                              else v).numpy()
    else:
        raise FileNotFoundError(f"no safetensors/bin files under {path}")
    return tensors


def detect_ckpt_kind(tensors: Dict[str, np.ndarray]) -> str:
    """``"packed"``, ``"latent"`` or ``"llama"`` from the tensors' names
    and dtypes."""
    qw = "model.layers.0.self_attn.q_proj.weight"
    if "model.layers.0.self_attn.q_proj.weight_scale" not in tensors:
        return "llama"
    return "packed" if tensors[qw].dtype == np.int8 else "latent"


def _stack(tensors: Dict[str, np.ndarray], fmt: str, n_layers: int,
           dtype=np.float32) -> np.ndarray:
    return np.stack([np.asarray(tensors[fmt.format(i)]).astype(dtype)
                     for i in range(n_layers)])


def load_reference_checkpoint(path: str,
                              config: Optional[BitLlamaConfig] = None,
                              dtype=torch.float32, device=None
                              ) -> Dict[str, Any]:
    """``{"config", "params", "kind"}`` of any reference checkpoint
    directory, the params on ``device`` (the card unless ``"cpu"``): float
    leaves in ``dtype``, the value vectors ``h`` and ``g`` in fp32, int8
    sign bytes as the port's packed words."""
    device = resolve_device(device)
    if config is None:
        config = BitLlamaConfig.from_json(path)
    tensors = load_hf_state_dict(path)
    kind = detect_ckpt_kind(tensors)
    L = config.num_hidden_layers

    def t(a, dt=dtype):
        return to_tensor(a, device, dt)

    layers: Dict[str, Any] = {
        norm: t(_stack(tensors, f"model.layers.{{}}.{norm}.weight", L))
        for norm in ("input_layernorm", "post_attention_layernorm")}
    for name in PROJ_NAMES:
        fmt = f"model.layers.{{}}.{PROJ_PARENT[name]}.{name}"
        if kind == "llama":
            layers[name] = LinearWeights(
                weight=t(_stack(tensors, fmt + ".weight", L)))
            continue
        h = t(_stack(tensors, fmt + ".weight_scale", L), torch.float32)
        g = t(_stack(tensors, fmt + ".input_factor", L), torch.float32)
        if kind == "packed":
            # int8 bytes [out, in//8] -> canonical words [out, in//32] ->
            # the port's K-major words [in//32, out]
            words = np.stack([int8_bytes_to_words_np(
                np.asarray(tensors[fmt.format(i) + ".weight"]))
                for i in range(L)])
            packed = torch.from_numpy(np.ascontiguousarray(
                words.transpose(0, 2, 1))).to(device)
            layers[name] = BitLinearWeights(weight_scale=h, input_factor=g,
                                            packed=packed)
        else:
            layers[name] = BitLinearWeights(
                weight_scale=h, input_factor=g,
                latent=t(_stack(tensors, fmt + ".weight", L)))
    params = {"embed_tokens": t(tensors["model.embed_tokens.weight"]),
              "lm_head": t(tensors["lm_head.weight"]),
              "final_norm": t(tensors["model.norm.weight"]),
              "layers": layers}
    return {"config": config, "params": params, "kind": kind}
