"""Random packed-inference params made on the host with numpy.

Port of ``onebit_tpu/utils/randinit.py``: the same ``default_rng(seed)``
stream in the same call order, so both packages hold identical sign words
and embeddings for a seed at any size, with no checkpoint. The words are
drawn in the TPU layout, as the JAX function draws them, and pass through
the converter into the port's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from onebit_tpu_torch.convert import params_from_jax
from onebit_tpu_torch.kernels.bitlinear import BitLinearWeights
from onebit_tpu_torch.model.bitllama import _proj_dims
from onebit_tpu_torch.model.config import BitLlamaConfig


def host_random_packed_params(config: BitLlamaConfig, seed: int = 0,
                              dtype=torch.bfloat16, device=None):
    rng = np.random.default_rng(seed)
    L, d, v = (config.num_hidden_layers, config.hidden_size,
               config.vocab_size)

    def f(*shape):
        return (rng.standard_normal(shape) * config.initializer_range
                ).astype(np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    tree = {
        "embed_tokens": f(v, d), "lm_head": f(v, d),
        "final_norm": ones(d),
        "layers": {
            "input_layernorm": ones(L, d),
            "post_attention_layernorm": ones(L, d),
        },
    }
    for name, (out, inp) in _proj_dims(config).items():
        words = rng.integers(-2 ** 31, 2 ** 31 - 1, (L, inp // 32, out),
                             dtype=np.int64).astype(np.int32)
        tree["layers"][name] = BitLinearWeights(
            weight_scale=ones(L, out), input_factor=ones(L, inp),
            packed=words)
    return params_from_jax(tree, config, device=device, dtype=dtype)
