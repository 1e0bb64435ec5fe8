"""The benchmark's seeded inputs: weights made on the device from
``--seed`` with ``torch.Generator``s on the card, in a few large calls, in
the types they are served or trained in.

``served`` makes a packed 1-bit model in the port's layout (sign words
``[L, in/32, out]`` int32, g bf16, h fp32, bf16 embeddings, head and
norms); ``teacher`` a plain full-precision model for KD. Both are plain
dicts that the reference reads as they are; ``to_port_*`` wraps them in the
program's weight types. The same seed gives the same tensors, so the
reference, run after the program's state is freed, makes them again.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import PROJ_NAMES
from portbench.roofline import proj_shapes

NORM_STD = 0.1      # RMSNorm weights ~ 1 + 0.1 N(0, 1)
G_STD = 0.25        # input factors ~ 1 + 0.25 N(0, 1)


def _generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % 2 ** 63)
    return gen


def _normal(gen, shape, std, device, mean=0.0):
    return torch.randn(shape, generator=gen, device=device) * std + mean


def served(cfg: Dict, seed: int, device) -> Dict:
    """A random packed model of ``cfg`` from ``seed``."""
    L, d, v = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["vocab_size"])
    std = cfg["initializer_range"]
    gen = _generator(seed, 0, device)
    bf = torch.bfloat16
    raw = {"embed_tokens": _normal(gen, (v, d), std, device).to(bf),
           "lm_head": _normal(gen, (v, d), std, device).to(bf),
           "final_norm": _normal(gen, (d,), NORM_STD, device, 1.0).to(bf),
           "layers": {n: _normal(gen, (L, d), NORM_STD, device, 1.0).to(bf)
                      for n in ("input_layernorm",
                                "post_attention_layernorm")}}
    for name, (out, inp) in proj_shapes(cfg).items():
        words = torch.randint(-2 ** 31, 2 ** 31, (L, inp // 32, out),
                              generator=gen, device=device,
                              dtype=torch.int64).to(torch.int32)
        raw["layers"][name] = {
            "packed": words,
            "g": _normal(gen, (L, inp), G_STD, device, 1.0).to(bf),
            "h": torch.rand((L, out), generator=gen, device=device) + 0.5}
    return raw


def teacher(cfg: Dict, seed: int, device) -> Dict:
    """A random full-precision (fp32) model of ``cfg`` from ``seed``."""
    L, d, v = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["vocab_size"])
    std = cfg["initializer_range"]
    gen = _generator(seed, 1, device)
    raw = {"embed_tokens": _normal(gen, (v, d), std, device),
           "lm_head": _normal(gen, (v, d), std, device),
           "final_norm": _normal(gen, (d,), NORM_STD, device, 1.0),
           "layers": {n: _normal(gen, (L, d), NORM_STD, device, 1.0)
                      for n in ("input_layernorm",
                                "post_attention_layernorm")}}
    for name, (out, inp) in proj_shapes(cfg).items():
        raw["layers"][name] = _normal(gen, (L, out, inp), std, device)
    return raw


def token_block(seed: int, step: int, batch: int, seq: int, vocab: int,
                device) -> torch.Tensor:
    """Step ``step``'s token rows ``[batch, seq]``, ids in ``[3, vocab)``,
    drawn on the device: every step's rows are new."""
    gen = _generator(seed, 1000 + step, device)
    return torch.randint(3, vocab, (batch, seq), generator=gen,
                         device=device)


def to_port_served(raw: Dict) -> Dict:
    """The packed model as the program's params (before its fusion)."""
    from onebit_tpu_torch.kernels.bitlinear import BitLinearWeights
    layers = {n: raw["layers"][n]
              for n in ("input_layernorm", "post_attention_layernorm")}
    for name in PROJ_NAMES:
        p = raw["layers"][name]
        layers[name] = BitLinearWeights(weight_scale=p["h"],
                                        input_factor=p["g"],
                                        packed=p["packed"])
    return {"embed_tokens": raw["embed_tokens"], "lm_head": raw["lm_head"],
            "final_norm": raw["final_norm"], "layers": layers}


def to_port_teacher(raw: Dict) -> Dict:
    """The plain model as the program's teacher params."""
    from onebit_tpu_torch.kernels.linear import LinearWeights
    layers = {n: raw["layers"][n]
              for n in ("input_layernorm", "post_attention_layernorm")}
    for name in PROJ_NAMES:
        layers[name] = LinearWeights(weight=raw["layers"][name])
    return {"embed_tokens": raw["embed_tokens"], "lm_head": raw["lm_head"],
            "final_norm": raw["final_norm"], "layers": layers}
