"""BitLlama model configuration — HF-`config.json`-compatible.

Field names and defaults mirror the reference ``BitLlamaConfig``
(transformers/src/transformers/models/bitllama/configuration_bitllama.py:
115-163, ``model_type="bitllama"`` at :112, rope_scaling validation at
:168-187) so reference checkpoints' ``config.json`` load unmodified.

The PyTorch port's own copy of ``onebit_tpu/model/config.py``: the port
never imports the JAX package, whose ``__init__`` loads jax.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

_KNOWN_MODELS = {
    # name: (hidden, intermediate, layers, heads, kv_heads)
    "llama-7b": (4096, 11008, 32, 32, 32),
    "llama-13b": (5120, 13824, 40, 40, 40),
    "llama2-7b": (4096, 11008, 32, 32, 32),
    "llama2-13b": (5120, 13824, 40, 40, 40),
    "tiny": (256, 768, 2, 4, 2),  # for tests (dims multiples of 128 for tiling)
}


@dataclasses.dataclass
class BitLlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    hidden_act: str = "silu"
    max_position_embeddings: int = 2048
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-6
    use_cache: bool = True
    pad_token_id: Optional[int] = None
    bos_token_id: int = 1
    eos_token_id: int = 2
    pretraining_tp: int = 1
    tie_word_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    attention_bias: bool = False
    model_type: str = "bitllama"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        self._validate_rope_scaling()
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError("hidden_size must be divisible by num_attention_heads")
        if self.num_attention_heads % self.num_key_value_heads != 0:
            raise ValueError("num_attention_heads must be a multiple of num_key_value_heads")

    def _validate_rope_scaling(self):
        # reference configuration_bitllama.py:168-187
        rs = self.rope_scaling
        if rs is None:
            return
        if not isinstance(rs, dict) or len(rs) != 2:
            raise ValueError(f"`rope_scaling` must be a dict with fields `type` and `factor`, got {rs}")
        t, f = rs.get("type"), rs.get("factor")
        if t not in ("linear", "dynamic"):
            raise ValueError(f"`rope_scaling` type must be 'linear' or 'dynamic', got {t}")
        if f is None or not isinstance(f, float) or f <= 1.0:
            raise ValueError(f"`rope_scaling` factor must be a float > 1, got {f}")

    def __hash__(self):
        # hashable so the config can key caches; rope_scaling (a dict) is
        # canonicalized to a sorted item tuple.
        items = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, dict):
                v = tuple(sorted(v.items()))
            items.append(v)
        return hash(tuple(items))

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    # ---- HF config.json interop -------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BitLlamaConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, path: str) -> "BitLlamaConfig":
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["architectures"] = ["BitLlamaForCausalLM"]
        return d

    def save_json(self, path: str) -> None:
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def named(cls, name: str, **overrides) -> "BitLlamaConfig":
        if name not in _KNOWN_MODELS:
            raise KeyError(f"unknown model {name!r}; known: "
                           f"{sorted(_KNOWN_MODELS)}")
        h, inter, nl, nh, nkv = _KNOWN_MODELS[name]
        base = dict(hidden_size=h, intermediate_size=inter, num_hidden_layers=nl,
                    num_attention_heads=nh, num_key_value_heads=nkv)
        if name == "tiny":
            base.update(vocab_size=512, max_position_embeddings=128)
        base.update(overrides)
        return cls(**base)
