"""BitLlama pieces the serving path needs: KV cache, fused decode params,
RMSNorm, attention and the per-layer projection helpers.

Port of the subset of ``onebit_tpu/model/bitllama.py`` that the dense
ragged decode step and batched prefill run. Params are plain dicts of
tensors with layers stacked on a leading axis, as in the JAX package:
``{"embed_tokens", "lm_head", "final_norm", "layers": {...}}`` where each
projection is a ``BitLinearWeights`` (or a ``FusedBitLinearWeights`` after
:func:`fuse_for_decode`) whose leaves carry a leading ``[L]`` axis.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from onebit_tpu_torch.kernels.bitlinear import (
    BitLinearWeights,
    FusedBitLinearWeights,
    bitlinear_apply_stacked,
    fused_bitlinear_apply_stacked,
)
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.utils.device import resolve_device

PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
              "gate_proj", "up_proj", "down_proj")
# fused segments are padded to a multiple of this many columns: a multiple
# of the kernels' column tiles (32 and 64); llama widths need no padding
SEG_ALIGN = 128


class KVCache(NamedTuple):
    """Preallocated KV cache, layers stacked on the leading axis."""
    k: torch.Tensor  # [L, B, max_len, n_kv, head_dim]
    v: torch.Tensor  # [L, B, max_len, n_kv, head_dim]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_kv_cache(config: BitLlamaConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    device = resolve_device(device)
    shape = (config.num_hidden_layers, batch, max_len,
             config.num_key_value_heads, config.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _proj_dims(config: BitLlamaConfig) -> Dict[str, Tuple[int, int]]:
    """name -> (out, in) of each projection."""
    d = config.hidden_size
    kv = config.num_key_value_heads * config.head_dim
    i = config.intermediate_size
    return {
        "q_proj": (d, d), "k_proj": (kv, d), "v_proj": (kv, d),
        "o_proj": (d, d),
        "gate_proj": (i, d), "up_proj": (i, d), "down_proj": (d, i),
    }


def fuse_for_decode(params: Dict[str, Any],
                    config: BitLlamaConfig) -> Dict[str, Any]:
    """Fuse q/k/v and gate/up packed projections into ``qkv_proj`` and
    ``gateup_proj`` (``FusedBitLinearWeights``): one kernel launch serves
    three (two) projections. Segments are zero-padded to a multiple of
    ``SEG_ALIGN`` with ``h = 0`` on the pads; the kernels normalise over the
    true width only. Projections fuse only when all are packed, bias-free
    and of one width (so q/k/v of a GQA model stay unfused), as in the JAX
    ``fuse_for_decode``."""
    layers = dict(params["layers"])

    def fusable(names):
        ws = [layers.get(n) for n in names]
        if not all(isinstance(w, BitLinearWeights) and w.mode == "packed"
                   and w.bias is None for w in ws):
            return None
        return ws if len({w.packed.shape[-1] for w in ws}) == 1 else None

    def fuse(ws):
        n_true = ws[0].packed.shape[-1]
        pad = -(-n_true // SEG_ALIGN) * SEG_ALIGN - n_true
        packed = torch.cat([F.pad(w.packed, (0, pad)) for w in ws], dim=-1)
        h = torch.cat([F.pad(w.weight_scale.float(), (0, pad)) for w in ws],
                      dim=-1)
        g = torch.stack([w.input_factor for w in ws], dim=-2)  # [L, ns, K]
        return FusedBitLinearWeights(weight_scale=h, input_factor=g,
                                     packed=packed.contiguous())

    for fused_name, names in (("qkv_proj", ("q_proj", "k_proj", "v_proj")),
                              ("gateup_proj", ("gate_proj", "up_proj"))):
        ws = fusable(names)
        if ws is not None:
            layers[fused_name] = fuse(ws)
            for n in names:
                del layers[n]
    out = dict(params)
    out["layers"] = layers
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _causal_mask(s: int, t: int, offset: int, device=None) -> torch.Tensor:
    """[1,1,S,T] bool: query i attends to keys <= offset + i."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    return (kj <= qi + offset)[None, None]


def _attention(q, k, v, mask, *, num_kv_groups: int) -> torch.Tensor:
    """GQA attention in plain torch ops: q ``[B,S,nh,hd]``, k/v
    ``[B,T,nkv,hd]``, mask ``[B,1,S,T]`` bool. Scores and softmax in fp32
    with ``-1e30`` on masked keys; probabilities rounded to v's dtype, the
    context accumulated in fp32 and returned in v's dtype."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, num_kv_groups, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(), k.float())
    scores = scores * (hd ** -0.5)
    scores = scores.masked_fill(~mask[:, :, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum("bngst,btnh->bsngh", probs.float(), v.float())
    return ctx.to(v.dtype).reshape(b, s, nh, hd)


# ---- per-layer projections over stacked params ----------------------------

def _project_flat(x, layers, name: str, i: int, impl: str):
    return bitlinear_apply_stacked(x, layers[name], i, impl=impl)


def _project_qkv_flat(hx, layers, i: int, impl: str, n_out: int):
    if "qkv_proj" in layers:
        return fused_bitlinear_apply_stacked(hx, layers["qkv_proj"], i,
                                             n_out, impl=impl)
    return tuple(_project_flat(hx, layers, n, i, impl)
                 for n in ("q_proj", "k_proj", "v_proj"))


def _project_gateup_flat(hx, layers, i: int, impl: str, n_out: int):
    if "gateup_proj" in layers:
        return fused_bitlinear_apply_stacked(hx, layers["gateup_proj"], i,
                                             n_out, impl=impl)
    return tuple(_project_flat(hx, layers, n, i, impl)
                 for n in ("gate_proj", "up_proj"))
