"""BitLlama: the KV cache, fused decode params, RMSNorm, the per-layer
projection helpers, one decoder layer and the full-sequence ``forward``.

Port of ``onebit_tpu/model/bitllama.py`` for serving and evaluation. Params
are plain dicts of tensors with layers stacked on a leading axis, as in the
JAX package: ``{"embed_tokens", "lm_head", "final_norm", "layers": {...}}``
where each projection is a ``BitLinearWeights`` (or a
``FusedBitLinearWeights`` after :func:`fuse_for_decode`, or a
``LinearWeights`` for the FP teacher) whose leaves carry a leading ``[L]``
axis. PyTorch runs eagerly: the layer loop is a Python loop.

``forward`` runs each causal, unpadded layer's attention in kernel B11
(``kernels/attention.py``) on the card; with a padding mask, on the CPU or
with ``use_flash=False`` it takes the masked attention ``_attention``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from onebit_tpu_torch.kernels.attention import (PLAIN, _attention,
                                                _causal_mask,
                                                flash_causal_attention)
from onebit_tpu_torch.kernels.bitlinear import (
    BitLinearWeights,
    FusedBitLinearWeights,
    bitlinear_apply_stacked,
    fused_bitlinear_apply_stacked,
)
from onebit_tpu_torch.kernels.linear import LinearWeights, linear_apply
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.rope import apply_rope, rope_cos_sin
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


# ---- per-layer projections over stacked params ----------------------------

def _project_flat(x, layers, name: str, i: int, impl: str):
    """Layer ``i`` of projection ``name``: BitLinear (quantized) or plain
    Linear (teacher), by the weight type (bitllama.py:41-45)."""
    w = layers[name]
    if isinstance(w, LinearWeights):
        return linear_apply(x, LinearWeights(*(None if a is None else a[i]
                                               for a in w)))
    return bitlinear_apply_stacked(x, w, i, impl=impl)


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


# ---- one decoder layer and the full-sequence forward -----------------------

def _decoder_layer(x, layers, i: int, config: BitLlamaConfig, impl: str,
                   attend):
    """Layer ``i`` on ``x [B, S, d]`` around ``attend(q, k, v) -> ctx``,
    which takes the projections before RoPE (``[B, S, n, hd]``) and returns
    ``[B, S, nh, hd]``: the caller owns RoPE, the cache and the mask."""
    b, s = x.shape[:2]
    nh, nkv, hd = (config.num_attention_heads, config.num_key_value_heads,
                   config.head_dim)
    residual = x
    hx = rms_norm(x, layers["input_layernorm"][i], config.rms_norm_eps)
    q, k, v = _project_qkv_flat(hx, layers, i, impl, nkv * hd)
    ctx = attend(q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd),
                 v.reshape(b, s, nkv, hd))
    x = residual + _project_flat(ctx.reshape(b, s, nh * hd), layers,
                                 "o_proj", i, impl)
    residual = x
    hx = rms_norm(x, layers["post_attention_layernorm"][i],
                  config.rms_norm_eps)
    gate, up = _project_gateup_flat(hx, layers, i, impl,
                                    config.intermediate_size)
    return residual + _project_flat(F.silu(gate) * up, layers, "down_proj",
                                    i, impl)


def _lm_head(x, params, compute_dtype) -> torch.Tensor:
    """fp32-accumulated logits of the lm_head cast to ``compute_dtype``."""
    w = params["lm_head"].to(compute_dtype)
    return torch.matmul(x.float(), w.float().T)


KD_SLICE = 5   # hidden states, attention maps and remat come with training


def forward(params, input_ids, config: BitLlamaConfig, *,
            attention_mask=None, impl: str = "auto",
            compute_dtype=torch.bfloat16, use_flash="auto",
            return_prelogits: bool = False,
            output_hidden_states: bool = False,
            output_attentions: bool = False, remat: bool = False):
    """Full-sequence forward (bitllama.py:415-494) -> logits ``[B, S, V]``
    fp32, or with ``return_prelogits`` the final-norm hidden states
    ``[B, S, d]`` in ``compute_dtype``.

    ``input_ids [B, S]`` on the params' device. ``attention_mask``: optional
    ``[B, S]`` 1/0 padding mask; padded keys are masked and positions follow
    ``max(cumsum(mask) - 1, 0)`` (left padding). ``impl``: ``"auto"`` (the
    kernels on the card, their plain versions on the CPU) or ``"torch"``
    (the plain versions of K3 and B11 on any device). ``use_flash``:
    ``"auto"`` runs B11 when the tensors are on the card and there is no
    mask; ``True`` takes B11's wrapper when there is no mask (its plain
    version on the CPU); ``False`` the masked attention."""
    if output_hidden_states or output_attentions or remat:
        raise NotImplementedError(
            "output_hidden_states, output_attentions and remat come with KD "
            f"training, slice {KD_SLICE} of the PyTorch port (ROADMAP.md)")
    b, s = input_ids.shape
    device = input_ids.device
    x = params["embed_tokens"][input_ids].to(compute_dtype)
    if attention_mask is not None:
        attention_mask = torch.as_tensor(attention_mask, device=device)
        positions = (torch.cumsum(attention_mask, dim=1) - 1).clamp(min=0)
    else:
        positions = torch.arange(s, device=device)[None, :]
    cos, sin = rope_cos_sin(positions, config.head_dim, config.rope_theta,
                            config.rope_scaling,
                            config.max_position_embeddings, seq_len=s,
                            dtype=compute_dtype)
    if use_flash == "auto":
        flash = attention_mask is None and device.type == "cuda"
    else:
        flash = bool(use_flash) and attention_mask is None
    flash_fn = (PLAIN[flash_causal_attention] if impl == "torch"
                else flash_causal_attention)
    if not flash:
        mask = _causal_mask(s, s, 0, device)
        if attention_mask is not None:
            mask = mask & (attention_mask[:, None, None, :] > 0)

    def attend(q, k, v):
        q, k = apply_rope(q, k, cos, sin)
        if flash:
            return flash_fn(q, k, v, num_kv_groups=config.num_kv_groups)
        return _attention(q, k, v, mask, num_kv_groups=config.num_kv_groups)

    layers = params["layers"]
    for i in range(config.num_hidden_layers):
        x = _decoder_layer(x, layers, i, config, impl, attend)
    h = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    if return_prelogits:
        return h
    return _lm_head(h, params, compute_dtype)
