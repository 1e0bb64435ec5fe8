"""BitLlama: the KV cache, fused decode params, RMSNorm, the per-layer
projection helpers and their strategy (``Proj``: one device's here, a
tensor-parallel rank's in ``model/tp_decode.py``), one decoder layer and
the full-sequence ``forward``.

Port of ``onebit_tpu/model/bitllama.py`` for serving, evaluation and
training. Params are plain dicts of tensors with layers stacked on a
leading axis, as in the JAX package: ``{"embed_tokens", "lm_head",
"final_norm", "layers": {...}}`` where each projection is a
``BitLinearWeights`` (or a
``FusedBitLinearWeights`` after :func:`fuse_for_decode`, or a
``LinearWeights`` for the FP teacher) whose leaves carry a leading ``[L]``
axis. PyTorch runs eagerly: the layer loop is a Python loop.

``forward`` runs each causal, unpadded layer's attention in kernel B11
(``kernels/attention.py``) on the card, differentiably (its backward in
B11-dkv and B11-dq); with a padding mask, on the CPU, with
``use_flash=False`` or when attention maps are asked for it takes the
masked attention ``_attention``. ``init_params`` and ``pack_model_params``
make and pack the latent params of training.

``decode_step_flat`` (and ``decode_step``, the same function over the
dense and flat int8 caches) appends ``s`` tokens to every row at one shared
cache index, the step of batch generation (``engine/generate.py``): a
one-token step attends the dense or flat int8 cache in kernel B9 and the
transposed-K int8/int4 caches in B5/B7 (``kernels/kv_attention.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from onebit_tpu_torch.core.packing import pack_signs_kmajor
from onebit_tpu_torch.kernels.attention import (PLAIN, _attention,
                                                _causal_mask,
                                                flash_causal_attention)
from onebit_tpu_torch.kernels import kv_attention as ka
from onebit_tpu_torch.kernels.bitlinear import (
    BitLinearWeights,
    FusedBitLinearWeights,
    bitlinear_apply_stacked,
    fused_bitlinear_apply_stacked,
)
from onebit_tpu_torch.kernels.linear import LinearWeights, linear_apply
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.kv_cache import (QuantKVCache, QuantKVCacheKT,
                                             QuantKVCacheKT4,
                                             pack_int4_halfplane,
                                             quantize_kv, quantize_kv4,
                                             unpack_int4_halfplane)
from onebit_tpu_torch.model.rope import apply_rope, rope_cos_sin
from onebit_tpu_torch.utils.device import on_card, resolve_device

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
                  dtype=torch.bfloat16, device=None,
                  num_kv_heads: Optional[int] = None) -> KVCache:
    """Zeros; ``num_kv_heads`` overrides the config's head count (a
    tensor-parallel rank holds ``nkv / mp`` heads)."""
    device = resolve_device(device)
    shape = (config.num_hidden_layers, batch, max_len,
             num_kv_heads or config.num_key_value_heads, config.head_dim)
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


def init_params(config: BitLlamaConfig,
                generator: Optional[torch.Generator] = None, *,
                mode: str = "latent", dtype=torch.float32,
                device=None) -> Dict[str, Any]:
    """Random params, layers stacked on axis 0 (bitllama.py:80-117), drawn
    from ``generator`` (seed 0 on ``device`` when None; its stream is not
    JAX's, so tests carry JAX's params across with ``params_from_jax``).

    ``mode``: ``"latent"`` (QAT latent weights of std
    ``initializer_range``, h = g = 1), ``"packed"`` (random sign words in
    the port's layout) or ``"linear"`` (the plain FP teacher)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device)
        generator.manual_seed(0)
    L, d, v = config.num_hidden_layers, config.hidden_size, config.vocab_size
    std = config.initializer_range

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype) * std

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params: Dict[str, Any] = {
        "embed_tokens": normal(v, d), "lm_head": normal(v, d),
        "final_norm": ones(d),
        "layers": {"input_layernorm": ones(L, d),
                   "post_attention_layernorm": ones(L, d)},
    }
    for name, (out, inp) in _proj_dims(config).items():
        h, g = ones(L, out), ones(L, inp)
        if mode == "latent":
            w = BitLinearWeights(weight_scale=h, input_factor=g,
                                 latent=normal(L, out, inp))
        elif mode == "packed":
            words = torch.randint(-2 ** 31, 2 ** 31 - 1, (L, inp // 32, out),
                                  generator=generator, device=device,
                                  dtype=torch.int64).to(torch.int32)
            w = BitLinearWeights(weight_scale=h, input_factor=g,
                                 packed=words)
        elif mode == "linear":
            w = LinearWeights(weight=normal(L, out, inp))
        else:
            raise ValueError(f"unknown init mode {mode!r}")
        params["layers"][name] = w
    return params


def pack_model_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Latent or dense-sign projections -> packed sign words in the port's
    layout (bitllama.py:185-202), one layer at a time; h, g and the bias
    pass through (detached from any autograd graph). The port's
    counterpart of
    scripts/convert_llama_to_infer_ckpt.py."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in PROJ_NAMES:
        w = layers[name]
        if w.mode == "packed":
            continue
        dense = w.latent if w.latent is not None else w.dense_sign
        packed = torch.stack([pack_signs_kmajor(d.detach()) for d in dense])
        layers[name] = BitLinearWeights(
            weight_scale=w.weight_scale.detach(),
            input_factor=w.input_factor.detach(), packed=packed,
            bias=None if w.bias is None else w.bias.detach())
    out["layers"] = layers
    return out


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


# ---- the projection strategy and one decoder layer -------------------------

class Proj(NamedTuple):
    """A decoder stack's per-layer projections and head geometry: the seam
    between one device and a tensor-parallel shard, the counterpart of the
    JAX package's ``PagedProj`` (``engine/paged.py:315``).
    :func:`default_proj` is one device's; ``model/tp_decode.py`` ``tp_proj``
    a shard's, whose ``nh`` and ``nkv`` are the heads that rank holds."""
    embed: Callable    # ids -> x [..., d] in the compute dtype
    qkv: Callable      # (hx, i) -> (q, k, v), flat
    o: Callable        # (ctx [..., nh*hd], i) -> [..., d]
    gateup: Callable   # (hx, i) -> (gate, up)
    down: Callable     # (act, i) -> [..., d]
    ln: Callable       # (x, norm name, i) -> rms-normed x
    final: Callable    # x -> final-normed x
    nh: int
    nkv: int
    # h -> fp32 logits; None: the lm_head of the params forward is given
    head: Optional[Callable] = None


def default_proj(params, config: BitLlamaConfig, impl: str,
                 compute_dtype=torch.bfloat16) -> Proj:
    """One device's strategy: the flat projections of the stacked params
    (BitLinear, fused or not, or the teacher's plain Linear)."""
    layers = params["layers"]
    eps = config.rms_norm_eps
    nkv_hd = config.num_key_value_heads * config.head_dim
    return Proj(
        embed=lambda ids: params["embed_tokens"][ids].to(compute_dtype),
        qkv=lambda hx, i: _project_qkv_flat(hx, layers, i, impl, nkv_hd),
        o=lambda v, i: _project_flat(v, layers, "o_proj", i, impl),
        gateup=lambda hx, i: _project_gateup_flat(
            hx, layers, i, impl, config.intermediate_size),
        down=lambda v, i: _project_flat(v, layers, "down_proj", i, impl),
        ln=lambda x, name, i: rms_norm(x, layers[name][i], eps),
        final=lambda x: rms_norm(x, params["final_norm"], eps),
        nh=config.num_attention_heads, nkv=config.num_key_value_heads)


def _attention_block(x, proj: Proj, i: int, attend):
    """The first half of layer ``i``: ``x`` plus the attention of its
    normed self (see :func:`_decoder_layer`)."""
    b, s = x.shape[:2]
    hx = proj.ln(x, "input_layernorm", i)
    q, k, v = proj.qkv(hx, i)
    hd = q.shape[-1] // proj.nh
    ctx = attend(q.reshape(b, s, proj.nh, hd), k.reshape(b, s, proj.nkv, hd),
                 v.reshape(b, s, proj.nkv, hd))
    return x + proj.o(ctx.reshape(b, s, proj.nh * hd), i)


def _mlp_block(x, proj: Proj, i: int):
    """The second half of layer ``i``: ``x`` plus the MLP of its normed
    self."""
    hx = proj.ln(x, "post_attention_layernorm", i)
    gate, up = proj.gateup(hx, i)
    return x + proj.down(F.silu(gate) * up, i)


def _decoder_layer(x, proj: Proj, i: int, attend):
    """Layer ``i`` on ``x [B, S, d]`` around ``attend(q, k, v) -> ctx``,
    which takes the projections before RoPE (``[B, S, n, hd]``) and returns
    ``[B, S, nh, hd]``: the caller owns RoPE, the cache and the mask."""
    return _mlp_block(_attention_block(x, proj, i, attend), proj, i)


# ---- the full-sequence forward ----------------------------------------------

def _lm_head(x, params, compute_dtype) -> torch.Tensor:
    """fp32-accumulated logits of the lm_head cast to ``compute_dtype``."""
    w = params["lm_head"].to(compute_dtype)
    return torch.matmul(x.float(), w.float().T)


def forward(params, input_ids, config: BitLlamaConfig, *,
            attention_mask=None, impl: str = "auto",
            compute_dtype=torch.bfloat16, use_flash="auto",
            return_prelogits: bool = False,
            output_hidden_states: bool = False,
            output_attentions: bool = False, remat: bool = False,
            proj: Optional[Proj] = None):
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
    version on the CPU); ``False`` the masked attention. B11 is
    differentiable: under autograd its backward runs the kernels B11-dkv
    and B11-dq on the card.

    The training extras, as in JAX: ``output_hidden_states`` adds a stacked
    ``[L+1, B, S, d]`` (the embeddings, then each layer's output);
    ``output_attentions`` adds ``[L, B, nh, S, S]`` probabilities in
    ``compute_dtype`` and takes the masked attention in every layer (never
    B11); the return is then ``(logits, *extras)``. ``remat`` recomputes
    each layer in the backward pass (``torch.utils.checkpoint``,
    non-reentrant; its two halves apart, so that the backward holds one
    half's activations at a time), which runs B11's forward a second time.
    ``proj``
    replaces :func:`default_proj`'s strategy over ``params``: a sharded
    rank's, which gathers each layer's shards at use and on a model axis
    runs its heads (``parallel/sharding.py``)."""
    b, s = input_ids.shape
    device = input_ids.device
    if proj is None:
        proj = default_proj(params, config, impl, compute_dtype)
    x = proj.embed(input_ids)
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
        flash = attention_mask is None and on_card(input_ids)
    else:
        flash = bool(use_flash) and attention_mask is None
    flash = flash and not output_attentions
    flash_fn = (PLAIN[flash_causal_attention] if impl == "torch"
                else flash_causal_attention)
    if not flash:
        mask = _causal_mask(s, s, 0, device)
        if attention_mask is not None:
            mask = mask & (attention_mask[:, None, None, :] > 0)
    # the query heads a KV head serves on the heads the strategy holds (a
    # tensor-parallel rank may hold fewer than a group of them)
    g = proj.nh // proj.nkv

    def attention_half(x, i):
        probs = []

        def attend(q, k, v):
            q, k = apply_rope(q, k, cos, sin)
            if flash:
                return flash_fn(q, k, v, num_kv_groups=g)
            if output_attentions:
                ctx, p = _attention(q, k, v, mask, num_kv_groups=g,
                                    return_probs=True)
                probs.append(p)
                return ctx
            return _attention(q, k, v, mask, num_kv_groups=g)

        x = _attention_block(x, proj, i, attend)
        return (x, probs[0]) if output_attentions else x

    def run(fn, *args):
        return (checkpoint(fn, *args, use_reentrant=False) if remat
                else fn(*args))

    hidden, attn = [x], []
    for i in range(config.num_hidden_layers):
        out = run(attention_half, x, i)
        if output_attentions:
            out, p = out
            attn.append(p)
        x = run(_mlp_block, out, proj, i)
        if output_hidden_states:
            hidden.append(x)
    h = proj.final(x)
    if return_prelogits:
        return h
    logits = (proj.head(h) if proj.head is not None
              else _lm_head(h, params, compute_dtype))
    extras = []
    if output_hidden_states:
        extras.append(torch.stack(hidden))
    if output_attentions:
        extras.append(torch.stack(attn))
    return (logits, *extras) if extras else logits


# ---- incremental decode over a shared cache index (batch generation) ------

def _flat_attention(cache, cache_index: int, s: int, key_start, cos, sin,
                    config: BitLlamaConfig, impl: str):
    """``attend_at(i)``: layer ``i``'s attention for one step of
    :func:`decode_step_flat`, which writes the ``s`` new positions of every
    row at ``[cache_index, cache_index + s)`` of the cache in place, with
    what every layer shares made once."""
    b = cache[0].shape[1]
    device = cache[0].device
    ci, g = cache_index, config.num_kv_groups
    if s == 1:
        # one token: the kernels take [starts, lengths) as device int32
        lengths = torch.full((b,), ci + 1, dtype=torch.int32, device=device)
        pos = torch.full((b,), ci, dtype=torch.int32, device=device)
        starts = (None if key_start is None else
                  key_start.to(device=device, dtype=torch.int32))
    else:
        mask = _causal_mask(s, cache.max_len, ci, device)
        if key_start is not None:
            kj = torch.arange(cache.max_len, device=device)
            mask = mask & (kj[None, :] >= key_start.to(device)[:, None]
                           )[:, None, None, :]

    def kernel(fn):
        return ka.PLAIN[fn] if impl == "torch" else fn

    if isinstance(cache, (QuantKVCacheKT, QuantKVCacheKT4)):
        kt4 = isinstance(cache, QuantKVCacheKT4)
        quantize = quantize_kv4 if kt4 else quantize_kv
        fused = kernel(ka.kv_attention_append_kt4 if kt4
                       else ka.kv_attention_append_kt)

        def attend_at(i):
            def attend(q, k, v):
                q, k = apply_rope(q, k, cos, sin)
                nkq, nks = quantize(k)
                nvq, nvs = quantize(v)
                if s == 1:
                    # B5/B7 write the pools at pos and attend
                    return fused(q[:, 0].contiguous(), nkq[:, 0], nks[:, 0],
                                 nvq[:, 0], nvs[:, 0], *cache, lengths, i,
                                 pos, starts=starts)[:, None]
                # several tokens: write the layer, then the plain attention
                # (bitllama.py:652-677, 709-726)
                cache.k_st[i, :, :, ci:ci + s] = nks.transpose(1, 2)
                cache.v_s[i, :, ci:ci + s] = nvs
                new_k = nkq.permute(0, 2, 3, 1)          # [B, nkv, hd, s]
                if kt4:
                    k_i = unpack_int4_halfplane(cache.k_qp[i], axis=3)
                    k_i[..., ci:ci + s] = new_k
                    cache.k_qp[i] = pack_int4_halfplane(k_i, axis=3)
                    v_i = unpack_int4_halfplane(cache.v_qp[i], axis=1)
                    v_i[:, ci:ci + s] = nvq
                    cache.v_qp[i] = pack_int4_halfplane(v_i, axis=1)
                else:
                    cache.k_qt[i, ..., ci:ci + s] = new_k
                    cache.v_q[i, :, ci:ci + s] = nvq
                    k_i, v_i = cache.k_qt[i], cache.v_q[i]
                return ka._attention_quant(
                    q, k_i.permute(0, 3, 1, 2), cache.k_st[i].transpose(1, 2),
                    v_i, cache.v_s[i], mask, num_kv_groups=g)
            return attend
        return attend_at

    quant = isinstance(cache, QuantKVCache)
    decode = kernel(ka.kv_attention_decode)

    def attend_at(i):
        def attend(q, k, v):
            q, k = apply_rope(q, k, cos, sin)
            if quant:
                nkq, nks = quantize_kv(k)
                nvq, nvs = quantize_kv(v)
                for pool, new in zip(cache, (nkq, nks, nvq, nvs)):
                    pool[i, :, ci:ci + s] = new
                scales = (cache.k_s, cache.v_s)
            else:
                cache.k[i, :, ci:ci + s] = k.to(cache.k.dtype)
                cache.v[i, :, ci:ci + s] = v.to(cache.v.dtype)
                scales = (None, None)
            pools = (cache[0], scales[0], cache[2 if quant else 1], scales[1])
            if s == 1:
                # B9 over [key_start, cache_index + 1): the JAX window
                # ladder only bounds what is read, and lengths does that
                return decode(q[:, 0].contiguous(), *pools, lengths, i,
                              starts=starts)[:, None]
            if quant:
                return ka._attention_quant(q, *(x[i] for x in pools), mask,
                                           num_kv_groups=g)
            return _attention(q, cache.k[i].to(q.dtype),
                              cache.v[i].to(q.dtype), mask, num_kv_groups=g)
        return attend
    return attend_at


def decode_step_hidden(proj: Proj, cache, input_ids, cache_index: int,
                       config: BitLlamaConfig, *, impl: str = "auto",
                       compute_dtype=torch.bfloat16, positions=None,
                       key_start=None) -> torch.Tensor:
    """:func:`decode_step_flat` through the projection strategy ``proj``, up
    to the final norm: returns the hidden ``[B, s, d]``. The attention runs
    on the heads the cache holds (a tensor-parallel rank's ``nkv / mp``)."""
    s = input_ids.shape[1]
    device = cache[0].device
    x = proj.embed(input_ids)
    if positions is None:
        positions = cache_index + torch.arange(s, device=device)[None, :]
    cos, sin = rope_cos_sin(positions, config.head_dim, config.rope_theta,
                            config.rope_scaling,
                            config.max_position_embeddings,
                            seq_len=cache.max_len, dtype=compute_dtype)
    attend_at = _flat_attention(cache, int(cache_index), s, key_start, cos,
                                sin, config, impl)
    for i in range(config.num_hidden_layers):
        x = _decoder_layer(x, proj, i, attend_at(i))
    return proj.final(x)


def decode_step_flat(params, cache, input_ids, cache_index: int,
                     config: BitLlamaConfig, *, impl: str = "auto",
                     compute_dtype=torch.bfloat16, positions=None,
                     key_start=None):
    """Append ``input_ids [B, s]`` to every row at the host int
    ``cache_index`` and return ``(logits [B, s, V] fp32, cache)``
    (bitllama.py:552-808). The cache, a ``KVCache``, ``QuantKVCache``,
    ``QuantKVCacheKT`` or ``QuantKVCacheKT4``, is updated IN PLACE and
    returned (the JAX function returns a new one).

    ``positions [B, s]`` optionally overrides the RoPE positions (left-padded
    rows, whose true positions differ from the shared slot); ``key_start
    [B]`` masks the cache slots below it per row (left-pad slots written by
    the prefill). Tensors on the cache's device.

    A one-token step attends the dense and flat int8 caches in B9
    (``kv_attention_decode``) and the transposed-K caches in B5/B7, which
    write their pools themselves; several tokens take the plain masked
    attention. ``impl="torch"`` takes the kernels' plain versions, as do
    CPU tensors."""
    x = decode_step_hidden(default_proj(params, config, impl, compute_dtype),
                           cache, input_ids, cache_index, config, impl=impl,
                           compute_dtype=compute_dtype, positions=positions,
                           key_start=key_start)
    return _lm_head(x, params, compute_dtype), cache


def decode_step(params, cache, input_ids, cache_index: int,
                config: BitLlamaConfig, *, impl: str = "auto",
                compute_dtype=torch.bfloat16, positions=None,
                key_start=None):
    """The incremental forward over a ``KVCache`` or the flat int8
    ``QuantKVCache`` (bitllama.py:497-549): :func:`decode_step_flat`'s
    semantics, which the JAX package gives two programs (a layer scan and a
    flat loop) and eager PyTorch one body."""
    if isinstance(cache, (QuantKVCacheKT, QuantKVCacheKT4)):
        raise TypeError("QuantKVCacheKT(4) is a decode_step_flat cache (the "
                        "fused-kernel transposed-K layout); decode_step takes "
                        "KVCache and QuantKVCache")
    return decode_step_flat(params, cache, input_ids, cache_index, config,
                            impl=impl, compute_dtype=compute_dtype,
                            positions=positions, key_start=key_start)
