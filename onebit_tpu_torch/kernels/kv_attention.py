"""Decode attention over the KV pools: the wrappers of kernels B5-B9, each
with its plain PyTorch version beside it.

Port of ``onebit_tpu/kernels/kv_attention.py``:

* B5 :func:`kv_attention_append_kt` and B6 :func:`kv_attention_decode_kt`
  over the int8 transposed-K pools (``QuantKVCacheKT``);
* B7 :func:`kv_attention_append_kt4` and B8 :func:`kv_attention_decode_kt4`
  over the nibble-packed int4 pools (``QuantKVCacheKT4``), with the scales
  in their natural layout ``k_st [L,B,nkv,T]``, ``v_s [L,B,T,nkv]`` (the
  JAX ``_planar`` form exists only for XLA buffer forwarding);
* B9 :func:`kv_attention_decode` over the flat pools ``[L,B,T,nkv,hd]``:
  int8 with scales ``[L,B,T,nkv]`` (``QuantKVCache``), or bf16/f32 with no
  scales (the dense ``KVCache``), or fp8 e4m3 with no scales, read only.

Each attends layer ``layer`` of the pools for query ``q [B, nh, hd]`` over
positions ``[starts[b], lengths[b])`` of each row: scores
``(q·k) * k_scale * hd**-0.5`` in fp32, softmax in fp32, ``P * v_scale``
rounded to q's dtype, ``ctx`` in q's dtype. ``lengths``, ``starts`` and
``pos`` are ``[B]`` integer tensors; on the card they must be int32
tensors on the device (the wrapper raises otherwise, rather than copying
them once per layer: the decode step copies them once per step). The
stored scales are pre-divided (int8 absmax/127, int4 absmax/7), so a value
is its integer times its scale.

Given CPU tensors a wrapper returns its plain version; given CUDA tensors it
launches its kernel (``kernels/kv_attention_cuda.py``) or raises. A row with
no position to attend (an inactive engine slot, ``length == 0``) gets a
finite context that is never read: the plain version gives the uniform
average the reference gives, the kernel zeros.
"""

from __future__ import annotations

import torch

from onebit_tpu_torch.kernels import kv_attention_cuda as kc
from onebit_tpu_torch.kernels.attention import _attention
from onebit_tpu_torch.utils.device import is_fake
from onebit_tpu_torch.model.kv_cache import (merge_nibbles,
                                             unpack_int4_halfplane)


def _rows(x, b: int, device) -> torch.Tensor:
    """``[B]`` int32 on ``device`` from a tensor, array or scalar (no copy
    when it already is one)."""
    t = torch.as_tensor(x)
    if t.dim() == 0:
        t = t.expand(b)
    return t.to(device=device, dtype=torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _attention_quant(q, k_q, k_s, v_q, v_s, mask, *,
                     num_kv_groups: int) -> torch.Tensor:
    """GQA attention directly on an int8 (or int4-valued) cache, with no
    dequantized copy of it: the per-(position, head) scales fold exactly
    into the scores, ``(q·k_qᵀ) * k_s``, and into P, ``(probs ⊙ v_s) ·
    v_q``. q ``[B,S,nh,hd]``; k_q/v_q ``[B,T,nkv,hd]`` int8; k_s/v_s
    ``[B,T,nkv]`` f32; mask ``[B,1,S,T]`` bool. Scores and softmax in fp32;
    ``probs ⊙ v_s`` rounded to q's dtype, the context accumulated in fp32
    and returned in q's dtype. Port of ``_attention_quant`` of
    ``onebit_tpu/model/bitllama.py``."""
    b, s, nh, hd = q.shape
    nkv = k_q.shape[2]
    qg = q.reshape(b, s, nkv, num_kv_groups, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(), k_q.float())
    scores = scores * k_s.movedim(1, 2)[:, :, None, None, :]
    scores = scores * (hd ** -0.5)
    scores = scores.masked_fill(~mask[:, :, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    pv = (probs * v_s.movedim(1, 2)[:, :, None, None, :]).to(q.dtype)
    ctx = torch.einsum("bngst,btnh->bsngh", pv.float(), v_q.float())
    return ctx.reshape(b, s, nh, hd).to(q.dtype)


def _attend_torch(q, k, ks, v, vs, lengths, starts):
    """q ``[B,nh,hd]``; k/v ``[B,T,nkv,hd]`` int8; ks/vs ``[B,T,nkv]``."""
    b, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    cols = torch.arange(t, device=q.device)[None, :]
    valid = cols < _rows(lengths, b, q.device)[:, None]
    if starts is not None:
        valid &= cols >= _rows(starts, b, q.device)[:, None]
    return _attention_quant(q[:, None], k, ks, v, vs, valid[:, None, None, :],
                            num_kv_groups=nh // nkv)[:, 0]


def kv_attention_decode_kt_torch(q, k_qt, k_st, v_q, v_s, lengths, layer, *,
                                 starts=None):
    return _attend_torch(q, k_qt[layer].permute(0, 3, 1, 2),
                         k_st[layer].transpose(1, 2), v_q[layer], v_s[layer],
                         lengths, starts)


def _write_scales(k_snew, v_snew, k_st, v_s, layer, rows, pos):
    k_st[layer, rows, :, pos] = k_snew.to(k_st.dtype)
    v_s[layer, rows, pos] = v_snew.to(v_s.dtype)


def _append_kt(k_new, k_snew, v_new, v_snew, k_qt, k_st, v_q, v_s, layer,
               pos):
    """Write each row's int8 K column, V row and scales at its ``pos``."""
    b = k_new.shape[0]
    rows = torch.arange(b, device=k_qt.device)
    pos = _rows(pos, b, k_qt.device).long()
    k_qt[layer, rows, :, :, pos] = k_new
    v_q[layer, rows, pos] = v_new
    _write_scales(k_snew, v_snew, k_st, v_s, layer, rows, pos)


def kv_attention_append_kt_torch(q, k_new, k_snew, v_new, v_snew, k_qt, k_st,
                                 v_q, v_s, lengths, layer, pos, *,
                                 starts=None):
    _append_kt(k_new, k_snew, v_new, v_snew, k_qt, k_st, v_q, v_s, layer, pos)
    return kv_attention_decode_kt_torch(q, k_qt, k_st, v_q, v_s, lengths,
                                        layer, starts=starts)


def kv_attention_decode_kt4_torch(q, k_qp, k_st, v_qp, v_s, lengths, layer, *,
                                  starts=None):
    k = unpack_int4_halfplane(k_qp[layer], axis=3)     # [B, nkv, hd, T]
    v = unpack_int4_halfplane(v_qp[layer], axis=1)     # [B, T, nkv, hd]
    return _attend_torch(q, k.permute(0, 3, 1, 2), k_st[layer].transpose(1, 2),
                         v, v_s[layer], lengths, starts)


def _append_kt4(k_new, k_snew, v_new, v_snew, k_qp, k_st, v_qp, v_s, layer,
                pos):
    """Merge each row's int4 K and V into byte column ``pos % (T/2)`` (low
    nibble below T/2, high from T/2 on) and write its scales at ``pos``."""
    b = k_new.shape[0]
    t_half = k_st.shape[-1] // 2
    rows = torch.arange(b, device=k_qp.device)
    pos = _rows(pos, b, k_qp.device).long()
    hi = pos >= t_half
    c = torch.where(hi, pos - t_half, pos)
    hi3 = hi[:, None, None]
    k_qp[layer, rows, :, :, c] = merge_nibbles(k_qp[layer, rows, :, :, c],
                                               k_new, hi3)
    v_qp[layer, rows, c] = merge_nibbles(v_qp[layer, rows, c], v_new, hi3)
    _write_scales(k_snew, v_snew, k_st, v_s, layer, rows, pos)


def kv_attention_append_kt4_torch(q, k_new, k_snew, v_new, v_snew, k_qp,
                                  k_st, v_qp, v_s, lengths, layer, pos, *,
                                  starts=None):
    _append_kt4(k_new, k_snew, v_new, v_snew, k_qp, k_st, v_qp, v_s, layer,
                pos)
    return kv_attention_decode_kt4_torch(q, k_qp, k_st, v_qp, v_s, lengths,
                                         layer, starts=starts)


def kv_attention_decode_torch(q, k_q, k_s, v_q, v_s, lengths, layer, *,
                              starts=None):
    b, nh, _ = q.shape
    t, nkv = k_q.shape[2], k_q.shape[3]
    cols = torch.arange(t, device=q.device)[None, :]
    valid = cols < _rows(lengths, b, q.device)[:, None]
    if starts is not None:
        valid &= cols >= _rows(starts, b, q.device)[:, None]
    mask = valid[:, None, None, :]
    if k_s is not None:
        return _attention_quant(q[:, None], k_q[layer], k_s[layer],
                                v_q[layer], v_s[layer], mask,
                                num_kv_groups=nh // nkv)[:, 0]
    return _attention(q[:, None], k_q[layer].to(q.dtype),
                      v_q[layer].to(q.dtype), mask,
                      num_kv_groups=nh // nkv)[:, 0]


def _fresh(nkv: int, g: int, hd: int):
    """An empty online-softmax state ``(m, l, acc)``."""
    return (torch.full((nkv, g), -1e30), torch.zeros((nkv, g)),
            torch.zeros((nkv, g, hd)))


def _tile_step(qf, k, ks, v, vs, valid, state, dtype):
    """One warp tile of the kernels' online softmax: ``qf [nkv, g, hd]``
    f32; the tile's K and V ``[p, nkv, hd]`` and scales ``[p, nkv]`` (or
    None); the positions to attend ``valid [p]`` (None: all). Scores
    ``q·k x k_scale x hd**-0.5``; P = exp(s - m) at the running max, x the V
    scale (0 where masked), rounded to ``dtype`` for the PV sum in fp32; l
    sums the unrounded P."""
    m, l_sum, acc = state
    s = torch.einsum("ngd,pnd->ngp", qf, k.float())
    if ks is not None:
        s = s * ks.T[:, None, :]
    s = s * qf.shape[-1] ** -0.5
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_sum = l_sum * alpha + p.sum(-1)
    if vs is not None:
        if valid is not None:
            vs = vs.masked_fill(~valid[:, None], 0.0)
        p = p * vs.T[:, None, :]
    pr = p.to(dtype).float()
    acc = acc * alpha[..., None] + torch.einsum("ngp,pnd->ngd", pr, v.float())
    return m_new, l_sum, acc


def _merge(parts):
    """Online-softmax partials ``(m, l, acc)`` merged in list order: m =
    max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m)."""
    m = torch.stack([p[0] for p in parts])
    top = m.amax(0)
    f = torch.exp(m - top)
    l_sum = sum(p[1] * f[i] for i, p in enumerate(parts))
    acc = sum(p[2] * f[i][..., None] for i, p in enumerate(parts))
    return top, l_sum, acc


def kv_attention_decode_chunked(q, k_q, k_s, v_q, v_s, lengths, layer, *,
                                starts=None, chunk: int = kc.DECODE_CHUNK,
                                warps: int = 4, tile: int = 16):
    """B9's arithmetic on the CPU, step by step (``csrc/kv_attention_decode.cu``):
    row b's positions ``[start, length)`` cut into chunks of ``chunk`` from
    its start; in a chunk, warp w takes tiles ``w, w + warps, ...`` of
    ``tile`` positions and runs an online softmax over them (fp32 scores x
    the K scale x hd**-0.5, P = exp(s - m) at the running max, x the V
    scale, rounded to q's dtype, the PV sum in fp32, l the sum of the
    unrounded P); the warps' (m, l, acc) merge in warp order, the chunks'
    in chunk order; out = acc / max(l, 1e-30) in q's dtype, zeros for a row
    with nothing to attend. A plain mirror for the CPU tests; no path calls
    it."""
    b, nh, hd = q.shape
    t_len, nkv = k_q.shape[2], k_q.shape[3]
    g = nh // nkv
    qf = q.float().reshape(b, nkv, g, hd)
    out = torch.zeros((b, nkv, g, hd), dtype=torch.float32)
    length = _rows(lengths, b, "cpu").clamp(max=t_len)
    start = (_rows(starts, b, "cpu").clamp(min=0) if starts is not None
             else torch.zeros(b, dtype=torch.int32))

    for row in range(b):
        lo, hi = int(start[row]), int(length[row])
        if hi <= lo:
            continue
        chunks = []
        for c0 in range(lo, hi, chunk):
            c1 = min(c0 + chunk, hi)
            per_warp = []
            for w in range(warps):
                state = _fresh(nkv, g, hd)
                for t0 in range(c0 + w * tile, c1, warps * tile):
                    pos = torch.arange(t0, min(t0 + tile, c1))
                    state = _tile_step(
                        qf[row], k_q[layer, row, pos],
                        None if k_s is None else k_s[layer, row, pos],
                        v_q[layer, row, pos],
                        None if v_s is None else v_s[layer, row, pos],
                        None, state, q.dtype)
                per_warp.append(state)
            chunks.append(_merge(per_warp))
        _, l_sum, acc = _merge(chunks)
        out[row] = acc / l_sum.clamp(min=1e-30)[..., None]
    return out.reshape(b, nh, hd).to(q.dtype)


def kv_attention_kt_chunked(q, k_pool, k_scale, v_pool, v_scale, lengths,
                            layer, *, starts=None, append=None, int4=False):
    """B5-B8's arithmetic on the CPU, step by step
    (``csrc/kv_attention_kt.cuh``), over the int8 KT pools or (``int4``) the
    half-plane int4 ones: row b's byte columns cut into chunks of
    ``KT_CHUNK`` (``KT4_CHUNK``) from column 0. With ``append = (k_new,
    k_snew, v_new, v_snew, pos)`` each row's fresh column is written first
    (the pools are MUTATED IN PLACE), whether or not the row attends
    anything; the kernel's owner chunk writes the same bytes before it
    attends them. A chunk whose columns hold no position of [start, length)
    is skipped; in a chunk, warp w of 4 takes tiles ``w, w + 4, ...`` of
    ``KT_TILE`` byte columns, skips those with no position to attend, and
    runs an online softmax over each tile's positions (int4: both nibbles
    of each column, the low plane's then the high plane's); the warps merge
    in warp order, the live chunks in chunk order; out = acc / max(l,
    1e-30) in q's dtype, zeros for a row with nothing to attend. A plain
    mirror for the CPU tests; no path calls it."""
    b, nh, hd = q.shape
    nkv = k_pool.shape[2]
    g = nh // nkv
    t_len = k_scale.shape[-1]
    tb = t_len // 2 if int4 else t_len
    chunk, tile, warps = (kc.KT4_CHUNK if int4 else kc.KT_CHUNK), kc.KT_TILE, 4
    if append is not None:
        (_append_kt4 if int4 else _append_kt)(
            *append[:4], k_pool, k_scale, v_pool, v_scale, layer, append[4])
    qf = q.float().reshape(b, nkv, g, hd)
    out = torch.zeros((b, nkv, g, hd), dtype=torch.float32)
    length = _rows(lengths, b, "cpu").clamp(max=t_len)
    start = (_rows(starts, b, "cpu").clamp(min=0) if starts is not None
             else torch.zeros(b, dtype=torch.int32))
    kq, ks, vq, vs = (x[layer] for x in (k_pool, k_scale, v_pool, v_scale))
    for row in range(b):
        lo, hi = int(start[row]), int(length[row])
        spans = [(lo, min(hi, tb))] + ([(max(lo - tb, 0), hi - tb)] if int4
                                       else [])

        def live(x0, x1):
            return any(max(x0, a) < min(x1, z) for a, z in spans)

        chunks = []
        for c0 in range(0, tb, chunk):
            c1 = min(c0 + chunk, tb)
            if not live(c0, c1):
                continue
            per_warp = []
            for w in range(warps):
                state = _fresh(nkv, g, hd)
                for t0 in range(c0 + w * tile, c1, warps * tile):
                    if not live(t0, t0 + tile):
                        continue
                    cols = torch.arange(t0, min(t0 + tile, tb))
                    t = torch.cat([cols, cols + tb]) if int4 else cols
                    k = kq[row][..., cols].permute(2, 0, 1)   # [c, nkv, hd]
                    v = vq[row, cols]
                    if int4:
                        k = unpack_int4_halfplane(k, axis=0)
                        v = unpack_int4_halfplane(v, axis=0)
                    state = _tile_step(qf[row], k, ks[row][:, t].T, v,
                                       vs[row, t], (t >= lo) & (t < hi),
                                       state, q.dtype)
                per_warp.append(state)
            chunks.append(_merge(per_warp))
        if chunks:
            _, l_sum, acc = _merge(chunks)
            out[row] = acc / l_sum.clamp(min=1e-30)[..., None]
    return out.reshape(b, nh, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Wrappers: the plain version for CPU tensors, the kernel for CUDA tensors
# ---------------------------------------------------------------------------

def kv_attention_decode_kt(q, k_qt, k_st, v_q, v_s, lengths, layer: int, *,
                           starts=None):
    """B6: attention over layer ``layer`` of the int8 KT pools ``k_qt
    [L,B,nkv,hd,T]``, ``k_st [L,B,nkv,T]``, ``v_q [L,B,T,nkv,hd]``,
    ``v_s [L,B,T,nkv]`` (read only) -> ``ctx [B, nh, hd]`` in q's dtype."""
    if q.device.type == "cpu":
        return kv_attention_decode_kt_torch(q, k_qt, k_st, v_q, v_s, lengths,
                                            layer, starts=starts)
    return kc.launch(kc.DECODE_KT, q, k_qt, k_st, v_q, v_s, lengths, layer,
                     starts=starts)


def kv_attention_append_kt(q, k_new, k_snew, v_new, v_snew, k_qt, k_st, v_q,
                           v_s, lengths, layer: int, pos, *, starts=None):
    """B5: write this step's quantized K/V (``k_new/v_new [B,nkv,hd]`` int8,
    scales ``k_snew/v_snew [B,nkv]`` f32) at each row's ``pos`` of layer
    ``layer``, then attend as :func:`kv_attention_decode_kt`.

    The pools are MUTATED IN PLACE (the JAX function returns new pools);
    the return value is ``ctx [B, nh, hd]`` in q's dtype alone. Every row is
    written, inactive ones (``lengths[b] == 0``) included, as in the
    reference; a row that attends its new token needs
    ``lengths[b] > pos[b]``."""
    if q.device.type == "cpu":
        return kv_attention_append_kt_torch(
            q, k_new, k_snew, v_new, v_snew, k_qt, k_st, v_q, v_s, lengths,
            layer, pos, starts=starts)
    return kc.launch(kc.APPEND_KT, q, k_qt, k_st, v_q, v_s, lengths, layer,
                     starts=starts, append=(k_new, k_snew, v_new, v_snew, pos))


def kv_attention_decode_kt4(q, k_qp, k_st, v_qp, v_s, lengths, layer: int, *,
                            starts=None):
    """B8: attention over layer ``layer`` of the int4 pools ``k_qp
    [L,B,nkv,hd,T/2]``, ``v_qp [L,B,T/2,nkv,hd]`` (half-plane packed) with
    scales ``k_st [L,B,nkv,T]``, ``v_s [L,B,T,nkv]`` (absmax/7, read only)
    -> ``ctx [B, nh, hd]`` in q's dtype."""
    if q.device.type == "cpu":
        return kv_attention_decode_kt4_torch(q, k_qp, k_st, v_qp, v_s,
                                             lengths, layer, starts=starts)
    return kc.launch(kc.DECODE_KT4, q, k_qp, k_st, v_qp, v_s, lengths, layer,
                     starts=starts)


def kv_attention_append_kt4(q, k_new, k_snew, v_new, v_snew, k_qp, k_st,
                            v_qp, v_s, lengths, layer: int, pos, *,
                            starts=None):
    """B7: the int4 :func:`kv_attention_append_kt`. ``k_new/v_new`` hold
    int4 values in [-7, 7] as int8; each is merged into byte column
    ``pos % (T/2)``, low nibble below T/2 and high nibble from T/2 on, the
    partner nibble kept. The pools are MUTATED IN PLACE; returns ``ctx
    [B, nh, hd]`` in q's dtype alone."""
    if q.device.type == "cpu":
        return kv_attention_append_kt4_torch(
            q, k_new, k_snew, v_new, v_snew, k_qp, k_st, v_qp, v_s, lengths,
            layer, pos, starts=starts)
    return kc.launch(kc.APPEND_KT4, q, k_qp, k_st, v_qp, v_s, lengths, layer,
                     starts=starts, append=(k_new, k_snew, v_new, v_snew, pos))


def kv_attention_decode(q, k_q, k_s, v_q, v_s, lengths, layer: int, *,
                        starts=None):
    """B9: attention over layer ``layer`` of the flat pools ``k_q/v_q
    [L,B,T,nkv,hd]``, int8 with pre-divided scales ``k_s/v_s [L,B,T,nkv]``
    f32, or bf16/f32/fp8 e4m3 with ``k_s = v_s = None`` (on the card: of
    q's dtype, or fp8 e4m3), read only -> ``ctx [B, nh, hd]`` in q's dtype.
    Row ``b`` attends positions ``[starts[b], lengths[b])``. The plain
    version: the scale-folded ``_attention_quant`` on int8 pools,
    ``_attention`` over the pool cast to q's dtype otherwise (an fp8
    element is exact in bf16 and f32: JAX's ``k.astype(q.dtype)``,
    ``onebit_tpu/kernels/kv_attention.py:68,79``). On fake tensors
    (``parallel/memplan.py``) only the output is made."""
    if is_fake(q):
        return q.new_empty(q.shape)
    if q.device.type == "cpu":
        return kv_attention_decode_torch(q, k_q, k_s, v_q, v_s, lengths,
                                         layer, starts=starts)
    return kc.launch_flat(q, k_q, k_s, v_q, v_s, lengths, layer,
                          starts=starts)


PLAIN = {kv_attention_decode: kv_attention_decode_torch,
         kv_attention_append_kt: kv_attention_append_kt_torch,
         kv_attention_decode_kt: kv_attention_decode_kt_torch,
         kv_attention_append_kt4: kv_attention_append_kt4_torch,
         kv_attention_decode_kt4: kv_attention_decode_kt4_torch}
