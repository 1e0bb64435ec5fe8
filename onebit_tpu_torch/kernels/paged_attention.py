"""Decode attention through page tables: the wrapper of kernel B10, with its
plain PyTorch version beside it.

Port of ``onebit_tpu/kernels/paged_attention.py`` ``paged_attention_flat``
for the page pools of ``engine/paged.py``: query ``q [B, nh, hd]`` attends
layer ``layer`` of a flat multi-layer pool ``[L, P, nkv, ps, hd]`` through
each row's page table ``page_indices [B, mp]`` over positions
``[0, lengths[b])``. Pages are in q's dtype, or int8 with raw absmax scales
``[L, P, nkv, ps, 1]`` that dequantize to q's dtype as
``(k_q * (k_s * (1 / 127.5)))``, or fp8 e4m3 with no scales, cast to q's
dtype (exactly: the function of JAX's gather path for fp8 pages,
``onebit_tpu/engine/paged.py:262-270``); page ids must lie in ``[0, P)``.
Scores are fp32 dots of q-dtype operands times ``hd**-0.5``, the softmax
is fp32, ``P = exp(s - m)`` is rounded to q's dtype before the PV sum,
and the output is ``acc / max(l, 1e-30)`` in float32.

Given CPU tensors the wrapper returns its plain version; given CUDA tensors
it launches its kernel (``kernels/paged_attention_cuda.py``) or raises. On
the card ``lengths`` and ``page_indices`` must be int32 tensors on the device
(the wrapper raises otherwise, rather than copying them once per layer: the
decode step copies them once per step). A row of length 0 gets a finite
output that is never read: the plain version gives the uniform average the
reference gives, the kernel zeros. :func:`paged_attention_flat_chunked`
mirrors the kernel's split over chunks, warps and tiles for the CPU tests.
"""

from __future__ import annotations

import torch

from onebit_tpu_torch.kernels import paged_attention_cuda as pc
from onebit_tpu_torch.utils.device import is_fake

_MAX_INT8 = 127.5    # the paged pools' quantization convention


def _gather_seq_kv(pages_l, page_indices) -> torch.Tensor:
    """Rows' positions from ONE layer's pages: ``pages_l [P, nkv, ps, X]``
    gathered through the tables ``[B, mp]`` -> ``[B, mp * ps, nkv, X]``
    (fp8 pages through a ``uint8`` view: the same bytes, and an indexing
    kernel every device has)."""
    if pages_l.dtype == torch.float8_e4m3fn:
        return _gather_seq_kv(pages_l.view(torch.uint8),
                              page_indices).view(pages_l.dtype)
    g = pages_l[page_indices.long()]                    # [B, mp, nkv, ps, X]
    b, mp, nkv, ps, last = g.shape
    return g.transpose(2, 3).reshape(b, mp * ps, nkv, last)


def paged_attention_flat_torch(q, *pool, lengths, page_indices, layer: int,
                               quant: bool = False) -> torch.Tensor:
    b, nh, hd = q.shape
    page_indices = torch.as_tensor(page_indices, device=q.device)
    lengths = torch.as_tensor(lengths, device=q.device).long()
    if quant:
        kq, ks, vq, vs = (_gather_seq_kv(x[layer], page_indices)
                          for x in pool)
        inv = 1.0 / _MAX_INT8
        k = (kq.float() * (ks.float() * inv)).to(q.dtype)
        v = (vq.float() * (vs.float() * inv)).to(q.dtype)
    else:
        k, v = (_gather_seq_kv(x[layer], page_indices).to(q.dtype)
                for x in pool)
    t, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, nkv, nh // nkv, hd)
    s = torch.einsum("bngh,btnh->bngt", qg.float(), k.float()) * hd ** -0.5
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bngt,btnh->bngh", p.to(q.dtype).float(), v.float())
    out = acc / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.reshape(b, nh, hd)


def paged_attention_flat_chunked(q, *pool, lengths, page_indices, layer: int,
                                 quant: bool = False) -> torch.Tensor:
    """B10's arithmetic on the CPU, step by step (``csrc/paged_attention.cu``):
    row b's positions ``[0, lengths[b])`` (at most ``mp * ps``) cut into
    chunks of ``PAGED_CHUNK`` from position 0; in a chunk, warp w of 4 takes
    tiles ``w, w + 4, ...`` of 16 positions and runs an online softmax
    over them (fp32 scores of the dequantized operands x hd**-0.5, P =
    exp(s - m) at the running max rounded to q's dtype, the PV sum in fp32,
    l the sum of the unrounded P); the warps' (m, l, acc) merge in warp
    order, the chunks' in chunk order; out = acc / max(l, 1e-30) in float32,
    zeros for a row of length 0. A plain mirror for the CPU tests; no path
    calls it."""
    b, nh, hd = q.shape
    chunk, warps, tile = pc.PAGED_CHUNK, 4, 16
    page_indices = torch.as_tensor(page_indices)
    if quant:
        kq, ks, vq, vs = (_gather_seq_kv(x[layer], page_indices)
                          for x in pool)
        inv = 1.0 / _MAX_INT8
        k = (kq.float() * (ks.float() * inv)).to(q.dtype).float()
        v = (vq.float() * (vs.float() * inv)).to(q.dtype).float()
    else:
        k, v = (_gather_seq_kv(x[layer], page_indices).to(q.dtype).float()
                for x in pool)
    t_max, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    qf = q.float().reshape(b, nkv, g, hd)
    out = torch.zeros((b, nkv, g, hd), dtype=torch.float32)
    length = torch.as_tensor(lengths).long().clamp(0, t_max)

    def merge(parts):
        m = torch.stack([p[0] for p in parts])          # [n, nkv, g]
        top = m.amax(0)
        f = torch.exp(m - top)
        l_sum = sum(p[1] * f[i] for i, p in enumerate(parts))
        acc = sum(p[2] * f[i][..., None] for i, p in enumerate(parts))
        return top, l_sum, acc

    for row in range(b):
        hi = int(length[row])
        chunks = []
        for c0 in range(0, hi, chunk):
            c1 = min(c0 + chunk, hi)
            per_warp = []
            for w in range(warps):
                m = torch.full((nkv, g), -1e30)
                l_sum = torch.zeros((nkv, g))
                acc = torch.zeros((nkv, g, hd))
                for t0 in range(c0 + w * tile, c1, warps * tile):
                    pos = torch.arange(t0, min(t0 + tile, c1))
                    s = torch.einsum("ngd,pnd->ngp", qf[row],
                                     k[row, pos]) * hd ** -0.5
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[..., None])
                    l_sum = l_sum * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "ngp,pnd->ngd", p.to(q.dtype).float(), v[row, pos])
                    m = m_new
                per_warp.append((m, l_sum, acc))
            chunks.append(merge(per_warp))
        if chunks:
            _, l_sum, acc = merge(chunks)
            out[row] = acc / l_sum.clamp(min=1e-30)[..., None]
    return out.reshape(b, nh, hd)


def paged_attention_flat(q, *pool, lengths, page_indices, layer: int,
                         quant: bool = False) -> torch.Tensor:
    """B10: ``pool`` is ``(k_pages, v_pages)`` each ``[L, P, nkv, ps, hd]``
    in q's dtype or fp8 e4m3, or with ``quant`` the four
    ``QuantPagedKVCache`` leaves (int8 pages, f32 scales ``[L, P, nkv, ps,
    1]``); ``lengths [B]`` valid
    positions per row (this step's token included), ``page_indices
    [B, mp]``; ``layer`` a Python int. The pools are read only. Returns
    ``[B, nh, hd]`` float32. On fake tensors (``parallel/memplan.py``)
    only the output is made."""
    if is_fake(q):
        return q.new_empty(q.shape, dtype=torch.float32)
    if q.device.type == "cpu":
        return paged_attention_flat_torch(
            q, *pool, lengths=lengths, page_indices=page_indices,
            layer=layer, quant=quant)
    return pc.launch(q, pool, lengths, page_indices, layer, quant)


PLAIN = {paged_attention_flat: paged_attention_flat_torch}
