"""Full-sequence attention: the masked softmax attention of the model, and
the wrapper of kernel B11 (causal attention with no padding mask) with its
plain PyTorch version beside it, differentiable through B11's backward
kernels B11-dkv and B11-dq.

Port of ``onebit_tpu/kernels/attention.py`` ``flash_causal_attention``, which
runs the upstream Pallas TPU flash-attention kernel with ``causal=True``:
q ``[B, S, nh, hd]``, k/v ``[B, S, nkv, hd]`` (GQA: kv head ``h // g``),
all in one dtype, float32 or bfloat16; ``sm_scale = hd**-0.5``; the output
``[B, S, nh, hd]`` in q's dtype. Its plain version is :func:`_attention`
with the causal mask: one function, written once. The upstream kernel's
``custom_vjp`` saves the rows' softmax statistics, computes ``di = Σ o·do``
with a plain op and runs two Pallas kernels for dK/dV and dQ; here
:class:`_FlashCausal` does the same with the forward's log-sum-exp and the
CUDA kernels of ``kernels/attention_cuda.py``.

Given CPU tensors the wrapper returns its plain version, whose gradient is
autograd through it; given CUDA tensors it launches its kernels or raises.
Unlike the TPU kernel, whose 128-blocks need ``S % 128 == 0``, the CUDA
kernels take any S.
"""

from __future__ import annotations

import torch

from onebit_tpu_torch.kernels import attention_cuda as fc
from onebit_tpu_torch.utils.device import on_card


def _causal_mask(s: int, t: int, offset: int, device=None) -> torch.Tensor:
    """[1,1,S,T] bool: query i attends to keys <= offset + i."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    return (kj <= qi + offset)[None, None]


def _attention(q, k, v, mask, *, num_kv_groups: int,
               return_probs: bool = False):
    """GQA attention in plain torch ops: q ``[B,S,nh,hd]``, k/v
    ``[B,T,nkv,hd]``, mask ``[B,1,S,T]`` bool. Scores and softmax in fp32
    with ``-1e30`` on masked keys; probabilities rounded to v's dtype, the
    context accumulated in fp32 and returned in v's dtype. With
    ``return_probs`` also the probabilities ``[B, nh, S, T]`` in v's dtype
    (the reference's ``output_attentions`` layout)."""
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, nkv, num_kv_groups, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(), k.float())
    scores = scores * (hd ** -0.5)
    scores = scores.masked_fill(~mask[:, :, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum("bngst,btnh->bsngh", probs.float(), v.float())
    ctx = ctx.to(v.dtype).reshape(b, s, nh, hd)
    if return_probs:
        return ctx, probs.reshape(b, nh, s, t)
    return ctx


def flash_causal_attention_torch(q, k, v, *, num_kv_groups: int
                                 ) -> torch.Tensor:
    s = q.shape[1]
    return _attention(q, k, v, _causal_mask(s, s, 0, q.device),
                      num_kv_groups=num_kv_groups)


def split_bf16(x: torch.Tensor, parts: int) -> list:
    """fp32 ``x`` as ``parts`` bf16 parts (hi, mid, lo), returned as fp32
    tensors: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
    difference exact in fp32."""
    out, rest = [], x.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out.append(part)
        rest = rest - part
    return out


# B11's fp32 instance (csrc/flash_attention.cu) multiplies, for S = Q Kᵀ and
# for P V alike, hi x hi and apart from it these five pairs of parts (0 hi,
# 1 mid, 2 lo), smallest first
SPLIT_SMALL = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0))


def flash_causal_attention_split(q, k, v, *, num_kv_groups: int):
    """B11's fp32 arithmetic on the CPU, step by step: q, k and v split into
    three bf16 parts, S = Qhi Khi + the ``SPLIT_SMALL`` products (each
    product of parts exact in fp32, the two sums apart, then joined), times
    hd**-0.5, causal mask; per key tile of 64, an online fp32 softmax and
    O = O * alpha + (P's and V's parts multiplied the same way, in fresh
    sums); out = O / l and the rows' log-sum-exp ``m + log l``
    ``[B, nh, S]``. A plain mirror for the CPU tests; no path calls it."""
    b, s, nh, hd = q.shape
    g = num_kv_groups
    qp = split_bf16(q.transpose(1, 2), 3)                 # [B, nh, S, hd]
    kp = split_bf16(k.repeat_interleave(g, 2).transpose(1, 2), 3)
    vp = split_bf16(v.repeat_interleave(g, 2).transpose(1, 2), 3)
    m = torch.full((b, nh, s), -1e30)
    l_sum = torch.zeros((b, nh, s))
    o = torch.zeros((b, nh, s, hd))
    qi = torch.arange(s)[:, None]
    for k0 in range(0, s, 64):
        keys = slice(k0, min(k0 + 64, s))

        def prods(a, c):            # a's and c's parts, split as the kernel
            return a[0] @ c[0] + sum(a[i] @ c[j] for i, j in SPLIT_SMALL)

        sc = prods(qp, [x[:, :, keys].transpose(-1, -2) for x in kp])
        sc = sc * hd ** -0.5
        kj = torch.arange(k0, keys.stop)[None, :]
        sc = sc.masked_fill(kj > qi, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l_sum = l_sum * alpha + p.sum(-1)
        o = o * alpha[..., None] + prods(split_bf16(p, 3),
                                         [x[:, :, keys] for x in vp])
        m = m_new
    out = (o / l_sum[..., None]).transpose(1, 2).contiguous()
    return out, m + torch.log(l_sum)


def flash_causal_attention_bwd_split(q, k, v, do, lse, di, *,
                                     num_kv_groups: int,
                                     small=SPLIT_SMALL):
    """B11-dkv's and B11-dq's fp32 arithmetic (csrc/flash_attention_bwd.cu),
    step by step, on the tensors' device: q, k, v and do split into three
    bf16 parts; every fp32 product is hi x hi and, summed apart, the
    ``small`` products of parts; S and dP over the causal half, the two
    sums joined; P = exp(S * scale - lse) and dS = P (dP - di) scale,
    unrounded, split into three parts for dV += Pᵀ dO and dK += dSᵀ Q (each
    query tile of 64's product afresh, the group's query heads outer and
    their query tiles inner, as the kernel walks them) and dQ += dS K (each
    key tile of 64's product afresh): a tile's small products' sum joins
    the fp32 running sum, then its hi x hi's.
    ``lse`` and ``di`` fp32 ``[B, nh, S]``; returns (dq, dk, dv) in fp32,
    shaped like q, k, v. A plain mirror for the tests; no path calls it."""
    b, s, nh, hd = q.shape
    g = num_kv_groups
    scale = hd ** -0.5

    def parts(x, heads=1):                 # [B, n, S, hd], three parts
        return split_bf16(x.float().transpose(1, 2)
                          .repeat_interleave(heads, 1), 3)

    def prods(a, c):
        return a[0] @ c[0] + sum(a[i] @ c[j] for i, j in small)

    def join(acc, a, c):
        acc = acc + sum(a[i] @ c[j] for i, j in small)
        return acc + a[0] @ c[0]

    def tr(xs):
        return [x.transpose(-1, -2) for x in xs]

    qp, dop, kp, vp = parts(q), parts(do), parts(k, g), parts(v, g)
    causal = _causal_mask(s, s, 0, q.device)[0]
    p = torch.exp(prods(qp, tr(kp)) * scale - lse[..., None])
    p = p.masked_fill(~causal, 0.0)
    ds = p * (prods(dop, tr(vp)) - di[..., None]) * scale
    pp, dsp = split_bf16(p, 3), split_bf16(ds, 3)
    dq = torch.zeros((b, nh, s, hd), device=q.device)
    for k0 in range(0, s, 64):
        keys = slice(k0, k0 + 64)
        dq = join(dq, [x[..., keys] for x in dsp],
                  [x[:, :, keys] for x in kp])
    dk = torch.zeros((b, nh // g, s, hd), device=q.device)
    dv = torch.zeros_like(dk)
    for gi in range(g):
        heads = slice(gi, nh, g)           # head hk * g + gi of kv head hk
        for q0 in range(0, s, 64):
            rows = slice(q0, q0 + 64)
            dv = join(dv, tr([x[:, heads, rows] for x in pp]),
                      [x[:, heads, rows] for x in dop])
            dk = join(dk, tr([x[:, heads, rows] for x in dsp]),
                      [x[:, heads, rows] for x in qp])
    return tuple(x.transpose(1, 2).contiguous() for x in (dq, dk, dv))


class _FlashCausal(torch.autograd.Function):
    """B11 with its backward: the forward saves q, k, v, o and the rows'
    log-sum-exp; the backward forms ``di = Σ o·do`` in fp32 (a plain op, as
    the upstream ``_flash_attention_bwd`` does) and launches B11-dkv and
    B11-dq."""

    @staticmethod
    def forward(ctx, q, k, v, num_kv_groups):
        out, lse = fc.launch(q, k, v, num_kv_groups, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_kv_groups = num_kv_groups
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        g = ctx.num_kv_groups
        di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = fc.launch_bwd_dkv(q, k, v, do, lse, di, g)
        dq = fc.launch_bwd_dq(q, k, v, do, lse, di, g)
        return dq, dk, dv, None


def flash_causal_attention(q, k, v, *, num_kv_groups: int) -> torch.Tensor:
    """B11: causal attention of q ``[B, S, nh, hd]`` over k/v
    ``[B, S, nkv, hd]`` (one dtype, float32 or bfloat16; on the card each
    row's ``[n, hd]`` contiguous, any batch and sequence strides) ->
    ``[B, S, nh, hd]`` in q's dtype. Under autograd on the card, its
    gradient runs B11-dkv and B11-dq."""
    if not on_card(q):
        return flash_causal_attention_torch(q, k, v,
                                            num_kv_groups=num_kv_groups)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashCausal.apply(q, k, v, num_kv_groups)
    return fc.launch(q, k, v, num_kv_groups)


PLAIN = {flash_causal_attention: flash_causal_attention_torch}
