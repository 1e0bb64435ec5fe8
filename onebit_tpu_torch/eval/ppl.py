"""Perplexity evaluation, with the reference windowing.

Port of ``onebit_tpu/eval/ppl.py``. The token stream is cut into
``nsamples = len(tokens) // seqlen`` non-overlapping windows of ``seqlen``;
per window ``nll_i = mean-CE over the (seqlen-1) shifted positions x
seqlen`` and ``ppl = exp(sum nll_i / (nsamples * seqlen))``. The reference's
quirk is kept: the mean is over ``seqlen - 1`` positions, the re-scale by
``seqlen``. Windows run ``batch_size`` at a time through ``forward`` in
fp32; a last short batch is padded with zero windows whose rows are
dropped. On the card each unpadded window's attention runs in kernel B11
and its projections in K3.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from onebit_tpu_torch.model import bitllama
from onebit_tpu_torch.model.config import BitLlamaConfig


def _window_nll(params, windows, config: BitLlamaConfig, *, impl="auto",
                compute_dtype=torch.float32) -> torch.Tensor:
    """windows ``[B, seqlen]`` -> per-window nll (mean-CE x seqlen), fp32."""
    logits = bitllama.forward(params, windows, config, impl=impl,
                              compute_dtype=compute_dtype)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tok_ll = logp.gather(-1, windows[:, 1:, None])[..., 0]
    mean_ce = -tok_ll.mean(dim=-1)                 # mean over seqlen-1
    return mean_ce * windows.shape[1]              # x seqlen (the quirk)


def _window_nll_chunked(params, windows, config: BitLlamaConfig, *,
                        impl="auto", compute_dtype=torch.float32,
                        vocab_chunk: int = 4096) -> torch.Tensor:
    """:func:`_window_nll` with the lm_head run in vocab chunks under an
    online logsumexp, so the ``[B, S, V]`` logits are never held. Chunk
    products are plain fp32-accumulated matmuls of ``compute_dtype``
    operands (outside any kernel, as in JAX); the last chunk may be short,
    which equals the JAX package's zero-padded, masked last chunk."""
    h = bitllama.forward(params, windows, config, impl=impl,
                         compute_dtype=compute_dtype, return_prelogits=True)
    hs = h[:, :-1].float()                               # [B, S-1, D]
    labels = windows[:, 1:]                              # [B, S-1]
    w = params["lm_head"].to(compute_dtype)              # [V, D]
    neg = torch.full(labels.shape, -1e30, device=hs.device)
    m, s, lab = neg, torch.zeros_like(neg), neg
    for off in range(0, w.shape[0], vocab_chunk):
        z = torch.matmul(hs, w[off:off + vocab_chunk].float().T)
        m_new = torch.maximum(m, z.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(z - m_new[..., None]).sum(-1)
        idx = labels - off
        in_chunk = (idx >= 0) & (idx < z.shape[-1])
        zlab = z.gather(-1, idx.clamp(0, z.shape[-1] - 1)[..., None])[..., 0]
        lab = torch.where(in_chunk, zlab, lab)
        m = m_new
    tok_ll = lab - (m + torch.log(s))                    # log p(label)
    return -tok_ll.mean(dim=-1) * windows.shape[1]       # x seqlen quirk


def window_nlls(params, config: BitLlamaConfig, tokens, *, seqlen: int = 2048,
                batch_size: int = 4, impl: str = "auto",
                compute_dtype=torch.float32, limit: Optional[int] = None,
                progress: bool = False,
                vocab_chunk: Optional[int] = None) -> np.ndarray:
    """Per-window nll ``[nsamples]`` (float32) of a 1-D token stream, the
    windows on the params' device: what :func:`perplexity` sums."""
    tokens = np.asarray(tokens).reshape(-1)
    nsamples = len(tokens) // seqlen
    if limit is not None:
        nsamples = min(nsamples, limit)
    if nsamples == 0:
        raise ValueError(f"token stream too short: {len(tokens)} < {seqlen}")
    windows = tokens[:nsamples * seqlen].reshape(nsamples, seqlen)
    device = params["embed_tokens"].device
    nbatches = -(-nsamples // batch_size)
    nlls = []
    for n, i in enumerate(range(0, nsamples, batch_size)):
        chunk = windows[i:i + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad, seqlen),
                                                    chunk.dtype)])
        ids = torch.from_numpy(chunk.astype(np.int64)).to(device)
        if vocab_chunk:
            nll = _window_nll_chunked(params, ids, config, impl=impl,
                                      compute_dtype=compute_dtype,
                                      vocab_chunk=vocab_chunk)
        else:
            nll = _window_nll(params, ids, config, impl=impl,
                              compute_dtype=compute_dtype)
        nll = nll.cpu().numpy()
        nlls.append(nll[:batch_size - pad] if pad else nll)
        if progress:
            print(f"ppl: batch {n + 1}/{nbatches}", file=sys.stderr,
                  flush=True)
    return np.concatenate(nlls)


def perplexity(params, config: BitLlamaConfig, tokens, *, seqlen: int = 2048,
               batch_size: int = 4, impl: str = "auto",
               compute_dtype=torch.float32, limit: Optional[int] = None,
               progress: bool = False,
               vocab_chunk: Optional[int] = None) -> float:
    """Windowed perplexity of a 1-D token stream (reference protocol).
    ``progress`` prints one line per batch to stderr."""
    nlls = window_nlls(params, config, tokens, seqlen=seqlen,
                       batch_size=batch_size, impl=impl,
                       compute_dtype=compute_dtype, limit=limit,
                       progress=progress, vocab_chunk=vocab_chunk)
    return ppl_from_nlls(nlls, seqlen)


def ppl_from_nlls(nlls: np.ndarray, seqlen: int) -> float:
    """``exp(sum nll / (nsamples * seqlen))``, the sum in float32 as the
    JAX package takes it."""
    return float(np.exp(float(nlls.sum()) / (len(nlls) * seqlen)))
