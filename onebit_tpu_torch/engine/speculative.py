"""Speculative decoding: a draft model proposes, the target verifies the
window in one call.

Port of ``onebit_tpu/engine/speculative.py``. A round, for all rows:

* the draft proposes ``n_draft`` tokens from the pending token, one
  ``ragged_decode_step`` each over its own dense cache (K1/K2 and, on the
  card, B9), then consumes the last proposal too, so that its cache covers
  every window position;
* the target takes the window ``[t0, p1 .. pn]`` in one
  ``ragged_verify_window`` (``paged_verify_window`` with page tables), its
  projections at M = B (n + 1) rows;
* greedy (:func:`spec_decode_round`): the longest prefix of proposals equal
  to the target's greedy tokens is accepted and the target's next token
  added, so the output is the plain greedy decode's, token for token;
  sampled (:func:`spec_decode_round_sampled`): rejection sampling on the
  warped distributions, whose emitted tokens follow the target's warped
  distribution exactly;
* EOS and the per-row budgets clamp the counts on the device
  (:func:`_finalize`).

The positions of every step are the host's ``row_pos + j``, so nothing in
a round reads the device: the rounds return device tensors, and the engine
reads the emitted tokens, counts and new positions once.

Positions at ``max_len`` or past it (a row that fills the cache proposes
past its end) are written nowhere and attend every key, as JAX's scatter
drops them.
"""

from __future__ import annotations

import numpy as np
import torch

from onebit_tpu_torch.engine.paged import paged_verify_window
from onebit_tpu_torch.engine.sampler import SamplingConfig, warp_logits
from onebit_tpu_torch.model.bitllama import _lm_head, default_proj
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.ragged_decode import (ragged_decode_hidden,
                                                  ragged_verify_window)


def _verify(t_params, t_cache, window, row_pos, active, t_config,
            t_page_tables, impl, compute_dtype):
    """The target's window on a dense (``t_page_tables`` None) or paged
    cache (speculative.py:36-48)."""
    kw = dict(impl=impl, compute_dtype=compute_dtype)
    if t_page_tables is None:
        return ragged_verify_window(t_params, t_cache, window, row_pos,
                                    active, t_config, **kw)
    return paged_verify_window(t_params, t_cache, window, row_pos,
                               t_page_tables, t_config, **kw)


def draft_proposals(d_params, d_cache, tok, row_pos, active, d_config,
                    n_draft: int, impl, compute_dtype, pick):
    """``n_draft`` draft steps from ``tok [B]`` at the host positions
    ``row_pos + j``; ``pick(logits [B, V]) -> tokens [B]``. Then the last
    proposal is consumed too (its lm_head is not needed). Returns the
    proposals ``[B, n_draft]``."""
    proj = default_proj(d_params, d_config, impl, compute_dtype)
    kw = dict(impl=impl, compute_dtype=compute_dtype)
    props = []
    for j in range(n_draft + 1):
        x = ragged_decode_hidden(proj, d_cache, tok[:, None], row_pos + j,
                                 active, d_config, **kw)
        if j < n_draft:
            tok = pick(_lm_head(x[:, 0], d_params, compute_dtype))
            props.append(tok)
    return torch.stack(props, dim=1)


def device_state(cache, next_token, row_pos, active, budget):
    """The round's host state as tensors on the cache's device: ``(device,
    next_token, row_pos, active, budget)``."""
    dev = cache[0].device
    as_t = lambda x, dt: torch.as_tensor(np.asarray(x)).to(dev, dt)  # noqa
    return (dev, as_t(next_token, torch.long), as_t(row_pos, torch.long),
            as_t(active, torch.bool), as_t(budget, torch.long))


def spec_decode_round(t_params, d_params, t_cache, d_cache, next_token,
                      row_pos, active, budget, t_config: BitLlamaConfig,
                      d_config: BitLlamaConfig, t_page_tables=None, *,
                      n_draft: int, impl: str = "auto",
                      compute_dtype=torch.bfloat16):
    """One greedy speculative round for all rows (speculative.py:51-108).

    ``next_token [B]`` the pending token of each row (emitted, not yet
    consumed), ``row_pos [B]`` where it is written, ``active [B]`` bool and
    ``budget [B]`` the tokens each row may still emit: host arrays.
    ``t_page_tables``: None (a dense or int8 KT target cache) or the rows'
    page tables ``[B, max_pages]`` (a paged target). Both caches are
    written in place. Returns ``(emitted [B, n_draft+1], n_emit [B],
    new_next [B], new_row_pos [B], t_cache, d_cache)`` as device tensors:
    row ``b`` emitted ``emitted[b, :n_emit[b]]``; inactive rows emit
    nothing and keep their position."""
    dev, tok0, pos0, act, bud = device_state(t_cache, next_token, row_pos,
                                              active, budget)
    row_pos = np.asarray(row_pos, np.int64)
    props = draft_proposals(d_params, d_cache, tok0.to(d_cache[0].device),
                            row_pos, active, d_config, n_draft, impl,
                            compute_dtype,
                            lambda logits: logits.argmax(-1)).to(dev)
    window = torch.cat([tok0[:, None], props], dim=1)
    t_logits, t_cache = _verify(t_params, t_cache, window, row_pos, active,
                                t_config, t_page_tables, impl, compute_dtype)
    return (*accept_greedy(props, t_logits.argmax(-1), tok0, pos0, act, bud,
                           t_config.eos_token_id), t_cache, d_cache)


def accept_greedy(props, greedy, next_token, row_pos, active, budget,
                  eos: int):
    """The greedy acceptance (speculative.py:85-108): the longest prefix of
    the proposals ``props [B, n]`` equal to the target's greedy tokens
    ``greedy [B, n + 1]`` is kept and the target's next token added, then
    :func:`_finalize`. Device tensors; returns ``(emitted, n_emit,
    new_next, new_row_pos)``."""
    match = (props == greedy[:, :-1]).long()
    a = torch.cumprod(match, dim=1).sum(1)                # [B] in [0, n]
    rows = torch.arange(props.shape[0], device=props.device)
    emitted = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
    emitted[rows, a] = greedy[rows, a]
    return _finalize(emitted, a + 1, next_token, row_pos, active, budget,
                     eos)


def _finalize(emitted, n_emit, next_token, row_pos, active, budget,
              eos: int):
    """The EOS and budget clamps on the device (speculative.py:111-136):
    a row's count stops at its first emitted EOS and at its budget, and is
    0 for an inactive row. Returns ``(emitted, n_emit, new_next,
    new_row_pos)``."""
    b, width = emitted.shape
    rows = torch.arange(b, device=emitted.device)
    j = torch.arange(width, device=emitted.device)[None, :]
    is_eos = (emitted == eos) & (j < n_emit[:, None])
    first_eos = is_eos.long().argmax(1)        # the first maximum
    n_emit = torch.where(is_eos.any(1),
                         torch.minimum(n_emit, first_eos + 1), n_emit)
    n_emit = torch.minimum(n_emit, budget.clamp(min=0))
    n_emit = torch.where(active, n_emit, 0)
    new_next = torch.where(n_emit > 0,
                           emitted[rows, (n_emit - 1).clamp(min=0)],
                           next_token)
    return emitted, n_emit, new_next, row_pos + n_emit


def _categorical(probs, generator) -> torch.Tensor:
    """One draw a row from the (unnormalised) ``probs [B, V]``: the
    argmax of ``probs / e`` with ``e`` exponential, as the sampler draws
    (``engine/sampler.py``)."""
    e = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / e, dim=-1)


def spec_decode_round_sampled(t_params, d_params, t_cache, d_cache,
                              next_token, row_pos, active, budget,
                              generator: torch.Generator,
                              t_config: BitLlamaConfig,
                              d_config: BitLlamaConfig, t_page_tables=None,
                              *, n_draft: int, sampling: SamplingConfig,
                              impl: str = "auto",
                              compute_dtype=torch.bfloat16):
    """One rejection-sampling round (speculative.py:139-226): proposal
    ``x_i ~ q`` is accepted with probability ``min(1, p(x_i) / q(x_i))``;
    the first rejection is replaced by a draw from ``norm(max(p - q, 0))``,
    and full acceptance earns a bonus draw from ``p`` at the window's end.
    ``p`` and ``q`` are the target's and the draft's warped distributions
    (``warp_logits``). Randomness comes from ``generator``, drawn in turn:
    the draft's proposals, the acceptance uniforms, the replacement. Same
    arguments and returns as :func:`spec_decode_round`."""
    dev, tok0, pos0, act, bud = device_state(t_cache, next_token, row_pos,
                                              active, budget)
    row_pos = np.asarray(row_pos, np.int64)
    q_steps = []

    def pick(logits):
        q = torch.softmax(warp_logits(logits, sampling), dim=-1)
        q_steps.append(q)
        return _categorical(q, generator)

    props = draft_proposals(d_params, d_cache, tok0.to(d_cache[0].device),
                            row_pos, active, d_config, n_draft, impl,
                            compute_dtype, pick).to(dev)
    q_all = torch.stack(q_steps, dim=1).to(dev)            # [B, n, V]
    window = torch.cat([tok0[:, None], props], dim=1)
    t_logits, t_cache = _verify(t_params, t_cache, window, row_pos, active,
                                t_config, t_page_tables, impl, compute_dtype)
    # p_all[:, i]: the target's distribution after window[:i + 1]
    p_all = torch.softmax(warp_logits(t_logits, sampling), dim=-1)
    b = window.shape[0]
    rows = torch.arange(b, device=dev)
    p_i = torch.gather(p_all[:, :n_draft], 2, props[..., None])[..., 0]
    q_i = torch.gather(q_all, 2, props[..., None])[..., 0]
    u = torch.rand((b, n_draft), generator=generator, device=dev)
    accept = u * q_i.clamp(min=1e-20) < p_i                # u < min(1, p/q)
    a = torch.cumprod(accept.long(), dim=1).sum(1)
    # the replacement at the first rejection; on full acceptance the same
    # gather lands on p_all[:, n] with no q to subtract: the bonus draw
    p_a = p_all[rows, a]
    q_a = torch.where((a < n_draft)[:, None],
                      q_all[rows, a.clamp(max=n_draft - 1)], 0.0)
    resid = (p_a - q_a).clamp(min=0.0)
    # if the residual underflows to no mass (p close to q), p itself
    resid = torch.where(resid.sum(-1, keepdim=True) > 1e-9, resid, p_a)
    extra = _categorical(resid, generator)
    emitted = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
    emitted[rows, a] = extra
    return (*_finalize(emitted, a + 1, tok0, pos0, act, bud,
                       t_config.eos_token_id), t_cache, d_cache)
