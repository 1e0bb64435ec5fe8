"""Tensor-parallel serving programs: what the continuous-batching engine
dispatches on each rank of a tensor-parallel group.

Port of ``onebit_tpu/engine/tp_backend.py``. Every rank runs the same
engine on the same requests (SPMD): the host scheduler decides nothing by
rank or by clock, so all ranks admit, page and finish alike, and each
program below makes the same collectives in the same order on every rank.
The programs are the single-device cores run through the rank's projection
strategy (``model/tp_decode.py`` ``tp_proj``):

* dense caches (bf16 ``KVCache``, int8 ``QuantKVCacheKT``, int4
  ``QuantKVCacheKT4``), head-sharded: :meth:`TPServing.step`,
  :meth:`~TPServing.greedy_step`, :meth:`~TPServing.prefill_rows`, and
  :meth:`~TPServing.chunk_append`, the dense chunked prefill's chunk
  (bf16 and int8 caches; ``model/ragged_decode.py``);
* paged pools (bf16, int8 or fp8 pages), head-sharded:
  :meth:`~TPServing.paged_step`, :meth:`~TPServing.paged_greedy_step`,
  :meth:`~TPServing.paged_prefill_rows`, and
  :meth:`~TPServing.paged_chunk_append`, which admits a prefix-cache hit's
  suffix (``engine/paged.py``);
* the greedy speculative round, :meth:`~TPServing.spec_round` (dense bf16
  and int8 KT targets) and :meth:`~TPServing.paged_spec_round`
  (``tp_backend.py:744-885``): the draft runs whole on every rank, each
  rank proposing the same tokens, and the target's verify window runs
  through the rank's projections over its head-sharded cache;
* decode blocks, :meth:`~TPServing.block` and :meth:`~TPServing.paged_block`
  (``tp_backend.py:661-685``, ``:727``): ``block_steps`` steps with EOS
  and budgets handled on the device (``model/ragged_decode.py``
  ``decode_block``). They run eagerly: their collectives go through
  ``torch.distributed``, and gloo's all-reduce passes through the host,
  which no CUDA graph captures. The port's only card runs of tensor
  parallelism are gloo ranks sharing one card; a graph over NCCL waits for
  a machine with a card a rank (ROADMAP.md §1 items 9 and 10).

Greedy decode and the speculative round's acceptance gather no logits:
each rank takes the argmax of its vocab shard and only ``mp`` (max, index)
pairs per row cross the ranks (``_greedy_token``); sampling and admission
take the gathered fp32 logits (``_gathered_logits``).
"""

from __future__ import annotations

import numpy as np
import torch

from onebit_tpu_torch.engine import paged as pg
from onebit_tpu_torch.engine.sampler import SamplingConfig, sample_token
from onebit_tpu_torch.engine.speculative import (accept_greedy,
                                                 device_state,
                                                 draft_proposals)
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.ragged_decode import (chunk_append_hidden,
                                                  decode_block,
                                                  prefill_rows_hidden,
                                                  ragged_decode_core,
                                                  ragged_decode_hidden,
                                                  verify_window_hidden)
from onebit_tpu_torch.model.tp_decode import (_gathered_logits,
                                              _greedy_token, check_heads,
                                              tp_proj)

__all__ = ["TPServing", "tp_proj", "tree_to"]


def tree_to(tree, device):
    """A params tree (dicts, NamedTuples of tensors or None) with every
    tensor on ``device``: the draft that each rank holds whole."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(v, device) for v in tree))
    return tree


class TPServing:
    """One rank's serving programs over its shards (``shard_tp_params``)
    and its head-sharded cache, with the single-device programs'
    signatures (``tp_backend.py:534``). The cache initialisers take the
    rank's head count, ``num_kv_heads`` (``tp_backend.py:1000-1037``).
    ``draft_config`` and ``n_draft``: the speculative round's draft, whose
    params and dense cache each rank holds whole."""

    def __init__(self, group, config: BitLlamaConfig, *, impl: str = "auto",
                 compute_dtype=torch.bfloat16,
                 sampling: SamplingConfig = SamplingConfig(greedy=True),
                 block_steps: int = 1,
                 draft_config: BitLlamaConfig = None, n_draft: int = 4):
        check_heads(config, group.size)
        self.group = group
        self.config = config
        self.impl = impl
        self.compute_dtype = compute_dtype
        self.sampling = sampling
        self.block_steps = block_steps
        self.draft_config = draft_config
        self.n_draft = n_draft
        self.num_kv_heads = config.num_key_value_heads // group.size

    def _proj(self, params):
        return tp_proj(params, self.config, self.impl, self.compute_dtype,
                       self.group)

    def _kw(self):
        return dict(impl=self.impl, compute_dtype=self.compute_dtype)

    # -- dense caches --------------------------------------------------------
    def _step_hidden(self, params, cache, input_ids, row_pos, active):
        return ragged_decode_hidden(self._proj(params), cache, input_ids,
                                    row_pos, active, self.config,
                                    **self._kw())

    def step(self, params, cache, input_ids, row_pos, active):
        """``ragged_decode_step``: ``(logits [B, 1, V] fp32, cache)``."""
        x = self._step_hidden(params, cache, input_ids, row_pos, active)
        return (_gathered_logits(x, params, self.compute_dtype, self.group),
                cache)

    def greedy_step(self, params, cache, input_ids, row_pos, active):
        """One decode step's greedy tokens: ``(tokens [B], cache)``."""
        x = self._step_hidden(params, cache, input_ids, row_pos, active)
        return (_greedy_token(x[:, 0], params, self.compute_dtype,
                              self.group), cache)

    def prefill_rows(self, params, cache, ids, lengths, rows):
        """``prefill_rows``: ``(last_logits [R, V] fp32, cache)``."""
        last = prefill_rows_hidden(self._proj(params), cache, ids, lengths,
                                   rows, self.config, **self._kw())
        return (_gathered_logits(last, params, self.compute_dtype,
                                 self.group), cache)

    def chunk_append(self, params, cache, ids, start: int, length: int,
                     row: int):
        """``chunk_append_row`` (``tp_backend.py:635-660``): ``(logits [V]
        fp32, cache)`` at the chunk's last valid token."""
        x = chunk_append_hidden(self._proj(params), cache, ids, start, length,
                                row, self.config,
                                compute_dtype=self.compute_dtype)
        return (_gathered_logits(x, params, self.compute_dtype, self.group),
                cache)

    def _next_token(self, params, x, generator):
        """The block's sampled tokens ``[B]`` from the hidden ``[B, 1, d]``:
        greedy without gathering the logits (``tp_backend.py:672-676``)."""
        if self.sampling.greedy:
            return _greedy_token(x[:, 0], params, self.compute_dtype,
                                 self.group)
        logits = _gathered_logits(x, params, self.compute_dtype, self.group)
        return sample_token(logits[:, 0], generator, self.sampling)

    def block(self, params, cache, next_token, row_pos, active, budget,
              generator):
        """``ragged_decode_block`` over the rank's shards, run eagerly:
        ``(toks [n, B], valid [n, B], cache, finals)``."""
        proj = self._proj(params)

        def step(tok, pos, valid):
            x = ragged_decode_core(proj, cache, tok[:, None], pos, valid,
                                   self.config, **self._kw())
            return self._next_token(params, x, generator)

        toks, valid, finals = decode_block(
            step, next_token, row_pos, active, budget,
            n_steps=self.block_steps, eos=self.config.eos_token_id)
        return toks, valid, cache, finals

    # -- paged pools ---------------------------------------------------------
    def _paged_hidden(self, params, cache, input_ids, lengths, page_indices):
        return pg._window_core(
            self._proj(params), cache, pg._on(cache, input_ids, torch.long),
            pg._on(cache, lengths, torch.long),
            pg._tables(cache, page_indices), self.config, self.impl,
            self.compute_dtype)

    def paged_step(self, params, cache, input_ids, lengths, page_indices):
        """``paged_decode_step``: ``(logits [B, 1, V] fp32, cache)``."""
        x = self._paged_hidden(params, cache, input_ids, lengths,
                               page_indices)
        return (_gathered_logits(x, params, self.compute_dtype, self.group),
                cache)

    def paged_greedy_step(self, params, cache, input_ids, lengths,
                          page_indices):
        """One paged decode step's greedy tokens: ``(tokens [B], cache)``."""
        x = self._paged_hidden(params, cache, input_ids, lengths,
                               page_indices)
        return (_greedy_token(x[:, 0], params, self.compute_dtype,
                              self.group), cache)

    def paged_block(self, params, cache, next_token, lengths, page_indices,
                    active, budget, generator):
        """``paged_decode_block`` over the rank's shards, run eagerly:
        ``(toks [n, B], valid [n, B], cache, finals)``."""
        proj = self._proj(params)
        tables = pg._tables(cache, page_indices)

        def step(tok, lens, valid):
            x = pg._window_core(proj, cache, tok[:, None], lens, tables,
                                self.config, self.impl, self.compute_dtype)
            return self._next_token(params, x, generator)

        toks, valid, finals = decode_block(
            step, next_token, lengths, active, budget,
            n_steps=self.block_steps, eos=self.config.eos_token_id)
        return toks, valid, cache, finals

    def paged_prefill_rows(self, params, cache, ids, lengths, page_indices):
        """``paged_prefill_rows``: ``(last_logits [R, V] fp32, cache)``."""
        lengths = pg._on(cache, lengths, torch.long)
        x = pg._prefill_rows_core(
            self._proj(params), cache, pg._on(cache, ids, torch.long),
            lengths, pg._tables(cache, page_indices), self.config,
            self.impl, self.compute_dtype)
        last = x[torch.arange(x.shape[0], device=x.device),
                 (lengths - 1).clamp(min=0)]
        return (_gathered_logits(last, params, self.compute_dtype,
                                 self.group), cache)

    def paged_chunk_append(self, params, cache, ids, start: int, length: int,
                           table_row):
        """``paged_chunk_append_row``: ``(logits [V] fp32, cache)`` at the
        chunk's last valid token."""
        x = self._paged_hidden(params, cache,
                               pg._on(cache, ids, torch.long)[None, :],
                               [start], pg._tables(cache, table_row)[None, :])
        return (_gathered_logits(x[0, length - 1], params,
                                 self.compute_dtype, self.group), cache)

    # -- the greedy speculative round (tp_backend.py:744-885) -----------------
    def _spec(self, params, cache, d_params, d_cache, next_token, row_pos,
              active, budget, target):
        """Propose with the whole draft on this rank, verify through
        ``target(proj, window, positions) -> hidden [B, W, d]``, accept on
        the per-shard (max, index) pairs: ``(emitted, n_emit, new_next,
        new_row_pos, cache, d_cache)`` as device tensors, the same on every
        rank."""
        dev, tok0, pos0, act, bud = device_state(cache, next_token, row_pos,
                                                 active, budget)
        row_pos = np.asarray(row_pos, np.int64)
        props = draft_proposals(
            d_params, d_cache, tok0.to(d_cache[0].device), row_pos, active,
            self.draft_config, self.n_draft, self.impl, self.compute_dtype,
            lambda logits: logits.argmax(-1)).to(dev)
        window = torch.cat([tok0[:, None], props], dim=1)
        x = target(self._proj(params), window, row_pos, pos0)
        b, w, d = x.shape
        greedy = _greedy_token(x.reshape(b * w, d), params,
                               self.compute_dtype, self.group).reshape(b, w)
        return (*accept_greedy(props, greedy, tok0, pos0, act, bud,
                               self.config.eos_token_id), cache, d_cache)

    def spec_round(self, params, cache, d_params, d_cache, next_token,
                   row_pos, active, budget):
        """``spec_decode_round`` on a dense bf16 or int8 KT target (the
        window through ``verify_window_hidden``, JAX's
        ``_dense_core(attend_cache=True)`` and ``_kt_window_core``)."""
        def target(proj, window, pos_host, _):
            return verify_window_hidden(proj, cache, window, pos_host, active,
                                        self.config,
                                        compute_dtype=self.compute_dtype)
        return self._spec(params, cache, d_params, d_cache, next_token,
                          row_pos, active, budget, target)

    def paged_spec_round(self, params, cache, d_params, d_cache, next_token,
                         row_pos, page_indices, active, budget):
        """``spec_decode_round`` on a paged target (bf16, int8 or fp8
        pages): the window through ``_window_core``'s gather."""
        tables = pg._tables(cache, page_indices)

        def target(proj, window, _, pos_dev):
            return pg._window_core(proj, cache, window, pos_dev, tables,
                                   self.config, self.impl,
                                   self.compute_dtype, kernel=False)
        return self._spec(params, cache, d_params, d_cache, next_token,
                          row_pos, active, budget, target)
