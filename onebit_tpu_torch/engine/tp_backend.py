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
* paged pools (bf16 or int8 pages), head-sharded:
  :meth:`~TPServing.paged_step`, :meth:`~TPServing.paged_greedy_step`,
  :meth:`~TPServing.paged_prefill_rows`, and
  :meth:`~TPServing.paged_chunk_append`, which admits a prefix-cache hit's
  suffix (``engine/paged.py``);
* decode blocks, :meth:`~TPServing.block` and :meth:`~TPServing.paged_block`
  (``tp_backend.py:661-685``, ``:727``): ``block_steps`` steps with EOS
  and budgets handled on the device (``model/ragged_decode.py``
  ``decode_block``). They run eagerly: their collectives go through
  ``torch.distributed``, and gloo's all-reduce passes through the host,
  which no CUDA graph captures. The port's only card runs of tensor
  parallelism are gloo ranks sharing one card; a graph over NCCL waits for
  a machine with a card a rank (ROADMAP.md §1 item 6).

Greedy decode gathers no logits: each rank takes the argmax of its vocab
shard and only ``mp`` (max, index) pairs per row cross the ranks
(``_greedy_token``); sampling and admission take the gathered fp32 logits
(``_gathered_logits``).
"""

from __future__ import annotations

import torch

from onebit_tpu_torch.engine import paged as pg
from onebit_tpu_torch.engine.sampler import SamplingConfig, sample_token
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.ragged_decode import (chunk_append_hidden,
                                                  decode_block,
                                                  prefill_rows_hidden,
                                                  ragged_decode_core,
                                                  ragged_decode_hidden)
from onebit_tpu_torch.model.tp_decode import (_gathered_logits,
                                              _greedy_token, check_heads,
                                              tp_proj)

__all__ = ["TPServing", "tp_proj"]


class TPServing:
    """One rank's serving programs over its shards (``shard_tp_params``)
    and its head-sharded cache, with the single-device programs'
    signatures (``tp_backend.py:534``). The cache initialisers take the
    rank's head count, ``num_kv_heads`` (``tp_backend.py:1000-1037``)."""

    def __init__(self, group, config: BitLlamaConfig, *, impl: str = "auto",
                 compute_dtype=torch.bfloat16,
                 sampling: SamplingConfig = SamplingConfig(greedy=True),
                 block_steps: int = 1):
        check_heads(config, group.size)
        self.group = group
        self.config = config
        self.impl = impl
        self.compute_dtype = compute_dtype
        self.sampling = sampling
        self.block_steps = block_steps
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
