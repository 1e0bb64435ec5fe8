"""Continuous batching engine: host-side scheduler over one KV cache.

Port of the dense and dense-quantized paths of
``onebit_tpu/engine/batching.py``:

* a fixed pool of ``max_batch`` slots shares one preallocated KV cache:
  dense in ``compute_dtype``, or with ``quantized_kv=True`` the int8
  transposed-K pools and with ``quantized_kv="int4"`` the nibble-packed
  int4 pools (``model/kv_cache.py``), whose decode attention runs the fused
  append+attend kernels;
* with ``paged=True`` the cache is a pool of ``page_size``-position pages
  (``engine/paged.py``; int8 pages with ``quantized_kv=True``, fp8 e4m3
  pages with ``quantized_kv="fp8"``) handed out
  by a refcounting allocator: admission reserves the pages a request can
  ever need and waits while the pool is short, and ``prefix_cache=True``
  shares full prompt pages between requests with the same prefix;
* waiting requests are admitted into free slots; admissions of one round
  are prefilled together, one ``prefill_rows`` (``paged_prefill_rows``)
  call per prompt bucket (prompts padded to a power of two, at least 32, at
  most ``max_len``); a paged admission with prefix hits, or any admission
  with ``prefill_chunk_size``, is prefilled alone in chunks
  (``paged_chunked_prefill_row``, ``chunked_prefill_row``);
* every ``step()`` runs one ``ragged_decode_step`` (``paged_decode_step``)
  for all slots, each row at its own cache position; with ``block_steps >
  1`` it runs ``block_steps`` of them as one decode block
  (``ragged_decode_block``, ``paged_decode_block``), EOS and budgets
  handled on the device. On the card a block is one captured CUDA graph,
  replayed (``engine/block_graph.py``); on the CPU and under ``tp_group``
  it runs eagerly. ``pipeline_blocks`` dispatches block N+1 from block N's
  device finals before it reads block N's tokens;
* with ``draft_params`` (and ``draft_config``) every ``step()`` is one
  speculative round (``engine/speculative.py``): the draft, on a dense
  cache of its own whose slots mirror the engine's, proposes ``n_draft``
  tokens a row and the target verifies them in one window, on any target
  cache but int4; greedy output is the plain engine's, sampled output
  follows the target's distribution. The draft's prompt is prefilled at
  admission, as the target's is;
* a finished row (EOS or ``max_new_tokens``) frees its slot and its pages
  at once;
* with ``tp_group`` (a :class:`~onebit_tpu_torch.parallel.mesh.TPGroup`,
  the counterpart of the JAX engine's ``tp_mesh``) the engine serves one
  rank of a tensor-parallel group: it keeps the rank's shards of the
  (unfused) params and a head-sharded cache of any of the kinds above, and
  dispatches the programs of ``engine/tp_backend.py``, the greedy
  speculative round among them (the draft whole on every rank). Every rank
  runs the same engine on the same requests; nothing the scheduler decides
  depends on the rank or the clock, and every rank seeds the same sampling
  generator, so all ranks emit the same tokens.

The JAX engine's exclusions raise its ``ValueError`` in its wording.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import itertools
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from onebit_tpu_torch.engine.block_graph import BlockGraph, BlockOut
from onebit_tpu_torch.engine.paged import (PageAllocator,
                                           init_paged_kv_cache,
                                           paged_chunk_append_row,
                                           paged_chunked_prefill_row,
                                           paged_decode_block,
                                           paged_decode_step,
                                           paged_prefill_rows)
from onebit_tpu_torch.engine.sampler import SamplingConfig, sample_token
from onebit_tpu_torch.engine.speculative import (spec_decode_round,
                                                 spec_decode_round_sampled)
from onebit_tpu_torch.engine.tp_backend import TPServing, tree_to
from onebit_tpu_torch.model.bitllama import init_kv_cache
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.kv_cache import (init_quant_kv_cache_kt,
                                             init_quant_kv_cache_kt4)
from onebit_tpu_torch.model.ragged_decode import (chunk_append_row,
                                                  chunked_prefill_row,
                                                  prefill_rows,
                                                  ragged_decode_block,
                                                  ragged_decode_step)
from onebit_tpu_torch.model.tp_decode import shard_tp_params
from onebit_tpu_torch.utils.device import resolve_device
from onebit_tpu_torch.utils import trace


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # streaming hooks, run on the engine thread: keep them cheap
    on_token: Optional[Callable[[int], None]] = None
    on_done: Optional[Callable[[], None]] = None
    # latency accounting (perf_counter timestamps); t_admit: when it
    # left the queue for a slot
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _check_quantized_kv(paged, quantized_kv, draft_params,
                        prefill_chunk_size) -> None:
    """The reference engine's exclusions, with its wording
    (batching.py:101-125), checked before anything else."""
    if paged and quantized_kv == "int4":
        raise ValueError(
            "quantized_kv='int4' requires paged=False (int4 "
            "nibble-packed pools exist only in the dense quantized "
            "engine; paged pools support int8/fp8)")
    if quantized_kv and not paged:
        if quantized_kv == "fp8":
            raise ValueError(
                "quantized_kv='fp8' requires paged=True (the dense "
                "quantized engine uses the int8 transposed-K fused "
                "kernel; fp8 pools exist only in the paged family)")
        if quantized_kv == "int4" and draft_params is not None:
            raise ValueError(
                "quantized_kv='int4' + speculative decoding is not "
                "supported (no int4 verify-window path; use int8)")
        if quantized_kv == "int4" and prefill_chunk_size:
            raise ValueError(
                "quantized_kv='int4' + prefill_chunk_size is not "
                "supported (no int4 chunk-append path; use the "
                "default bucketed prefill, or int8)")


def _check_blocks(block_steps, pipeline_blocks, draft_params) -> None:
    """The reference engine's exclusions of decode blocks, with its wording
    (batching.py:138-143, 190-193)."""
    if pipeline_blocks and block_steps > 1 and draft_params is not None:
        raise ValueError(
            "pipeline_blocks + speculative decoding are mutually "
            "exclusive (a spec round's acceptance decision needs the "
            "host every round — its RTT is already amortized over "
            "n_draft+1 tokens)")
    if draft_params is not None and block_steps > 1:
        raise ValueError("block_steps and speculative decoding are "
                         "mutually exclusive (a spec round already "
                         "amortizes host round trips)")


def _check_tp_spec(tp_group, draft_params, sampling) -> None:
    """The reference engine's exclusion of a sampled speculative round
    under tensor parallelism, with its wording (batching.py:164-169)."""
    if tp_group is not None and draft_params is not None and \
            not sampling.greedy:
        raise ValueError(
            "tp_mesh + speculative decoding supports greedy "
            "sampling only (TPServing runs the draft replicated "
            "and combines per-shard argmaxes; the rejection-"
            "sampling round would need full target distributions "
            "gathered every round)")


class ContinuousBatchingEngine:
    def __init__(self, params, config: BitLlamaConfig, *, max_batch: int = 8,
                 max_len: int = 2048, sampling: Optional[SamplingConfig] = None,
                 impl: str = "auto", compute_dtype=torch.bfloat16,
                 seed: int = 0, device=None, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 quantized_kv=False, block_steps: int = 1,
                 prefill_chunk_size: Optional[int] = None,
                 prefix_cache: bool = False, draft_params=None,
                 draft_config: Optional[BitLlamaConfig] = None,
                 n_draft: int = 4, tp_group=None,
                 pipeline_blocks: bool = False):
        _check_quantized_kv(paged, quantized_kv, draft_params,
                            prefill_chunk_size)
        _check_blocks(block_steps, pipeline_blocks, draft_params)
        self.sampling = sampling or SamplingConfig(greedy=True)
        _check_tp_spec(tp_group, draft_params, self.sampling)
        if draft_params is not None and draft_config is None:
            raise ValueError("draft_params requires draft_config")
        self.block_steps = max(block_steps, 1)
        # depth-2 block pipelining (batching.py:126-143): block N+1 is
        # dispatched from block N's device finals before block N's tokens
        # are read, so that the host's bookkeeping of N overlaps N+1 on the
        # device; only while nothing waits (admission flushes first)
        self.pipeline_blocks = bool(pipeline_blocks) and self.block_steps > 1
        self._pending: Optional[BlockOut] = None
        self._tp = None
        if tp_group is not None:
            # the rank's shards on its own device (batching.py:164-180)
            want = torch.device(device if device is not None
                                else tp_group.device)
            if want.type != tp_group.device.type or \
                    want.index not in (None, tp_group.device.index):
                raise ValueError(f"device {device} is not the tp_group's "
                                 f"device {tp_group.device}")
            self._tp = TPServing(tp_group, config, impl=impl,
                                 compute_dtype=compute_dtype,
                                 sampling=self.sampling,
                                 block_steps=self.block_steps,
                                 draft_config=draft_config, n_draft=n_draft)
            self.device = tp_group.device
            params = shard_tp_params(params, tp_group)
            if draft_params is not None:
                # the draft runs whole on every rank (batching.py:196-205)
                draft_params = tree_to(draft_params, self.device)
        else:
            self.device = resolve_device(device)
        self.params = params
        self.config = config
        # a tensor-parallel rank's cache holds its nkv / mp heads
        cache_at = dict(device=self.device, num_kv_heads=(
            None if self._tp is None else self._tp.num_kv_heads))
        self.max_batch = max_batch
        self.max_len = max_len
        self.impl = impl
        self.compute_dtype = compute_dtype
        self.paged = paged
        self.prefill_chunk_size = prefill_chunk_size
        # prefix caching is a paged feature; the JAX engine ignores it
        # without pages
        self.prefix_cache = bool(prefix_cache) and paged
        if paged:
            self.page_size = page_size
            self.max_pages_per_seq = -(-max_len // page_size)
            num_pages = num_pages or (max_batch * self.max_pages_per_seq + 1)
            self.cache = init_paged_kv_cache(config, num_pages, page_size,
                                             dtype=compute_dtype,
                                             quantized=quantized_kv,
                                             **cache_at)
            self.allocator = PageAllocator(num_pages)
            self.total_pages = num_pages - 1   # page 0 is the reserved null
            self.page_tables = np.zeros((max_batch, self.max_pages_per_seq),
                                        np.int32)
            # prefix caching: full prompt pages (below the first write
            # position, so read-only for good) keyed by a chained per-page
            # digest of the token prefix, shared through allocator refcounts
            self._prefix_map: "OrderedDict[bytes, int]" = OrderedDict()
            self._prefix_children: Dict[bytes, set] = {}
            self.prefix_hits = 0               # pages reused (metrics)
        elif quantized_kv == "int4":
            # nibble-packed pools: a quarter of the bf16 cache's bytes
            self.cache = init_quant_kv_cache_kt4(config, max_batch, max_len,
                                                 **cache_at)
        elif quantized_kv:
            # int8 transposed-K pools, half the bf16 cache's bytes
            self.cache = init_quant_kv_cache_kt(config, max_batch, max_len,
                                                **cache_at)
        else:
            self.cache = init_kv_cache(config, max_batch, max_len,
                                       dtype=compute_dtype, **cache_at)
        # speculative decoding: the draft's dense cache, slot for slot
        self.draft_params = draft_params
        self.draft_config = draft_config
        self.n_draft = n_draft
        self.spec_rounds = 0
        if draft_params is not None:
            self.draft_cache = init_kv_cache(draft_config, max_batch, max_len,
                                             dtype=compute_dtype,
                                             device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # the one stream every launch of this engine runs on, prefill,
        # eager steps and graph replays alike, whichever thread drives it:
        # step() and warmup() make it current (_bound)
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        self._graph = None
        if self.block_steps > 1 and self._tp is None and \
                self.device.type == "cuda":
            self._graph = BlockGraph(
                self._block, self.cache, max_batch, stream=self.stream,
                tables_shape=(self.page_tables.shape if paged else None),
                generator=None if self.sampling.greedy else self.generator)
        self._uid = itertools.count()
        self.waiting: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.row_pos = np.zeros(max_batch, np.int32)
        self.next_token = np.zeros(max_batch, np.int32)
        self.finished: Dict[int, Request] = {}
        self.total_tokens = 0
        self.total_requests = 0
        self.completed_requests = 0
        # prefill rows the model ran (padding included) and those the
        # prompts needed; decode blocks started; pipelines that an
        # admission flushed
        self.prefill_rows_run = 0
        self.prefill_rows_needed = 0
        self.blocks_dispatched = 0
        self.pipeline_flushes = 0
        self._lat_ttft = deque(maxlen=1024)
        self._lat_tpot = deque(maxlen=1024)

    # -- public API ---------------------------------------------------------
    def add_request(self, prompt: Sequence[int], max_new_tokens: int = 64,
                    on_token: Optional[Callable[[int], None]] = None,
                    on_done: Optional[Callable[[], None]] = None) -> int:
        total = len(prompt) + max_new_tokens
        if total > self.max_len:
            raise ValueError(f"request needs {total} > max_len {self.max_len}")
        req = Request(uid=next(self._uid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, on_token=on_token,
                      on_done=on_done, t_submit=time.perf_counter())
        self.waiting.append(req)
        self.total_requests += 1
        return req.uid

    def warmup(self, buckets=None) -> None:
        """Make ready ahead of the first request what this engine
        dispatches (batching.py:306-505). The port compiles no program:
        prefill runs eagerly, whatever the prompt ``buckets``. On the card
        with ``block_steps > 1`` this captures the decode block's graph (an
        eager block first, every row inactive: no slot is live before the
        first request, so it touches nothing a request reads); otherwise it
        does nothing."""
        if self._graph is not None:
            with self._bound():
                self._graph.capture(self.row_pos)

    def _bound(self):
        """A context in which the engine's device and stream are current."""
        stack = contextlib.ExitStack()
        if self.stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots) \
            or self._pending is not None

    def _flush_pending(self) -> None:
        """Emit the in-flight pipelined block's tokens (waits for that
        block only)."""
        if self._pending is None:
            return
        out, self._pending = self._pending, None
        self._emit_block(*out.fetch())

    def run(self) -> Dict[int, List[int]]:
        """Drive until all requests complete; returns uid -> generated."""
        while self.has_work():
            self.step()
        out = {uid: r.generated for uid, r in self.finished.items()}
        self.finished.clear()
        return out

    # -- scheduler ----------------------------------------------------------
    def step(self) -> None:
        with self._bound(), trace.span("engine.step"):
            self._admit()
            with trace.span("decode"):
                self._decode()

    def _admit(self) -> None:
        """Admit waiting requests into free slots (batching.py:534-672):
        take slots (:meth:`_take_slots`), prefill the planned admissions
        a bucket at a time, and sample every admitted row's first token."""
        with trace.span("admit") as sp:
            if self._pending is not None and self.waiting:
                # admission needs the host's view of the slots: land the
                # block in flight first
                self.pipeline_flushes += 1
                with trace.span("admit.flush"):
                    self._flush_pending()
            with trace.span("admit.reserve"):
                admitted, planned = self._take_slots()
            admitted += self._batched_prefill(planned)
            if not admitted:
                return
            if sp:
                sp.set(uids=[self.slots[slot].uid for slot, _ in admitted])
            with trace.span("admit.sample"):
                # one batched sample and one host read for the whole round
                toks = sample_token(torch.stack([lg for _, lg in admitted]),
                                    self.generator,
                                    self.sampling).cpu().numpy()
                for (slot, _), tok in zip(admitted, toks):
                    self._emit(slot, int(tok))

    def _take_slots(self):
        """Give waiting requests free slots, in order. Paged: reserve every
        page the request can need (its padded bucket and its generation),
        waiting while the pool is short and failing a request that can
        never fit; with prefix caching, hit pages are retained at lookup,
        and a request whose first page an admission of this round is about
        to prefill waits one round to share it. A chunked admission is
        prefilled here; returns ``(admitted, planned)``: those, with their
        logits, and the batched prefills still to run."""
        admitted, planned = [], []
        round_keys = set()   # first-page digests of this round's prefills
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            plen = len(req.prompt)
            bucket = min(_bucket(plen), self.max_len)
            if not self.paged:
                self._leave_queue()
                if self.prefill_chunk_size:
                    admitted.append((slot, self._chunked_admit(slot, req)))
                else:
                    planned.append((slot, req, plen, bucket, None))
                continue
            total_need = -(-max(bucket, plen + req.max_new_tokens)
                           // self.page_size)
            hit_pages = (self._prefix_lookup(req.prompt)
                         if self.prefix_cache else [])
            hits = len(hit_pages)
            if self.prefix_cache and plen > self.page_size and \
                    self._page_keys(req.prompt, 1)[0] in round_keys:
                self.allocator.release(hit_pages)
                break
            need = total_need - hits
            if total_need > self.total_pages:
                # can never be satisfied: fail this request, keep going
                self.allocator.release(hit_pages)
                self.waiting.pop(0)
                req.done = True
                self.finished[req.uid] = req
                continue
            if need > len(self.allocator.free) and self.prefix_cache:
                self._evict_prefix(need)
            if need > len(self.allocator.free):
                # backpressure: wait until decoding frees pages
                self.allocator.release(hit_pages)
                break
            self._leave_queue()
            table = np.zeros(self.max_pages_per_seq, np.int32)
            table[:hits] = hit_pages                   # already retained
            for i in range(hits, total_need):
                table[i] = self.allocator.alloc()
            self.page_tables[slot] = table
            self.prefix_hits += hits
            if not (hits or self.prefill_chunk_size):
                if self.prefix_cache and plen > self.page_size:
                    round_keys.add(self._page_keys(req.prompt, 1)[0])
                planned.append((slot, req, plen, bucket, table))
                continue
            admitted.append((slot, self._chunked_admit(slot, req, table,
                                                       hits)))
        return admitted, planned

    def _leave_queue(self) -> None:
        """The first waiting request leaves the queue for a slot: stamped,
        and its wait recorded as a span ``request.queue``."""
        req = self.waiting.pop(0)
        req.t_admit = time.perf_counter()
        trace.interval("request.queue", req.t_submit, req.t_admit,
                       uid=req.uid)

    def _chunked_admit(self, slot: int, req, table=None,
                       hits: int = 0) -> torch.Tensor:
        """Prefill an admitted request alone, in chunks, into its slot
        (batching.py:595-660): its dense row, or with ``table`` its pages,
        where ``hits`` prefix pages already hold the K/V of the first
        ``hits * page_size`` tokens, so only the suffix runs. Returns the
        logits of its last prompt token."""
        kw = dict(impl=self.impl, compute_dtype=self.compute_dtype)
        if table is None:
            chunk = self.prefill_chunk_size
            logits, self.cache = chunked_prefill_row(
                self.params, self.cache, req.prompt, slot, self.config,
                chunk_size=chunk, step_fn=self._chunk_step(req, False),
                **kw)
        else:
            chunk = min(self.prefill_chunk_size or 64, self.max_len)
            logits, self.cache = paged_chunked_prefill_row(
                self.params, self.cache, req.prompt, table, self.config,
                chunk_size=chunk, start=hits * self.page_size,
                step_fn=self._chunk_step(req, True), **kw)
            if self.prefix_cache:
                self._register_prefix(req.prompt, table)
        if self.draft_params is not None:
            # the draft replays the whole prompt into its own slot: prefix
            # sharing is the target's pages' alone
            chunked_prefill_row(self.draft_params, self.draft_cache,
                                req.prompt, slot, self.draft_config,
                                chunk_size=chunk, **kw)
        self.slots[slot] = req
        self.row_pos[slot] = len(req.prompt)
        return logits

    def _chunk_step(self, req, paged: bool):
        """The chunk program of ``req``'s chunked prefill (the
        tensor-parallel rank's, or the one-device ``chunk_append_row`` /
        ``paged_chunk_append_row``), each chunk counted in the prefill
        rows and recorded as a span ``admit.chunk``."""
        if self._tp is not None:
            inner = (self._tp.paged_chunk_append if paged
                     else self._tp.chunk_append)
        else:
            inner = functools.partial(
                paged_chunk_append_row if paged else chunk_append_row,
                config=self.config, impl=self.impl,
                compute_dtype=self.compute_dtype)

        def step(params, cache, ids, start, length, where):
            self.prefill_rows_run += len(ids)
            self.prefill_rows_needed += length
            with trace.span("admit.chunk") as sp:
                if sp:
                    sp.set(uid=req.uid, rows=len(ids), needed=length)
                return inner(params, cache, ids, start, length, where)
        return step

    def _batched_prefill(self, planned):
        """One ``prefill_rows`` (``paged_prefill_rows``) call per prompt
        bucket. The row count is padded to a power of two (at most
        ``max_batch``) by repeating entry 0, whose duplicate writes are
        identical."""
        admitted = []
        by_bucket: Dict[int, list] = {}
        for item in planned:
            by_bucket.setdefault(item[3], []).append(item)
        for bucket, group in by_bucket.items():
            r_pad = 1
            while r_pad < len(group):
                r_pad *= 2
            r_pad = min(r_pad, self.max_batch)
            ids = np.zeros((r_pad, bucket), np.int64)
            lens = np.zeros(r_pad, np.int64)
            rows = np.zeros(r_pad, np.int64)
            for j, (slot, req, plen, _, _) in enumerate(group):
                ids[j, :plen] = req.prompt
                lens[j] = plen
                rows[j] = slot
            for j in range(len(group), r_pad):
                ids[j], lens[j], rows[j] = ids[0], lens[0], rows[0]
            needed = sum(item[2] for item in group)
            self.prefill_rows_run += r_pad * bucket
            self.prefill_rows_needed += needed
            with trace.span("admit.prefill") as sp:
                if sp:
                    sp.set(bucket=bucket, rows=r_pad * bucket, needed=needed,
                           uids=[item[1].uid for item in group])
                logits = self._prefill_bucket(ids, lens, rows)
            for j, (slot, req, plen, _, table) in enumerate(group):
                if self.prefix_cache:
                    self._register_prefix(req.prompt, table)
                self.slots[slot] = req
                self.row_pos[slot] = plen
                admitted.append((slot, logits[j]))
        return admitted

    def _prefill_bucket(self, ids, lens, rows) -> torch.Tensor:
        """One bucket's ``prefill_rows`` (``paged_prefill_rows``) call
        over ``ids [R, bucket]`` into slots ``rows``, the draft's too;
        returns the logits of each row's last prompt token."""
        dev = self.device
        ids_t, lens_t = (torch.from_numpy(ids).to(dev),
                         torch.from_numpy(lens).to(dev))
        kw = dict(impl=self.impl, compute_dtype=self.compute_dtype)
        if self.paged:
            tables = torch.from_numpy(self.page_tables[rows]).to(dev)
            if self._tp is not None:
                logits, self.cache = self._tp.paged_prefill_rows(
                    self.params, self.cache, ids_t, lens_t, tables)
            else:
                logits, self.cache = paged_prefill_rows(
                    self.params, self.cache, ids_t, lens_t, tables,
                    self.config, **kw)
        else:
            rows_t = torch.from_numpy(rows).to(dev)
            if self._tp is not None:
                logits, self.cache = self._tp.prefill_rows(
                    self.params, self.cache, ids_t, lens_t, rows_t)
            else:
                logits, self.cache = prefill_rows(
                    self.params, self.cache, ids_t, lens_t, rows_t,
                    self.config, **kw)
        if self.draft_params is not None:
            # the draft's slots mirror the engine's (batching.py:723-758)
            prefill_rows(self.draft_params, self.draft_cache, ids_t,
                         lens_t, torch.from_numpy(rows).to(dev),
                         self.draft_config, **kw)
        return logits

    # -- prefix caching (paged only, batching.py:767-835) -------------------
    def _page_keys(self, prompt, n_pages: int) -> List[bytes]:
        """Chained per-page sha1 digests of the token prefix: key i commits
        to every token through page i."""
        ps = self.page_size
        h = hashlib.sha1()
        keys = []
        for i in range(n_pages):
            h.update(np.asarray(prompt[i * ps:(i + 1) * ps],
                                np.int64).tobytes())
            keys.append(h.digest())
        return keys

    def _prefix_lookup(self, prompt) -> List[int]:
        """The longest run of cached full prompt pages from page 0, each
        retained at lookup so that eviction cannot free it before the table
        is built. Capped at ``(plen-1)//ps`` pages: at least one prompt
        token is recomputed (its logits seed generation), and the page that
        holds it stays private, so shared pages are never written."""
        pages = []
        for key in self._page_keys(prompt,
                                   (len(prompt) - 1) // self.page_size):
            page = self._prefix_map.get(key)
            if page is None:
                break
            self._prefix_map.move_to_end(key)   # LRU touch
            self.allocator.retain(page)
            pages.append(page)
        return pages

    def _register_prefix(self, prompt, table) -> None:
        """Publish the row's full prompt pages; the cache holds its own
        reference, so a page outlives its request."""
        prev = None
        for i, key in enumerate(self._page_keys(
                prompt, len(prompt) // self.page_size)):
            if key not in self._prefix_map:
                self._prefix_map[key] = int(table[i])
                self.allocator.retain(int(table[i]))
                if prev is not None:
                    self._prefix_children.setdefault(prev, set()).add(key)
            prev = key

    def _evict_entry(self, key) -> None:
        """Evict one entry and its descendants (a child whose parent is
        gone can never be hit again, and would hold its page)."""
        for child in self._prefix_children.pop(key, ()):
            if child in self._prefix_map:
                self._evict_entry(child)
        page = self._prefix_map.pop(key, None)
        if page is not None:
            self.allocator.release([page])

    def _evict_prefix(self, pages_needed: int) -> None:
        """Drop least-recently-used entries whose page only the cache holds
        until ``pages_needed`` pages are free."""
        for key in list(self._prefix_map.keys()):
            if len(self.allocator.free) >= pages_needed:
                break
            page = self._prefix_map.get(key)
            if page is None:
                continue    # already evicted as someone's descendant
            if self.allocator.refcount.get(page, 0) == 1:
                self._evict_entry(key)

    def _decode(self) -> None:
        active = np.asarray([s is not None for s in self.slots])
        if not active.any():
            with trace.span("decode.flush"):
                self._flush_pending()
            return
        if self.draft_params is not None:
            self._decode_spec(active)
            return
        if self.block_steps > 1:
            self._decode_block(active)
            return
        tokens = torch.from_numpy(self.next_token[:, None].astype(np.int64)
                                  ).to(self.device)
        # paged: every row decodes; a free slot's all-zero table points it
        # at the null page 0, which no live row reads
        state = self.page_tables if self.paged else active
        if self._tp is not None and self.sampling.greedy:
            # the greedy tokens, without gathering the logits
            step = (self._tp.paged_greedy_step if self.paged
                    else self._tp.greedy_step)
            toks, self.cache = step(self.params, self.cache, tokens,
                                    self.row_pos, state)
            toks = toks.cpu().numpy()
        else:
            if self._tp is not None:
                step = self._tp.paged_step if self.paged else self._tp.step
                logits, self.cache = step(self.params, self.cache, tokens,
                                          self.row_pos, state)
            else:
                step = paged_decode_step if self.paged else ragged_decode_step
                logits, self.cache = step(
                    self.params, self.cache, tokens, self.row_pos, state,
                    self.config, impl=self.impl,
                    compute_dtype=self.compute_dtype)
            toks = sample_token(logits[:, 0], self.generator,
                                self.sampling).cpu().numpy()
        for slot in range(self.max_batch):
            if self.slots[slot] is None:
                continue
            self.row_pos[slot] += 1
            self._emit(slot, int(toks[slot]))

    def _decode_spec(self, active) -> None:
        """One speculative round (batching.py:897-964): up to n_draft+1
        tokens a row, EOS and budgets clamped on the device, and one read
        of the device for the emitted tokens, counts and new positions."""
        budget = np.asarray(
            [r.max_new_tokens - len(r.generated) if r is not None else 0
             for r in self.slots], np.int64)
        args = (self.params, self.draft_params, self.cache, self.draft_cache,
                self.next_token, self.row_pos, active, budget)
        kw = dict(n_draft=self.n_draft, impl=self.impl,
                  compute_dtype=self.compute_dtype)
        tables = self.page_tables if self.paged else None
        if self._tp is not None:
            # greedy only: the acceptance reads the per-shard argmaxes
            tp_args = (self.params, self.cache, self.draft_params,
                       self.draft_cache, self.next_token, self.row_pos)
            if self.paged:
                out = self._tp.paged_spec_round(*tp_args, tables, active,
                                                budget)
            else:
                out = self._tp.spec_round(*tp_args, active, budget)
        elif self.sampling.greedy:
            out = spec_decode_round(*args, self.config, self.draft_config,
                                    tables, **kw)
        else:
            out = spec_decode_round_sampled(
                *args, self.generator, self.config, self.draft_config, tables,
                sampling=self.sampling, **kw)
        emitted, n_emit, _, new_pos = out[:4]
        host = torch.cat([emitted, n_emit[:, None], new_pos[:, None]],
                         dim=1).cpu().numpy()
        self.spec_rounds += 1
        emitted, n_emit = host[:, :-2], host[:, -2]
        self.row_pos = host[:, -1].astype(np.int32)
        for slot in range(self.max_batch):
            for j in range(int(n_emit[slot])):
                if self.slots[slot] is None:
                    break   # finished inside the round (EOS clamped)
                self._emit(slot, int(emitted[slot, j]))

    # -- decode blocks (batching.py:966-1087) -------------------------------
    def _block(self, tok, pos, act, budget, tables):
        """One decode block on device tensors: ``(toks, valid, finals)``."""
        if self._tp is not None:
            if self.paged:
                out = self._tp.paged_block(self.params, self.cache, tok, pos,
                                           tables, act, budget,
                                           self.generator)
            else:
                out = self._tp.block(self.params, self.cache, tok, pos, act,
                                     budget, self.generator)
        else:
            kw = dict(sampling=self.sampling, n_steps=self.block_steps,
                      impl=self.impl, compute_dtype=self.compute_dtype)
            if self.paged:
                out = paged_decode_block(self.params, self.cache, tok, pos,
                                         tables, act, budget, self.generator,
                                         self.config, **kw)
            else:
                out = ragged_decode_block(self.params, self.cache, tok, pos,
                                          act, budget, self.generator,
                                          self.config, **kw)
        toks, valid, _, finals = out
        return toks, valid, finals

    def _dispatch_block(self, active, budget, chain=None) -> BlockOut:
        """Start one block: from the host's state, or ``chain``, the finals
        of the block in flight. On the card a graph replay (TP excepted);
        eager elsewhere."""
        tables = self.page_tables if self.paged else None
        self.blocks_dispatched += 1
        if self._graph is not None:
            if self.cache is not self._graph.cache:
                raise RuntimeError("the cache was replaced after the decode "
                                   "block's capture; the graph reads the "
                                   "captured one")
            return self._graph.dispatch(
                host=(self.next_token, self.row_pos, active, budget, tables),
                chain=chain)
        with trace.span("decode.inputs"):
            if chain is not None:
                tok, pos, done, budget_d = chain
                act = ~done
            else:
                dev = self.device
                tok, pos, budget_d = (torch.as_tensor(x, dtype=torch.long,
                                                      device=dev)
                                      for x in (self.next_token, self.row_pos,
                                                budget))
                act = torch.as_tensor(active, device=dev)
            if tables is not None:
                tables = torch.as_tensor(tables, device=self.device)
        # eager, the block's launches stand in for a replay
        with trace.span("decode.replay"):
            return BlockOut(*self._block(tok, pos, act, budget_d, tables))

    def _decode_block(self, active) -> None:
        """``block_steps`` tokens a row in one block, EOS and budgets
        enforced on the device: a finished row is frozen inside the block
        and its later steps come back invalid."""
        budget = np.asarray(
            [r.max_new_tokens - len(r.generated) if r is not None else 0
             for r in self.slots], np.int64)
        if not self.pipeline_blocks:
            self._emit_block(*self._dispatch_block(active, budget).fetch())
            return
        # "certainly more work", on the host's view, which lags one block:
        # a row whose remaining budget exceeds a block cannot finish in the
        # block in flight, so the next one is worth dispatching; without
        # this test every drain would end in an all-frozen block
        more = any(r is not None
                   and r.max_new_tokens - len(r.generated) > self.block_steps
                   for r in self.slots)
        prev = self._pending
        if prev is not None and not more:
            # the tail may end inside prev: land it, and finish unpipelined
            with trace.span("decode.flush"):
                self._flush_pending()
            return
        out = self._dispatch_block(
            active, budget, chain=None if prev is None else prev.finals)
        self._pending = None
        if prev is not None:
            # block N's bookkeeping while block N+1 runs on the device
            self._emit_block(*prev.fetch())
        if more:
            self._pending = out
        else:
            self._emit_block(*out.fetch())

    def _emit_block(self, toks, valid) -> None:
        """Bookkeeping of a block's ``toks`` and ``valid`` ``[n_steps, B]``
        a slot at a time; rows with an ``on_token`` callback keep the
        per-token path."""
        with trace.span("decode.emit"):
            now = time.perf_counter()
            for slot in range(self.max_batch):
                req = self.slots[slot]
                if req is None:
                    continue
                col = toks[:, slot][valid[:, slot]]
                if not len(col):
                    continue
                if req.on_token is not None:
                    for tok in col:
                        if self.slots[slot] is None:
                            break
                        self.row_pos[slot] += 1
                        self._emit(slot, int(tok))
                    continue
                seq = [int(t) for t in col]
                if not req.generated:
                    req.t_first_token = now
                req.generated.extend(seq)
                self.row_pos[slot] += len(seq)
                self.next_token[slot] = seq[-1]
                self.total_tokens += len(seq)
                self._maybe_finish(slot, seq[-1])

    def _emit(self, slot: int, tok: int) -> None:
        """Record one generated token: bookkeeping, streaming callback,
        throughput counters, completion check."""
        req = self.slots[slot]
        if not req.generated:
            req.t_first_token = time.perf_counter()
        req.generated.append(tok)
        self.next_token[slot] = tok
        self.total_tokens += 1
        if req.on_token:
            req.on_token(tok)
        self._maybe_finish(slot, tok)

    def metrics(self) -> Dict[str, float]:
        """Engine counters for a metrics endpoint. Paged, pages reserved
        (handed out: prompts and whole output budgets) stand beside pages
        written (those the live rows' positions fill)."""
        out = {
            "total_requests": self.total_requests,
            "completed_requests": self.completed_requests,
            "total_tokens": self.total_tokens,
            "queue_depth": len(self.waiting),
            "active_slots": sum(s is not None for s in self.slots),
            "max_batch": self.max_batch,
            "prefill_rows_run": self.prefill_rows_run,
            "prefill_rows_needed": self.prefill_rows_needed,
            "blocks_dispatched": self.blocks_dispatched,
            "pipeline_flushes": self.pipeline_flushes,
        }
        if self.paged:
            out["free_pages"] = len(self.allocator.free)
            out["total_pages"] = self.total_pages
            out["pages_reserved"] = self.total_pages - out["free_pages"]
            out["pages_written"] = sum(
                -(-int(self.row_pos[slot]) // self.page_size)
                for slot, req in enumerate(self.slots) if req is not None)
            if self.prefix_cache:
                out["prefix_cache_entries"] = len(self._prefix_map)
                out["prefix_pages_reused"] = self.prefix_hits
        if self._lat_ttft:
            q = np.quantile(np.asarray(self._lat_ttft), [0.5, 0.99])
            out["ttft_p50_s"], out["ttft_p99_s"] = float(q[0]), float(q[1])
        if self._lat_tpot:
            q = np.quantile(np.asarray(self._lat_tpot), [0.5, 0.99])
            out["tpot_p50_s"], out["tpot_p99_s"] = float(q[0]), float(q[1])
        return out

    def _maybe_finish(self, slot: int, tok: int) -> None:
        req = self.slots[slot]
        if req is None:
            return
        if tok == self.config.eos_token_id or \
                len(req.generated) >= req.max_new_tokens:
            req.done = True
            req.t_done = time.perf_counter()
            self._lat_ttft.append(req.t_first_token - req.t_submit)
            if len(req.generated) > 1:
                self._lat_tpot.append((req.t_done - req.t_first_token)
                                      / (len(req.generated) - 1))
            self.finished[req.uid] = req
            self.slots[slot] = None
            self.completed_requests += 1
            if self.paged:
                self.allocator.release(self.page_tables[slot])
                self.page_tables[slot] = 0
            if req.on_done:
                req.on_done()
