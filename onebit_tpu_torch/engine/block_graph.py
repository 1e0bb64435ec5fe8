"""Decode blocks as CUDA graphs.

On the card the engine runs a decode block (``block_steps`` decode+sample
steps, ``model/ragged_decode.py`` ``ragged_decode_block`` or
``engine/paged.py`` ``paged_decode_block``) as one captured CUDA graph that
it replays: the port's counterpart of the JAX engine's one jitted
``lax.scan`` a block. Nothing in the JAX package corresponds to this
module; it stands in for ``jax.jit``.

A :class:`BlockGraph` captures one block function over static device
buffers, the inputs (token, position, active, budget and, paged, the page
tables) and the outputs (tokens, valid mask, finals). A dispatch copies the
new inputs in, from the host or from the last block's finals on the
device, and replays the graph on the engine's stream. What it sees to:

* launch counts: each kernel wrapper counts its launch in Python, which
  runs at capture only. The capture's own counts are taken back out, and
  every replay adds what the capture recorded, to ``launches`` and to
  ``graph_launches`` (``kernels/bitlinear_cuda.py`` ``KernelInfo``);
* ticket counters: the kernels of a decode step share one buffer a device
  (``bitlinear_cuda.counters``), which grows by replacement. The eager
  block before capture grows it to what the block's launches take, and
  the graph keeps the buffer it baked in alive. Replays run on the
  engine's one stream, never beside another launch of those kernels;
* work done once: an eager block on the capture stream before capture
  loads every library and sets every kernel's attributes, with all rows
  inactive (a row is written only where its next step writes; paged rows
  on the null page) and the generator's state restored after it;
* static outputs: a dispatch copies the block's tokens and valid mask to
  pinned host memory behind the replay, into one of two buffers, and
  records an event; the next replay may then overwrite the device outputs
  while the host reads the last block's;
* the cache: the graph bakes in its pointers, so the engine checks at
  every dispatch that its cache is the one captured (it updates the cache
  in place and never rebinds it);
* sampling: a sampled block registers the engine's generator with the
  graph (``CUDAGraph.register_generator_state``), so each replay draws new
  numbers;
* garbage: an engine and its graph hold each other, so a dropped engine's
  graph waits for Python's cyclic collector, and freeing a graph while a
  stream captures invalidates the capture. The capture collects first and
  keeps the collector off until it ends.

A capture that fails raises: the engine never runs a block step by step in
its place.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from onebit_tpu_torch.kernels import (attention_cuda, bitlinear_cuda,
                                      kv_attention_cuda, paged_attention_cuda)
from onebit_tpu_torch.utils import trace

KERNELS = (bitlinear_cuda.KERNELS + kv_attention_cuda.KERNELS
           + paged_attention_cuda.KERNELS + attention_cuda.KERNELS)


@dataclasses.dataclass
class BlockOut:
    """One dispatched block: ``toks`` and ``valid`` ``[n_steps, B]`` (on the
    device, or pinned host copies that ``event`` completes) and the finals
    ``(tok, pos, done, budget)`` on the device. A graph's block is the
    ``replay``-th of ``graph``, whose host buffers alternate: fetch it
    before the graph's next replay but one."""
    toks: torch.Tensor
    valid: torch.Tensor
    finals: tuple
    event: Optional[torch.cuda.Event] = None
    graph: Optional["BlockGraph"] = None
    replay: int = 0

    def fetch(self):
        """``(toks, valid)`` as numpy arrays of their own."""
        if self.graph is not None and self.graph.replays > self.replay + 1:
            raise RuntimeError("a block's host buffers were reused by the "
                               "replay after next: fetch a block before "
                               "dispatching two more")
        with trace.span("decode.wait"):
            if self.event is not None:
                self.event.synchronize()
            return (self.toks.cpu().numpy().copy(),
                    self.valid.cpu().numpy().copy())


class BlockGraph:
    """One decode block over ``cache``, captured once and replayed.

    ``block(tok, pos, act, budget, tables)`` runs the block eagerly on
    device tensors (``tables`` None for a dense cache) and returns
    ``(toks, valid, finals)``. ``generator``: the sampler's, for a sampled
    block (None when greedy)."""

    def __init__(self, block: Callable, cache: Sequence[torch.Tensor],
                 batch: int, *, stream: torch.cuda.Stream,
                 tables_shape: Optional[tuple] = None,
                 generator: Optional[torch.Generator] = None):
        self.block = block
        self.cache = cache
        self.device = cache[0].device
        self.stream = stream
        self.generator = generator

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        # tok, pos, act, budget
        self.inputs = (zeros(batch, torch.long), zeros(batch, torch.long),
                       zeros(batch, torch.bool), zeros(batch, torch.long))
        self.tables = (None if tables_shape is None
                       else zeros(tables_shape, torch.int32))
        self.graph = None
        self.out = None
        self.per_replay = {}     # kernel name -> launches a replay
        self.replays = 0
        self.capture_s = self.instantiate_s = self.pool_bytes = None

    def _run(self):
        return self.block(*self.inputs, self.tables)

    def capture(self, pos=None) -> None:
        """Capture the block (once). ``pos``: the rows' positions on the
        host, where the eager block before capture writes its inactive rows
        (the next step writes there first); zeros when no row is live."""
        if self.graph is not None:
            return
        dev = self.device
        if pos is not None:
            self.inputs[1].copy_(torch.as_tensor(np.asarray(pos)))
        self.inputs[2].zero_()
        self.inputs[3].zero_()
        if self.tables is not None:
            self.tables.zero_()          # inactive rows on the null page
        side = torch.cuda.Stream(dev)
        side.wait_stream(self.stream)
        state = None if self.generator is None else self.generator.get_state()
        with torch.cuda.stream(side):
            self._run()
        if state is not None:
            self.generator.set_state(state)
        torch.cuda.synchronize(dev)
        # the eager block grew the ticket counters to what its launches
        # take; the graph bakes in this buffer
        self._counters = bitlinear_cuda.counters(dev, 0)

        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    "a sampled decode block needs "
                    "torch.cuda.CUDAGraph.register_generator_state, which "
                    f"torch {torch.__version__} lacks: serve greedy, or "
                    "with block_steps=1")
            register(self.generator)
        before = [k.launches for k in KERNELS]
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=side):
                out = self._run()
                t1 = time.perf_counter()
        finally:
            if collecting:
                gc.enable()
            for k, n in zip(KERNELS, before):
                if k.launches != n:
                    self.per_replay[k.name] = k.launches - n
                k.launches = n
        self.instantiate_s = time.perf_counter() - t1
        self.capture_s = t1 - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self.out = graph, out
        self._host = [tuple(torch.empty(x.shape, dtype=x.dtype,
                                        pin_memory=True) for x in out[:2])
                      for _ in range(2)]

    def dispatch(self, host=None, chain=None) -> BlockOut:
        """Replay the block on the engine's stream, its inputs ``host =
        (tok, pos, act, budget, tables)`` (numpy; ``tables`` None when
        dense) or ``chain``, the finals of the block before (the page tables
        stay the last host dispatch's: only admission changes them, and
        admission flushes the pipeline). Captures first if need be."""
        if self.graph is None:
            self.capture(None if host is None else host[1])
        tok, pos, act, budget = self.inputs
        toks, valid = self._host[self.replays % 2]
        with torch.cuda.stream(self.stream):
            with trace.span("decode.inputs"):
                if chain is not None:
                    tok_f, pos_f, done_f, budget_f = chain
                    tok.copy_(tok_f)
                    pos.copy_(pos_f)
                    act.copy_(~done_f)
                    budget.copy_(budget_f)
                else:
                    for buf, value in zip(self.inputs, host[:4]):
                        buf.copy_(torch.from_numpy(np.asarray(value)))
                    if self.tables is not None:
                        self.tables.copy_(
                            torch.from_numpy(np.asarray(host[4])))
            with trace.span("decode.replay"):
                self.graph.replay()
                toks.copy_(self.out[0], non_blocking=True)
                valid.copy_(self.out[1], non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.stream)
        self.replays += 1
        for k in KERNELS:
            n = self.per_replay.get(k.name, 0)
            k.launches += n
            k.graph_launches += n
        return BlockOut(toks, valid, self.out[2], event, self, self.replays)
