"""Tensor-parallel process groups and their launcher.

Port of ``onebit_tpu/parallel/mesh.py`` ``create_mesh`` / ``MODEL_AXIS``
for the serving path. Where JAX runs one SPMD program over a mesh's
``model`` axis, the port runs one process per shard, each holding its
slices of the weights and of the KV heads, and the collectives of the
shard_map bodies become ``torch.distributed`` calls on a process group
(:class:`TPGroup`).

The backend and the device are always the caller's explicit choice, and
nothing here switches either on its own:

* ``nccl`` where every rank has a card of its own (``cuda:{rank}``);
* ``gloo`` otherwise: ranks on the CPU, or ranks that share one card (NCCL
  refuses two ranks on one device), whose collectives then pass through
  the host.

:func:`spawn_tp` starts the ranks on this host with the ``spawn`` start
method; they meet at a ``file://`` store in a fresh temporary directory,
not at a TCP port, so concurrent launches never collide.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# what the port's parallelism has yet to bring beyond tensor-parallel
# serving: data/model-parallel training, sharded checkpoints, memory plans
PARALLEL_WAIT = "the rest of parallelism (ROADMAP.md §1 item 8)"


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """One rank's view of a tensor-parallel group: the process group, this
    rank, the group's size ``mp`` and the device the rank's shards live
    on."""
    group: Any
    rank: int
    size: int
    device: torch.device

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order. Each
        rank puts its block into zeros and one all-reduce sums them: exact
        (``x + 0 = x``), and an all-reduce is the collective that every
        backend takes on CUDA tensors."""
        dim = dim % t.dim()
        blocks = torch.zeros((self.size, *t.shape), dtype=t.dtype,
                             device=t.device)
        blocks[self.rank] = t
        self.all_reduce(blocks)
        return torch.cat(blocks.unbind(0), dim=dim)


def rank_device(rank: int, device: str) -> torch.device:
    """``cuda:{rank % device_count}`` for ``device="cuda"``, else ``cpu``."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' to "
                           "run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def create_tp_group(mp: int, *, backend: str, device: str) -> TPGroup:
    """This process's :class:`TPGroup` over the default process group,
    which the caller has initialised with ``mp`` ranks on ``backend``
    (``torch.distributed.init_process_group``). Sets the current CUDA
    device of a CUDA rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group first (or use spawn_tp)")
    if dist.get_world_size() != mp:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, not mp={mp}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not "
                         f"the {backend} asked for")
    rank = dist.get_rank()
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return TPGroup(dist.group.WORLD, rank, mp, dev)


def _rank_main(rank: int, fn: Callable, mp: int, backend: str, device: str,
               store: str, timeout: float, args: Sequence,
               results) -> None:
    """One spawned rank: join the group, run ``fn(group, *args)``, report
    ``(rank, ok, result or traceback)``."""
    try:
        # every rank of a spawn_tp group runs on this host
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=mp, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            group = create_tp_group(mp, backend=backend, device=device)
            out = fn(group, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - the parent raises it
        results.put((rank, False, traceback.format_exc()))


def spawn_tp(fn: Callable, mp: int, *, backend: str, device: str,
             timeout: float, args: Sequence = ()) -> list:
    """Run ``fn(group, *args)`` in ``mp`` spawned ranks and return their
    results in rank order.

    ``fn`` must be a module-level function (the ranks import it) and its
    results picklable; return numpy arrays or Python values rather than
    tensors. Every rank joins within ``timeout`` seconds or the launch
    fails: ranks still running then are killed, and so are the others when
    one rank fails, whose traceback the raised ``RuntimeError`` carries."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    rank_device(0, device)              # fail here, not in every rank
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="onebit_tp_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(rank, fn, mp, backend, device,
                                   os.path.join(tmp, "store"), timeout, args,
                                   results), daemon=True)
                 for rank in range(mp)]
        for p in procs:
            p.start()
        out: dict = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < mp:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(mp)) - set(out))} did not "
                        f"finish within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {mp} failed:\n"
                                       f"{payload}")
                out[rank] = payload
        finally:
            grace = time.monotonic() + (10.0 if len(out) == mp else 0.0)
            for p in procs:
                p.join(timeout=max(grace - time.monotonic(), 0.0))
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(mp)]

