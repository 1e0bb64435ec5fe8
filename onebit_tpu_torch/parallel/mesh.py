"""Process groups of the two mesh axes, their launcher and the
distributed start-up.

Port of ``onebit_tpu/parallel/mesh.py``. Where JAX runs one SPMD program
over a ``(data, model)`` mesh, the port runs one process a rank, and the
collectives that GSPMD or the shard_map bodies insert become
``torch.distributed`` calls on a process group:

* :class:`TPGroup`, the ``model`` axis of tensor-parallel serving: each
  rank holds its slices of the weights and of the KV heads;
* :class:`DataGroup`, the ``data`` axis of fully sharded training
  (``parallel/sharding.py``): all-gather, reduce-scatter and all-reduce;
* :class:`Mesh2D`, one rank's place on a ``(data, model)`` mesh of
  training: its model group (a ``TPGroup`` of the ``m`` ranks that share
  its data index) and its data group (a ``DataGroup`` of the ``d`` ranks
  that share its model index), in JAX's rank order
  (``np.asarray(devices).reshape(shape)``): rank ``r`` at data index
  ``r // m`` and model index ``r % m``.

A group of one rank holds no process group, and its collectives return
their input: the sum or the concatenation over one rank.

The backend and the device are always the caller's explicit choice, and
nothing here switches either on its own:

* ``nccl`` where every rank has a card of its own (``cuda:{rank}``);
* ``gloo`` otherwise: ranks on the CPU, or ranks that share one card (NCCL
  refuses two ranks on one device), whose collectives then pass through
  the host.

:func:`spawn_tp` starts the ranks on this host with the ``spawn`` start
method; they meet at a ``file://`` store in a fresh temporary directory,
not at a TCP port, so concurrent launches never collide. Where a rank
joins is a :class:`RankAddress` (its rank, the group's size, the
rendezvous), from one of two sources: :func:`local_addresses` (the ranks of
one launch on this host, which ``spawn_tp`` and ``serve --tp`` start) or
:func:`flag_address` (this process's place in a multi-host launch, from
``--coordinator``/``--num-processes``/``--process-id`` or torchrun's
environment under ``--distributed``); :func:`join_group` joins one, and
:func:`initialize_distributed` is the multi-host start-up, the counterpart
of ``jax.distributed.initialize``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# the single-tensor collectives under their current names (torch 2.13
# deprecates the older ones, which torch 2.11 alone has)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


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
        if self.size > 1:
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


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of the data axis of fully sharded training: the
    process group, this rank, the axis' size and the rank's device. A
    shard is block ``rank`` of ``size`` along a tensor's first axis, so a
    gather is a concatenation along it. The collectives are the ones
    ZeRO-3 runs: gather a weight's shards at use, reduce-scatter its
    gradient, all-reduce what every rank holds whole. gloo takes all three
    on CUDA tensors (torch 2.11, probed on the H100 machine) as on CPU
    ones; a backend that refuses one raises."""
    group: Any
    rank: int
    size: int
    device: torch.device

    @classmethod
    def of(cls, group) -> "DataGroup":
        """The same ranks as another group view (a :class:`TPGroup`)."""
        return cls(group.group, group.rank, group.size, group.device)

    def all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's ``shard`` concatenated along axis 0, rank order."""
        if self.size == 1:
            return shard.clone(memory_format=torch.contiguous_format)
        shard = shard.contiguous()
        out = shard.new_empty((self.size * shard.shape[0], *shard.shape[1:]))
        _ALL_GATHER(out, shard, group=self.group)
        return out

    def reduce_scatter(self, full: torch.Tensor) -> torch.Tensor:
        """Block ``rank`` along axis 0 of the sum of every rank's
        ``full``."""
        if self.size == 1:
            return full
        full = full.contiguous()
        if full.shape[0] % self.size:
            raise ValueError(f"{full.shape[0]} rows do not split over "
                             f"{self.size} ranks")
        out = full.new_empty((full.shape[0] // self.size, *full.shape[1:]))
        _REDUCE_SCATTER(out, full, group=self.group)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """One rank's place on a ``(data, model)`` mesh: the shape, the rank
    in the launch, its data group (the ``data`` ranks that share its model
    index; group rank = data index) and its model group (the ``model``
    ranks that share its data index; group rank = model index)."""
    shape: Tuple[int, int]
    rank: int
    data: DataGroup
    model: TPGroup
    device: torch.device


def create_mesh(shape: Sequence[int], device: str) -> Mesh2D:
    """This process's :class:`Mesh2D` over the default process group,
    whose ``d·m`` ranks all call this (``new_group`` is collective: every
    rank makes every group, in one order). Sets a CUDA rank's device."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "initialize_distributed first")
    d, m = (int(x) for x in shape)
    world, rank = dist.get_world_size(), dist.get_rank()
    if d * m != world:
        raise ValueError(f"mesh shape {(d, m)} needs {d * m} ranks, the "
                         f"process group has {world}")
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    di, mj = divmod(rank, m)

    def mine(size: int, rows, want: int):
        if size == 1:
            return None
        if size == world:
            return dist.group.WORLD
        groups = [dist.new_group(list(r)) for r in rows]
        return groups[want]
    model = mine(m, [range(i * m, (i + 1) * m) for i in range(d)], di)
    data = mine(d, [range(j, world, m) for j in range(m)], mj)
    return Mesh2D((d, m), rank, DataGroup(data, di, d, dev),
                  TPGroup(model, mj, m, dev), dev)


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


@dataclasses.dataclass(frozen=True)
class RankAddress:
    """Where one rank joins its group: its rank, the group's size and the
    rendezvous (``torch.distributed``'s ``init_method``)."""
    rank: int
    world: int
    init_method: str


def local_addresses(world: int, store_dir: str) -> list:
    """The addresses of ``world`` ranks on this host, meeting at a file
    store in ``store_dir`` (a fresh directory a launch)."""
    store = "file://" + os.path.join(store_dir, "store")
    return [RankAddress(r, world, store) for r in range(world)]


def flag_address(coordinator: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None) -> RankAddress:
    """This process's place in a multi-host launch: ``coordinator``
    (``host:port`` of rank 0's store) with ``num_processes`` and
    ``process_id``, or without any of them torchrun's ``RANK`` and
    ``WORLD_SIZE`` at its ``MASTER_ADDR:MASTER_PORT`` (``env://``)."""
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator requires --num-processes and "
                             "--process-id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"--process-id {process_id} is not a rank of "
                             f"{num_processes}")
        return RankAddress(process_id, num_processes, f"tcp://{coordinator}")
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise ValueError(f"--distributed without --coordinator reads "
                         f"torchrun's environment; {missing} not set")
    return RankAddress(int(os.environ["RANK"]),
                       int(os.environ["WORLD_SIZE"]), "env://")


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: str,
                           timeout: float = 1800.0) -> RankAddress:
    """Multi-host start-up (``onebit_tpu/parallel/mesh.py:47-53``): join
    the default process group at :func:`flag_address`'s address on
    ``backend``, and return that address."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    addr = flag_address(coordinator, num_processes, process_id)
    _init(addr, backend, timeout)
    return addr


def _init(addr: RankAddress, backend: str, timeout: float) -> None:
    if addr.init_method.startswith("file://"):
        # a file store: every rank runs on this host
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        backend, init_method=addr.init_method, world_size=addr.world,
        rank=addr.rank, timeout=datetime.timedelta(seconds=timeout))


def join_group(addr: RankAddress, *, backend: str, device: str,
               timeout: float) -> TPGroup:
    """Join the default process group at ``addr`` and return this rank's
    :class:`TPGroup`; collectives wait ``timeout`` seconds at most."""
    _init(addr, backend, timeout)
    return create_tp_group(addr.world, backend=backend, device=device)


def _rank_main(addr: RankAddress, fn: Callable, backend: str, device: str,
               timeout: float, args: Sequence, results) -> None:
    """One spawned rank: join the group, run ``fn(group, *args)``, report
    ``(rank, ok, result or traceback)``."""
    try:
        try:
            group = join_group(addr, backend=backend, device=device,
                               timeout=timeout)
            out = fn(group, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        results.put((addr.rank, True, out))
    except BaseException:  # noqa: BLE001 - the parent raises it
        results.put((addr.rank, False, traceback.format_exc()))


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
                             args=(addr, fn, backend, device, timeout, args,
                                   results), daemon=True)
                 for addr in local_addresses(mp, tmp)]
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

