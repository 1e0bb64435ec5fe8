"""``serve --tp N``: tensor-parallel ranks behind one front end.

The counterpart of the JAX command's one TP engine over a mesh
(``onebit_tpu/cli.py:473-488``). The port's tensor parallelism is one
process a rank (``parallel/mesh.py``). Every rank runs :func:`rank_main`
at its :class:`~onebit_tpu_torch.parallel.mesh.RankAddress`: it joins the
group, builds ``ContinuousBatchingEngine(tp_group=...)`` from the same
checkpoint and flags (``cli.serve_engine``) and serves. The address comes
from one of two sources:

* ``local_addresses``: the launcher, :func:`serve_tp`, starts the N ranks
  on this host, reads stdin for rank 0, prints what rank 0 reports and
  watches the ranks;
* ``flag_address``: a multi-host launch (``--coordinator``/
  ``--num-processes``/``--process-id``, or ``--distributed``) runs the
  same command in N processes, and :func:`serve_rank` runs this one as
  rank ``--process-id``.

Rank 0 is the front end. Every rank must step on the same requests in the
same order, since each step's collectives pair up across the ranks, so
rank 0 passes the requests on through the group's store
(:class:`StoreChannel`):

* stdin: rank 0 sends every line at once, as the JAX command reads them
  all before ``eng.run()``; every rank runs them, and rank 0's completions
  come out in JAX's JSON lines;
* ``--http PORT``: rank 0 serves (``EngineServer``) over a
  :class:`FrontEngine`. While the other ranks have no work they wait on the
  store, without limit and never in a collective, so an idle server hits
  no process-group timeout; rank 0's next step sends them its new requests
  there. While they have work, each step starts with one all-reduce of a
  code from rank 0 (:func:`_ticker`): step on, read the new requests from
  the store first, or stop. So the store carries a message only for new
  requests and for the stop, and each rank deletes its copy once read.

A signal to rank 0 (SIGINT, SIGTERM; the launcher passes its own on as
SIGTERM) stops its server, which stops the other ranks. A rank that fails
takes the others down, as ``spawn_tp`` does: the launcher prints its
traceback, ends every rank and exits nonzero; meanwhile rank 0's engine
thread, whose collectives fail with the lost rank, answers 500. The
launcher's ranks ignore SIGINT: the launcher stops them.
"""

from __future__ import annotations

import datetime
import gc
import os
import pickle
import queue as queue_mod
import signal
import sys
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

from onebit_tpu_torch.parallel.mesh import (BACKENDS, flag_address,
                                            join_group, local_addresses,
                                            rank_device)

# seconds a collective may wait: a step's all-reduces, never an idle server
COLLECTIVE_TIMEOUT = 1800.0
# seconds the ranks get to finish after a stop or a failed rank
GRACE = 10.0
# a step's code from rank 0 (_ticker): step on, read new requests first,
# stop
STEP, NEW, STOP = 0, 1, -1


def tp_backend(args, local_ranks: int) -> str:
    """``--tp-backend``, or its default: nccl under ``--device cuda``, gloo
    under ``--device cpu``. NCCL needs a card a rank: with fewer cards than
    the ``local_ranks`` of this host it exits naming the way out, and never
    switches to gloo on its own."""
    backend = args.tp_backend or ("nccl" if args.device == "cuda"
                                  else "gloo")
    if backend not in BACKENDS:
        raise SystemExit(f"--tp-backend must be one of {BACKENDS}")
    if backend == "nccl":
        if args.device != "cuda":
            raise SystemExit("--tp-backend nccl runs on cards: pass "
                             "--device cuda, or --tp-backend gloo")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < local_ranks:
            raise SystemExit(
                f"--tp-backend nccl needs a card a rank: {local_ranks} "
                f"rank(s) of --tp {args.tp} on {cards} card(s); pass "
                f"--tp-backend gloo to share cards (collectives through the "
                f"host)")
    return backend


class StoreChannel:
    """Rank 0's messages to the other ranks, through a key-value store
    (the default group's): ``put`` sets the next message under one key for
    each other rank; ``get`` waits for this rank's next key without limit
    (an idle rank waits here, not in a collective), reads it and deletes
    it, so the store holds only messages not yet read. A store that fails
    for another reason than a wait's timeout, as when rank 0 is gone,
    raises."""

    POLL = datetime.timedelta(seconds=30)

    def __init__(self, store, rank: int, world: int,
                 prefix: str = "onebit_serve"):
        self.store = store
        self.rank = rank
        self.world = world
        self.prefix = prefix
        self.count = 0

    def _key(self, rank: int) -> str:
        return f"{self.prefix}/{rank}/{self.count}"

    def put(self, msg) -> None:
        data = pickle.dumps(msg)
        for r in range(1, self.world):
            self.store.set(self._key(r), data)
        self.count += 1

    def get(self):
        key = self._key(self.rank)
        while True:
            try:
                self.store.wait([key], self.POLL)
                break
            except RuntimeError as e:
                if "timeout" not in str(e).lower():
                    raise
        data = self.store.get(key)
        self.store.delete_key(key)
        self.count += 1
        # bytes that rank 0 of this launch wrote
        return pickle.loads(data)


def _ticker(group):
    """A step's code from rank 0 to every rank: one all-reduce of an
    integer that only rank 0 sets (on the CPU under gloo)."""
    dev = (torch.device("cpu") if dist.get_backend(group.group) == "gloo"
           else group.device)

    def tick(code: int) -> int:
        t = torch.tensor([code if group.rank == 0 else 0], dtype=torch.int32,
                         device=dev)
        dist.all_reduce(t, group=group.group)
        return int(t.item())
    return tick


class FrontEngine:
    """Rank 0's engine as its ``EngineServer`` drives it: each ``step()``
    first passes the requests added since the last one to the other ranks,
    so that every rank steps on the same requests: on the store (``put``)
    while they wait without work, else with the step's code (``tick``),
    after a ``put`` where there are new ones. :meth:`stop` ends the other
    ranks; no step runs after it."""

    def __init__(self, engine, put, tick):
        self.engine = engine
        self._put = put
        self._tick = tick
        self._new = []
        self._busy = False          # the other ranks have work
        self._stopped = False
        self._lock = threading.Lock()

    def add_request(self, prompt, max_new_tokens: int = 64, on_token=None,
                    on_done=None) -> int:
        uid = self.engine.add_request(prompt, max_new_tokens=max_new_tokens,
                                      on_token=on_token, on_done=on_done)
        self._new.append((list(prompt), max_new_tokens))
        return uid

    def step(self) -> None:
        with self._lock:
            if self._stopped:
                return
            new, self._new = self._new, []
            if new or not self._busy:
                self._put(("step", new))
            if self._busy:
                self._tick(NEW if new else STEP)
            self.engine.step()
            self._busy = self.engine.has_work()

    def stop(self) -> None:
        with self._lock:
            if not self._stopped:
                self._stopped = True
                if self._busy:
                    self._tick(STOP)
                else:
                    self._put(("stop",))

    def has_work(self) -> bool:
        return self.engine.has_work()

    def metrics(self) -> dict:
        return self.engine.metrics()


def _follow(eng, channel, tick) -> None:
    """A rank other than 0 under ``--http``: mirror rank 0's steps until a
    stop (see :class:`FrontEngine`)."""
    busy = False
    while True:
        if busy:
            code = tick(0)
            msg = (("stop",) if code == STOP else channel.get()
                   if code == NEW else ("step", []))
        else:
            msg = channel.get()
        if msg[0] == "stop":
            return
        for prompt, max_new in msg[1]:
            eng.add_request(prompt, max_new_tokens=max_new)
        eng.step()
        busy = eng.has_work()


class _Stop(Exception):
    """SIGTERM to the process."""


def _raise_stop(signum, frame):
    raise _Stop()


def _front(eng, args, channel, tick, announce) -> None:
    """Rank 0 under ``--http``: the server over a :class:`FrontEngine`,
    ``announce(port)`` once bound, until SIGINT or SIGTERM (then the other
    ranks stop too) or until the engine thread fails (raises)."""
    from onebit_tpu_torch.cli import _load_tokenizer
    from onebit_tpu_torch.engine.server import EngineServer
    tok = _load_tokenizer(args.tokenizer) if args.tokenizer else None
    front = FrontEngine(eng, channel.put, tick)
    server = EngineServer(front, tokenizer=tok)
    previous = signal.signal(signal.SIGTERM, _raise_stop)
    stopped = False
    try:
        announce(server.start(host=args.host, port=args.http))
        while server.error is None:
            time.sleep(0.5)
    except (KeyboardInterrupt, _Stop):
        stopped = True
    finally:
        signal.signal(signal.SIGTERM, previous)
        server.stop()
    if not stopped:
        raise RuntimeError(f"rank 0's engine thread failed: {server.error}")
    front.stop()


def rank_main(addr, args, backend: str, prompts=None, announce=None):
    """One rank of ``serve --tp N`` at ``addr`` (see the module docstring).
    On stdin, rank 0 takes ``prompts`` (``read_prompts``' pairs) and
    returns their completions; under ``--http`` it calls ``announce(port)``
    once bound and serves until a signal. The other ranks take neither and
    return None."""
    from onebit_tpu_torch.cli import serve_engine
    group = join_group(addr, backend=backend, device=args.device,
                       timeout=COLLECTIVE_TIMEOUT)
    try:
        eng = serve_engine(args, group.device, tp_group=group)
        channel = StoreChannel(dist.distributed_c10d._get_default_store(),
                               group.rank, group.size)
        tick = _ticker(group)
        if args.http is None:
            if group.rank == 0:
                channel.put(prompts)
            else:
                prompts = channel.get()
            uids = [eng.add_request(ids, max_new_tokens=args.max_new_tokens)
                    for _, ids in prompts]
            out = eng.run()
            return [out[u] for u in uids] if group.rank == 0 else None
        if group.rank == 0:
            _front(eng, args, channel, tick, announce)
        else:
            _follow(eng, channel, tick)
        tick(STEP)      # rank 0's store outlives every rank's last read
        return None
    finally:
        # the stopped server is a reference cycle that holds the store:
        # free it now, so that the store ends with the group and not while
        # the process exits
        gc.collect()
        dist.destroy_process_group()


def _local_rank(addr, args, backend, prompts, results) -> None:
    """A rank process of :func:`serve_tp`: :func:`rank_main`, reporting
    ``(rank, kind, payload)`` to the launcher."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)

    def report(*msg):
        results.put((addr.rank, *msg))

    try:
        report("done", rank_main(addr, args, backend, prompts,
                                 lambda port: report("bound", port)))
    except BaseException:  # noqa: BLE001 - the launcher prints it
        report("failed", traceback.format_exc())


def serve_tp(args) -> None:
    """The launcher: ``args.tp`` ranks of :func:`rank_main` on this host;
    prints rank 0's serving line or completions, returns when the ranks
    are done, exits nonzero when one fails."""
    from onebit_tpu_torch.cli import (_load_tokenizer, print_completions,
                                      read_prompts, serving_line)
    backend = tp_backend(args, args.tp)
    rank_device(0, args.device)           # fail here, not in every rank
    for path in filter(None, (args.ckpt, args.draft)):
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint directory at {path}")
    tok = None
    prompts = None
    if args.http is None:
        tok = _load_tokenizer(args.tokenizer) if args.tokenizer else None
        prompts = read_prompts(sys.stdin, tok)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    previous = signal.signal(signal.SIGTERM, _raise_stop)
    with tempfile.TemporaryDirectory(prefix="onebit_tp_serve_") as tmp:
        procs = [ctx.Process(target=_local_rank, daemon=True, args=(
            addr, args, backend, prompts if addr.rank == 0 else None,
            results)) for addr in local_addresses(args.tp, tmp)]
        for p in procs:
            p.start()
        done, failure, tokens, stopped = set(), None, None, False
        try:
            while len(done) < args.tp and failure is None:
                try:
                    rank, kind, payload = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    continue
                if kind == "bound":
                    print(serving_line(args.host, payload), flush=True)
                elif kind == "failed":
                    failure = f"rank {rank} of {args.tp} failed:\n{payload}"
                else:
                    done.add(rank)
                    tokens = payload if rank == 0 else tokens
        except (KeyboardInterrupt, _Stop):
            stopped = True
            if procs[0].is_alive():
                os.kill(procs[0].pid, signal.SIGTERM)
        finally:
            signal.signal(signal.SIGTERM, previous)
            deadline = time.monotonic() + GRACE
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 0.0))
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise SystemExit(f"serve --tp: {failure}")
    if prompts is not None and not stopped:
        print_completions(prompts, tokens, tok)


def serve_rank(args) -> None:
    """This process as rank ``--process-id`` of a multi-host ``serve --tp
    N`` (see the module docstring): ``--num-processes`` must be N. Rank 0
    reads the prompts and prints their completions, or serves HTTP and
    prints its serving line."""
    from onebit_tpu_torch.cli import (_load_tokenizer, print_completions,
                                      read_prompts, serving_line)
    try:
        addr = flag_address(args.coordinator, args.num_processes,
                            args.process_id)
    except ValueError as e:
        raise SystemExit(str(e))
    if addr.world != args.tp:
        raise SystemExit(f"--num-processes {addr.world} must equal --tp "
                         f"{args.tp}: each process is one tensor-parallel "
                         f"rank")
    backend = tp_backend(args, 1)
    tok = prompts = None
    if addr.rank == 0 and args.http is None:
        tok = _load_tokenizer(args.tokenizer) if args.tokenizer else None
        prompts = read_prompts(sys.stdin, tok)
    out = rank_main(addr, args, backend, prompts, lambda port: print(
        serving_line(args.host, port), flush=True))
    if prompts is not None:
        print_completions(prompts, out, tok)
