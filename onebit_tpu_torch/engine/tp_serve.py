"""``serve --tp N``: tensor-parallel ranks on this host behind one front end.

The counterpart of the JAX command's one TP engine over a mesh
(``onebit_tpu/cli.py:473-488``). The port's tensor parallelism is one
process a rank (``parallel/mesh.py``), so the launcher, :func:`serve_tp`,
starts N rank processes; each joins the group at its
:class:`~onebit_tpu_torch.parallel.mesh.RankAddress` (all from
``local_addresses``: a multi-host launch replaces that one source) and
builds ``ContinuousBatchingEngine(tp_group=...)`` from the same checkpoint
and flags (``cli.serve_engine``). Every rank must step on the same
requests in the same order, since each step's collectives pair up across
the ranks:

* stdin: the launcher reads every line first, as the JAX command does
  before ``eng.run()``, hands the same requests to every rank, and prints
  rank 0's completions in JAX's JSON lines;
* ``--http PORT``: rank 0 alone serves (``EngineServer``) over a
  :class:`FrontEngine`, which before each ``step()`` sends the requests
  added since the last one, in order and with their ``max_new_tokens``, to
  every other rank; so the uids agree everywhere. The other ranks loop
  (:func:`_follow`): receive, ``add_request``, ``step()``. They wait on a
  queue from the launcher, which waits without limit, never in a
  collective, so an idle server hits no process-group timeout. The
  launcher prints "serving on http://HOST:PORT" once rank 0 has bound.

A signal to the launcher (SIGINT, SIGTERM) stops rank 0's server, which
sends the other ranks a stop. A rank that fails takes the others down, as
``spawn_tp`` does: the launcher prints its traceback, ends every rank and
exits nonzero; meanwhile rank 0's engine thread, whose collectives fail
with the lost rank, answers 500. The ranks ignore SIGINT: the launcher
stops them.
"""

from __future__ import annotations

import os
import queue as queue_mod
import signal
import sys
import tempfile
import time
import traceback

import torch

from onebit_tpu_torch.parallel.mesh import (BACKENDS, join_group,
                                            local_addresses, rank_device)

# seconds a collective may wait: a step's all-reduces, never an idle server
COLLECTIVE_TIMEOUT = 1800.0
# seconds the ranks get to finish after a stop or a failed rank
GRACE = 10.0


def tp_backend(args) -> str:
    """``--tp-backend``, or its default: nccl under ``--device cuda``, gloo
    under ``--device cpu``. NCCL needs a card a rank; with fewer it exits
    naming the way out, and never switches to gloo on its own."""
    backend = args.tp_backend or ("nccl" if args.device == "cuda"
                                  else "gloo")
    if backend not in BACKENDS:
        raise SystemExit(f"--tp-backend must be one of {BACKENDS}")
    if backend == "nccl":
        if args.device != "cuda":
            raise SystemExit("--tp-backend nccl runs on cards: pass "
                             "--device cuda, or --tp-backend gloo")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < args.tp:
            raise SystemExit(
                f"--tp-backend nccl needs a card a rank: --tp {args.tp} on "
                f"{cards} card(s); pass --tp-backend gloo to share cards "
                f"(collectives through the host)")
    return backend


class FrontEngine:
    """Rank 0's engine as its ``EngineServer`` drives it: each ``step()``
    first sends the requests added since the last one to the other ranks
    (``send``), so that every rank steps on the same requests."""

    def __init__(self, engine, send):
        self.engine = engine
        self._send = send
        self._new = []

    def add_request(self, prompt, max_new_tokens: int = 64, on_token=None,
                    on_done=None) -> int:
        uid = self.engine.add_request(prompt, max_new_tokens=max_new_tokens,
                                      on_token=on_token, on_done=on_done)
        self._new.append((list(prompt), max_new_tokens))
        return uid

    def step(self) -> None:
        new, self._new = self._new, []
        self._send(("step", new))
        self.engine.step()

    def has_work(self) -> bool:
        return self.engine.has_work()

    def metrics(self) -> dict:
        return self.engine.metrics()


def _follow(eng, inbox) -> None:
    """A rank other than 0 under ``--http``: mirror rank 0's steps until a
    stop."""
    while True:
        msg = inbox.get()
        if msg[0] == "stop":
            return
        for prompt, max_new in msg[1]:
            eng.add_request(prompt, max_new_tokens=max_new)
        eng.step()


def _serve_http(eng, args, control, followers, report) -> None:
    """Rank 0 under ``--http``: the server over a :class:`FrontEngine`,
    until the launcher says stop or the engine thread fails."""
    from onebit_tpu_torch.cli import _load_tokenizer
    from onebit_tpu_torch.engine.server import EngineServer

    def send(msg):
        for q in followers:
            q.put(msg)

    tok = _load_tokenizer(args.tokenizer) if args.tokenizer else None
    server = EngineServer(FrontEngine(eng, send), tokenizer=tok)
    report(("bound", server.start(host=args.host, port=args.http)))
    try:
        while server.error is None:
            try:
                if control.get(timeout=0.5)[0] == "stop":
                    return
            except queue_mod.Empty:
                continue
        raise RuntimeError(f"rank 0's engine thread failed: {server.error}")
    finally:
        server.stop()
        send(("stop",))


def _rank_main(addr, args, backend, prompts, control, followers,
               results) -> None:
    """One rank of ``serve --tp``: join, build the engine, serve; report
    ``(rank, kind, payload)`` to the launcher."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)

    def report(msg):
        results.put((addr.rank, *msg))

    try:
        from onebit_tpu_torch.cli import serve_engine
        group = join_group(addr, backend=backend, device=args.device,
                           timeout=COLLECTIVE_TIMEOUT)
        try:
            eng = serve_engine(args, group.device, tp_group=group)
            if prompts is not None:
                uids = [eng.add_request(ids,
                                        max_new_tokens=args.max_new_tokens)
                        for _, ids in prompts]
                out = eng.run()
                report(("done", [out[u] for u in uids]
                        if addr.rank == 0 else None))
            elif addr.rank == 0:
                _serve_http(eng, args, control, followers, report)
                report(("done", None))
            else:
                _follow(eng, control)
                report(("done", None))
        finally:
            torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the launcher prints it
        report(("failed", traceback.format_exc()))


class _Stop(Exception):
    """SIGTERM to the launcher."""


def _raise_stop(signum, frame):
    raise _Stop()


def serve_tp(args) -> None:
    """The launcher: ``args.tp`` ranks of ``serve`` (see the module
    docstring); returns when they are done, exits nonzero when one
    fails."""
    from onebit_tpu_torch.cli import (_load_tokenizer, print_completions,
                                      read_prompts, serving_line)
    backend = tp_backend(args)
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
    controls = [ctx.Queue() for _ in range(args.tp)]
    previous = signal.signal(signal.SIGTERM, _raise_stop)
    with tempfile.TemporaryDirectory(prefix="onebit_tp_serve_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            addr, args, backend, prompts, controls[addr.rank],
            controls[1:] if addr.rank == 0 else None, results))
            for addr in local_addresses(args.tp, tmp)]
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
            controls[0].put(("stop",))
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
