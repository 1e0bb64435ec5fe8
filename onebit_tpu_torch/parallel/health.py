"""Multi-host failure detection: heartbeats, and a barrier that says who
is missing.

Port of ``onebit_tpu/parallel/health.py``. The heartbeats are plain Python,
copied: each process runs a :class:`HeartbeatWriter` thread touching
``<dir>/<pid>.hb`` every ``interval`` on storage the hosts share, and any
process (or an outside supervisor) polls :class:`HeartbeatMonitor` for
peers whose file is older than ``timeout``. In-band collectives cannot
signal a failure, since a dead peer blocks them. On a detection the
deployment restarts from the last checkpoint, as training does.

:func:`barrier_sync` is a barrier of the default process group with a
watchdog: on gloo ``torch.distributed.monitored_barrier`` names the ranks
that did not arrive; on any backend a barrier that does not complete in
``timeout`` raises, with the stale heartbeats when a heartbeat directory is
given, instead of hanging.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional


class HeartbeatWriter:
    """Background thread stamping this process's liveness file."""

    def __init__(self, directory: str, process_id: int,
                 interval: float = 1.0, payload: Optional[dict] = None):
        self.directory = directory
        self.process_id = process_id
        self.interval = interval
        self.payload = payload or {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"{self.process_id}.hb")

    def beat(self) -> None:
        """One heartbeat: atomic write of timestamp + payload."""
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"t": time.time(), "pid": os.getpid(),
                       **self.payload}, f)
        os.replace(tmp, self.path)

    def start(self) -> "HeartbeatWriter":
        self.beat()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.beat()
            except OSError:
                pass   # transient shared-fs hiccup; next beat retries

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.interval + 1)


class HeartbeatMonitor:
    """Poll peers' heartbeat files; report stale (presumed-dead) hosts."""

    def __init__(self, directory: str, timeout: float = 5.0,
                 on_failure: Optional[Callable[[List[int]], None]] = None):
        self.directory = directory
        self.timeout = timeout
        self.on_failure = on_failure
        self._reported: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def ages(self) -> Dict[int, float]:
        """process_id → seconds since its last heartbeat."""
        now = time.time()
        out: Dict[int, float] = {}
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        for name in names:
            if not name.endswith(".hb"):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    out[int(name[:-3])] = now - json.load(f)["t"]
            except (OSError, ValueError, KeyError):
                continue   # mid-write or corrupt: skip this poll
        return out

    def stale(self) -> List[int]:
        return sorted(p for p, age in self.ages().items()
                      if age > self.timeout)

    def check(self) -> List[int]:
        """One poll; fires ``on_failure`` once per newly-dead process."""
        dead = self.stale()
        fresh = [p for p in dead if p not in self._reported]
        self._reported.update(fresh)
        if fresh and self.on_failure:
            self.on_failure(fresh)
        return dead

    def watch(self, poll_interval: float = 1.0) -> "HeartbeatMonitor":
        """Continuous background polling."""
        def loop():
            while not self._stop.wait(poll_interval):
                self.check()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


def barrier_sync(name: str = "barrier", timeout: float = 300.0,
                 heartbeat_dir: Optional[str] = None,
                 stale_after: float = 5.0) -> None:
    """A barrier over the default process group (every rank calls it)
    that fails rather than hangs: the barrier runs on a worker thread
    (``monitored_barrier`` on gloo, which raises naming the ranks that did
    not arrive; ``barrier`` elsewhere); if it fails, or has not completed
    within ``timeout`` seconds, this raises ``TimeoutError`` naming
    ``name``, what the barrier said, and, with ``heartbeat_dir``, the
    processes whose heartbeats are stale. One process without a group
    passes at once."""
    import datetime

    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    done = threading.Event()
    err: List[BaseException] = []

    def go():
        try:
            if dist.get_backend() == "gloo":
                dist.monitored_barrier(
                    timeout=datetime.timedelta(seconds=timeout))
            else:
                dist.barrier()
        except BaseException as e:   # surfaced to the caller below
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=go, daemon=True)
    t.start()
    # gloo's monitored barrier raises at ``timeout``, naming the ranks that
    # did not arrive; the watchdog gives it a second to do so
    finished = done.wait(timeout + 1.0)
    if finished and not err:
        return
    missing = ""
    if heartbeat_dir:
        stale = HeartbeatMonitor(heartbeat_dir, timeout=stale_after).stale()
        missing = f"; stale heartbeats: {stale}"
    if not finished:
        raise TimeoutError(
            f"barrier {name!r} did not complete in {timeout}s{missing}")
    raise TimeoutError(f"barrier {name!r} failed: {err[0]}{missing}"
                       ) from err[0]
