"""Heartbeats and the watched barrier of the port
(``parallel/health.py``): the five cases of ``tests/test_health.py``, the
barrier on ``torch.distributed`` in place of JAX's multihost sync."""

import time

import pytest
import torch.distributed as dist

from onebit_tpu_torch.parallel.health import (HeartbeatMonitor,
                                              HeartbeatWriter, barrier_sync)


def test_heartbeat_live_and_dead(tmp_path):
    d = str(tmp_path)
    w0 = HeartbeatWriter(d, 0, interval=0.05).start()
    w1 = HeartbeatWriter(d, 1, interval=0.05).start()
    mon = HeartbeatMonitor(d, timeout=0.5)
    time.sleep(0.15)
    assert set(mon.ages()) == {0, 1}
    assert mon.stale() == []
    # process 1's writer stops: it goes stale, 0 stays live
    w1.stop()
    time.sleep(0.7)
    assert mon.stale() == [1]
    w0.stop()


def test_on_failure_fires_once(tmp_path):
    d = str(tmp_path)
    HeartbeatWriter(d, 7, interval=10.0).beat()
    events = []
    mon = HeartbeatMonitor(d, timeout=0.1, on_failure=events.append)
    time.sleep(0.2)
    assert mon.check() == [7]
    assert mon.check() == [7]     # still dead...
    assert events == [[7]]        # ...but reported exactly once


def test_monitor_watch_thread(tmp_path):
    d = str(tmp_path)
    HeartbeatWriter(d, 3, interval=10.0).beat()
    events = []
    mon = HeartbeatMonitor(d, timeout=0.1, on_failure=events.append)
    mon.watch(poll_interval=0.05)
    time.sleep(0.4)
    mon.stop()
    assert events == [[3]]


def test_barrier_sync_single_process():
    """One process, no group: the barrier passes at once."""
    assert not dist.is_initialized()
    barrier_sync("test", timeout=30.0)


def test_barrier_sync_timeout_reports_stale(tmp_path, monkeypatch):
    """A barrier whose peers never arrive raises after ``timeout`` with the
    stale heartbeats, instead of hanging."""
    d = str(tmp_path)
    HeartbeatWriter(d, 5, interval=10.0).beat()
    time.sleep(0.2)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    monkeypatch.setattr(dist, "barrier", lambda: time.sleep(10))
    with pytest.raises(TimeoutError, match=r"stale heartbeats: \[5\]"):
        barrier_sync("b", timeout=0.3, heartbeat_dir=d, stale_after=0.1)
