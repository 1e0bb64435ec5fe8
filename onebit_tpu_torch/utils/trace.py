"""The port's tracer: named spans at the boundaries of its layers, in memory.

Tracing is off by default. Off, :func:`span` is one test of a module flag
and returns a shared null context: no clock read, no allocation. On
(:func:`enable`), each span records its name, an id, the id of the span it
runs inside (a stack a thread), ``t0_ns`` and ``t1_ns`` on
``time.perf_counter_ns()`` and its attributes (request uids, rows, bucket
...), and :func:`record` hands them back as plain dicts. Nothing is written
to disk: a profiler already writes Chrome traces, and spans share its
timeline two ways:

* while a ``torch.profiler`` session is active, each span also enters
  ``record_function("onebit.<name>")``, so the profile carries it beside
  the kernels; outside a profile no ``record_function`` is made;
* :func:`enable` keeps one pair ``(perf_counter_ns, time_ns)``, and
  :func:`record` gives each span ``t0_wall_ns`` and ``t1_wall_ns`` on the
  wall clock the profiler's ``trace_start_ns()`` counts from.

While tracing is on, each cyclic garbage collection is a span ``host.gc``
(its generation and the objects it collected), so that a host stall it
causes is named as one. A span made with ``device=True`` also records a
CUDA event pair on the current stream at its edges (on a machine with a
card); :func:`record` turns the pair into ``device_ms``, waiting for the
end event.
"""

from __future__ import annotations

import gc
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

PREFIX = "onebit."

_on = False
_spans: List["_Span"] = []
_ids = itertools.count()
_local = threading.local()
_clock = (0, 0)          # (perf_counter_ns, time_ns) at enable()
_cuda = False
_gc_start: Optional[tuple] = None


class _Null:
    """The span of tracing off: does nothing, and is false."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


NULL = _Null()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "t0_ns", "t1_ns", "attrs",
                 "_device", "_events", "_rf")

    def __init__(self, name: str, attrs: Dict, device: bool):
        self.name, self.attrs, self._device = name, attrs, device
        self.id = next(_ids)
        self.parent = None
        self.t0_ns = self.t1_ns = 0
        self._events = self._rf = None

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        if self._device and _cuda:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _stack().pop()
        if _on:
            _spans.append(self)
        return False


def span(name: str, device: bool = False, **attrs):
    """A context that records one span named ``name`` while tracing is on
    (see the module's docstring); ``device=True`` adds its CUDA events. The
    null span of tracing off is false, so ``if sp: sp.set(...)`` computes
    attributes only when they are kept."""
    if not _on:
        return NULL
    return _Span(name, attrs, device)


def interval(name: str, t0: float, t1: float, **attrs) -> None:
    """Record a span that already happened, between two
    ``time.perf_counter()`` readings (a request's wait in the queue),
    inside no other span."""
    if not _on:
        return
    s = _Span(name, attrs, False)
    s.t0_ns, s.t1_ns = int(t0 * 1e9), int(t1 * 1e9)
    _spans.append(s)


def _on_gc(phase: str, info: Dict) -> None:
    global _gc_start
    if phase == "start":
        stack = _stack()
        _gc_start = (time.perf_counter_ns(),
                     stack[-1].id if stack else None)
        return
    if _gc_start is None:
        return
    s = _Span("host.gc", {"generation": info.get("generation"),
                          "collected": info.get("collected")}, False)
    s.t0_ns, s.parent = _gc_start
    s.t1_ns = time.perf_counter_ns()
    _gc_start = None
    _spans.append(s)


def enable() -> None:
    """Turn tracing on (keeping what was recorded), with its clock pair."""
    global _on, _clock, _cuda
    if _on:
        return
    # the first record_function of a process resolves its operator, about
    # a millisecond that would otherwise sit inside the first span's edge
    with torch.profiler.record_function(PREFIX + "enable"):
        pass
    _clock = (time.perf_counter_ns(), time.time_ns())
    _cuda = torch.cuda.is_available()
    gc.callbacks.append(_on_gc)
    _on = True


def disable() -> None:
    """Turn tracing off; what was recorded stays until :func:`reset`."""
    global _on, _gc_start
    if not _on:
        return
    _on = False
    _gc_start = None
    gc.callbacks.remove(_on_gc)


def reset() -> None:
    """Drop every recorded span."""
    global _gc_start
    _spans.clear()
    _gc_start = None


def record() -> List[Dict]:
    """The recorded spans in the order they ended, as dicts: ``name``,
    ``id``, ``parent``, ``t0_ns``, ``t1_ns`` (``perf_counter_ns``),
    ``t0_wall_ns``, ``t1_wall_ns`` (``time_ns``, the profiler's clock),
    ``attrs``, and ``device_ms`` for a span with CUDA events."""
    pc0, wall0 = _clock
    out = []
    for s in list(_spans):
        d = {"name": s.name, "id": s.id, "parent": s.parent,
             "t0_ns": s.t0_ns, "t1_ns": s.t1_ns,
             "t0_wall_ns": s.t0_ns - pc0 + wall0,
             "t1_wall_ns": s.t1_ns - pc0 + wall0, "attrs": dict(s.attrs)}
        if s._events is not None:
            s._events[1].synchronize()
            d["device_ms"] = s._events[0].elapsed_time(s._events[1])
        out.append(d)
    return out
