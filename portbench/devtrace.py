"""Spans, counters and the device trace of a traced run.

The harness's spans are taken from its own files around its calls into the
program: :func:`wrap` replaces a method on one instance by a wrapper that
records the call's host interval (and, while the profiler runs, marks it
with ``record_function`` so that idle gaps on the device can be labelled by
what the host was doing). :func:`device_summary` reduces a
``torch.profiler`` window: device time by kernel name (a frozen copy of
``chip_smoke.py``'s ``_device_ms`` summing), the union of busy intervals,
and the longest idle gaps by the span they fell in.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

SPAN_PREFIX = "portbench."


class Spans:
    """Host intervals of named calls, and their record_function labels."""

    def __init__(self):
        self.intervals: Dict[str, List[Tuple[float, float]]] = {}
        self.labelled = False          # mark spans for the profiler

    def add(self, name: str, t0: float, t1: float) -> None:
        self.intervals.setdefault(name, []).append((t0, t1))

    def seconds(self, name: str, t0: float = float("-inf"),
                t1: float = float("inf")) -> float:
        """Seconds of ``name``'s spans that started in ``[t0, t1)``."""
        return sum(b - a for a, b in self.intervals.get(name, ())
                   if t0 <= a < t1)

    def label(self, name: str):
        """A ``record_function`` context while the profiler runs."""
        import contextlib
        if not self.labelled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(SPAN_PREFIX + name)


def wrap(obj, attr: str, spans: Spans, name: str) -> None:
    """Record every call of ``obj.attr`` as a span ``name``."""
    inner = getattr(obj, attr)

    def wrapper(*args, **kwargs):
        with spans.label(name):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            t1 = time.perf_counter()
        spans.add(name, t0, t1)
        return out

    setattr(obj, attr, wrapper)


def _device_events(prof):
    """(name, start_us, end_us) of every device activity: kernels,
    copies and sets; not the profiler's annotations."""
    from torch.autograd import DeviceType
    out = []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        if getattr(evt, "is_user_annotation", False) or \
                evt.name.startswith(SPAN_PREFIX):
            continue
        out.append((evt.name, evt.time_range.start, evt.time_range.end))
    return out


def device_time_by_name(prof) -> Dict[str, float]:
    """Device seconds summed by kernel name over the profiled window
    (``_device_ms``: names cut to 80 characters can meet, so add)."""
    from torch.autograd import DeviceType
    kernels: Dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        if getattr(evt, "is_user_annotation", False) or \
                evt.key.startswith(SPAN_PREFIX):
            continue
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, name):
                key = evt.key[:80]
                kernels[key] = kernels.get(key, 0.0) + float(
                    getattr(evt, name)) / 1e6
                break
    return kernels


def _union(intervals: Sequence[Tuple[float, float]]):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_labels(prof):
    """(label, start_us, end_us) of the harness's annotated spans."""
    from torch.autograd import DeviceType
    return [(e.name[len(SPAN_PREFIX):], e.time_range.start,
             e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CPU
            and e.name.startswith(SPAN_PREFIX)]


def device_summary(prof, window_s: float, top: int = 10) -> Dict:
    """The profiled window: ``busy_s`` (the union of device activity),
    ``window_s``, ``kernels`` (device seconds by name) and the
    ``breakdown`` of the ``top`` device operations and idle gaps."""
    events = _device_events(prof)
    merged = _union([(a, b) for _, a, b in events])
    busy_s = sum(b - a for a, b in merged) / 1e6
    labels = _host_labels(prof)
    gaps = []
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = (end + start) / 2
        where = [name for name, a, b in labels if a <= mid < b]
        gaps.append((where[-1] if where else "harness", (start - end) / 1e6))
    by_label: Dict[str, float] = {}
    longest = sorted(gaps, key=lambda g: -g[1])[:top]
    for name, s in gaps:
        by_label[name] = by_label.get(name, 0.0) + s
    kernels = device_time_by_name(prof)
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_s, "window_s": window_s, "kernels": kernels,
            "idle_by_span_s": by_label,
            "breakdown": {"device_ops": [[k, v] for k, v in ops],
                          "idle_gaps": [[k, v] for k, v in longest]}}


def kernel_seconds(kernels: Dict[str, float], patterns: Sequence[str]
                   ) -> float:
    """Device seconds of the kernels whose name holds any of
    ``patterns``."""
    return sum(s for name, s in kernels.items()
               if any(p in name for p in patterns))
