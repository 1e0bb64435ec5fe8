"""End-to-end statistics from per-request timestamps.

Every figure here is taken over all the work and all the time of the
window: a rate is the work completed inside the window over its seconds, a
tail is the percentile over every request that the definition takes in.
Nothing is a median of chunks.
"""

from __future__ import annotations

import math
from typing import Iterable, List, NamedTuple, Optional


class RequestRecord(NamedTuple):
    """One request as the harness saw it, times on one host clock (s).

    ``due``: when the request was due (a closed-loop client's send, an
    open-loop arrival's scheduled time); ``first``/``done``: its first and
    last token, or None; ``tokens``: tokens it emitted; ``failed``: the
    engine gave it up without a token."""
    due: float
    first: Optional[float]
    done: Optional[float]
    tokens: int
    failed: bool = False


def percentile(values: Iterable[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default method). ``inf`` entries sort last,
    so a failed request, counted as infinite, lifts the tail."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return xs[lo] if pos == lo else math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttft_values(records: Iterable[RequestRecord], t_open: float,
                t_close: float) -> List[float]:
    """Seconds from due to first token of every request due in
    ``[t_open, t_close)``: a request with no first token by the close counts
    with its wait so far, a failed one as infinite (it misses any limit)."""
    out = []
    for r in records:
        if not t_open <= r.due < t_close:
            continue
        if r.failed:
            out.append(math.inf)
        elif r.first is not None and r.first <= t_close:
            out.append(r.first - r.due)
        else:
            out.append(t_close - r.due)
    return out


def tpot_values(records: Iterable[RequestRecord], t_open: float,
                t_close: float) -> List[float]:
    """(last token - first token) / (tokens - 1) of every request completed
    in ``[t_open, t_close)`` with two tokens or more."""
    return [(r.done - r.first) / (r.tokens - 1) for r in records
            if r.done is not None and t_open <= r.done < t_close
            and r.tokens >= 2 and not r.failed]


def rate(work: float, seconds: float) -> float:
    """Work over seconds; the window must have a length."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return work / seconds

