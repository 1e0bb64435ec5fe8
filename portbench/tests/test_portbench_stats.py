"""Percentiles and rates from per-request timestamps."""

import math

import pytest

from portbench import stats
from portbench.stats import RequestRecord as R


def test_percentile_interpolates_between_order_statistics():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 0) == 1.0
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 90) == pytest.approx(4.6)
    assert stats.percentile(xs, 100) == 5.0
    assert stats.percentile(list(range(11)), 90) == pytest.approx(9.0)


def test_percentile_counts_failures_as_infinite():
    assert stats.percentile([1.0, 2.0, math.inf], 50) == 2.0
    assert stats.percentile([1.0, 2.0, math.inf], 90) == math.inf
    assert stats.percentile([1.0] * 9 + [math.inf], 80) == 1.0
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_ttft_takes_requests_due_in_the_window():
    recs = [R(due=0.5, first=1.5, done=3.0, tokens=4),    # due before
            R(due=1.0, first=1.25, done=2.0, tokens=5),   # 0.25
            R(due=2.0, first=None, done=None, tokens=0),  # waits: 3.0
            R(due=3.0, first=5.5, done=None, tokens=1),   # first after close
            R(due=4.0, first=None, done=None, tokens=0, failed=True),
            R(due=5.0, first=5.1, done=5.2, tokens=2)]    # due at close
    got = stats.ttft_values(recs, 1.0, 5.0)
    assert got == [0.25, 3.0, 2.0, math.inf]


def test_tpot_takes_requests_completed_in_the_window():
    recs = [R(due=0.0, first=1.0, done=3.0, tokens=5),    # 0.5
            R(due=0.0, first=1.0, done=1.0, tokens=1),    # one token
            R(due=0.0, first=1.0, done=9.0, tokens=3),    # done after
            R(due=0.0, first=0.2, done=0.9, tokens=3)]    # done before
    assert stats.tpot_values(recs, 1.0, 5.0) == [0.5]


def test_rate():
    assert stats.rate(300, 1.5) == 200
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
