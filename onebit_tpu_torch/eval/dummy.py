"""Dummy LM: the harness's fake backend (reference models/dummy.py:5-36).

Returns random loglikelihoods and canned generations — used to smoke the
eval plumbing (request construction, batching, aggregation, tables) without
a model.  Same surface as the model-backed functions so tasks can be
driven with ``evaluate_tasks(..., lm=DummyLM())``. A copy of
``onebit_tpu/eval/dummy.py``.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple


class DummyLM:
    def __init__(self, seed: int = 1234):
        self.rng = random.Random(seed)

    def loglikelihood(self, requests: Sequence[Tuple[Sequence[int],
                                                     Sequence[int]]]
                      ) -> List[Tuple[float, bool]]:
        return [(-self.rng.random(), False) for _ in requests]

    def loglikelihood_rolling(self, documents) -> List[float]:
        return [-self.rng.random() * len(d) for d in documents]

    def greedy_until(self, requests, detokenize=None, **kw) -> List[str]:
        return ["lol" for _ in requests]  # reference dummy.py returns "lol"
