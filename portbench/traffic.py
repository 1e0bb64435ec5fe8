"""The one traffic generator: a mix is a data file of parameters
(``traffic/<name>.json``), and this module turns it and ``--seed`` into
requests.

The mix's own ``pool_seed`` draws one fixed sequence of ``pool`` requests
(prompt and output lengths, and in an open loop the gaps between
arrivals). A run replays that sequence from a point the seed chooses, round
and round: every seed gets the same sizes and arrivals, in the same local
order, rotated. The seed also draws the prompts' token ids. So a run with
another seed does the same work, not a different amount of it; in an open
loop, where long prompts that arrive close together make the tail, a shuffle
would change the tail from seed to seed by more than the run's own noise.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

FIRST_ID = 3   # token ids are drawn from [FIRST_ID, vocab): past bos/eos/pad


def _draw(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` whole lengths from ``spec``: ``lognormal`` (median, sigma)
    or ``uniform`` (both ends included), clipped to ``[min, max]``."""
    if spec["dist"] == "lognormal":
        x = np.exp(np.log(spec["median"]) + spec["sigma"]
                   * rng.standard_normal(n))
        x = np.rint(x)
    elif spec["dist"] == "uniform":
        x = rng.integers(spec["min"], spec["max"] + 1, n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def bucket(n: int, minimum: int, max_len: int) -> int:
    """The length a prompt of ``n`` tokens is padded to: the engine's
    power of two from ``minimum``, at most ``max_len``."""
    b = minimum
    while b < n:
        b *= 2
    return min(b, max_len)


def _seed_words(seed: int) -> int:
    """``--seed`` as the non-negative integer numpy's generators take."""
    return int(seed) % 2 ** 64


class Traffic:
    """Requests of one serving mix for one seed: ``request(i)`` is the
    i-th request sent (prompt ids, output budget); ``arrival(i)`` the
    open loop's scheduled time of request i, in seconds from the start of
    the schedule."""

    def __init__(self, mix: Dict, seed: int, vocab_size: int):
        if mix.get("kind") != "serve":
            raise ValueError("Traffic takes a serving mix")
        self.mix = mix
        self.vocab_size = vocab_size
        self.seed = _seed_words(seed)
        pool_rng = np.random.default_rng(mix["pool_seed"])
        n = mix["pool"]
        self.prompt_lens = _draw(mix["prompt_tokens"], n, pool_rng)
        self.output_lens = _draw(mix["output_tokens"], n, pool_rng)
        start = np.random.default_rng([self.seed, 0]).integers(n)
        self.order = np.roll(np.arange(n), -start)
        self.open = mix["loop"] == "open"
        if self.open:
            if mix.get("arrivals") != "poisson":
                raise ValueError(f"unknown arrivals {mix.get('arrivals')!r}")
            gaps = pool_rng.exponential(1.0, n)
            # one lap of the pool lasts exactly pool / rate seconds
            gaps *= n / mix["rate_per_s"] / gaps.sum()
            self._times = np.cumsum(gaps[self.order])
        self.clients = mix.get("clients", 0)

    def sizes(self, i: int) -> Tuple[int, int]:
        """(prompt tokens, output tokens) of request ``i``."""
        j = self.order[i % len(self.order)]
        return int(self.prompt_lens[j]), int(self.output_lens[j])

    def request(self, i: int) -> Tuple[List[int], int]:
        """Request ``i``: its prompt's token ids and its output budget."""
        plen, out = self.sizes(i)
        rng = np.random.default_rng([self.seed, 1, i])
        ids = rng.integers(FIRST_ID, self.vocab_size, plen)
        return ids.tolist(), out

    def arrival(self, i: int) -> float:
        """Open loop: request ``i``'s scheduled time (s from the start)."""
        n = len(self._times)
        laps, j = divmod(i, n)
        return float(laps * self._times[-1] + self._times[j])

    def bucket_prompts(self, minimum: int, max_len: int) -> Dict[int, int]:
        """The powers of two (from ``minimum``, at most ``max_len``) that
        this mix's prompts pad to, each with the longest prompt it takes:
        the prefill shapes a run will meet."""
        out: Dict[int, int] = {}
        for n in self.prompt_lens.tolist():
            b = bucket(n, minimum, max_len)
            out[b] = max(out.get(b, 0), n)
        return dict(sorted(out.items()))
