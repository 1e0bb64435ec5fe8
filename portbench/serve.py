"""A serving cell's run: one cell of ``ContinuousBatchingEngine`` under a
traffic mix, from set-up through the measured window to the check of what
the window served against the plain reference.

Set-up makes the seeded weights on the device, builds the engine (its
decode-block graph captured by ``warmup``), runs one prefill for each
prompt bucket the mix meets, and ramps the traffic for the mix's
``ramp_s`` (a closed loop's clients starting one after another over it)
so that the window opens on a steady population. The window
then runs for ``--seconds`` from one step boundary to the first boundary
after it. Requests are timed from when they were due: a closed-loop
client's request when the client sent it (its previous reply done), an
open-loop request at its scheduled arrival. A traced run takes its spans
through the window and then profiles ``PROFILE_S`` more seconds of the
same load, so that the profiler's own cost stays out of the window.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from portbench import reference, stats, weights
from portbench.devtrace import Spans, device_summary, wrap
from portbench.traffic import FIRST_ID, Traffic, bucket

PROFILE_S = 2.0          # the traced run profiles this much of the load
PROFILE_MAX_S = 6.0      # ... or up to this much, until an admission
MIN_BUCKET = 32          # the engine pads prompts to powers of two from it


class _Rec:
    """A request the harness sent: when it was due, and the engine's own
    record of it (prompt, tokens, first-token and done times)."""
    __slots__ = ("due", "req", "warm")

    def __init__(self, due, req, warm=False):
        self.due, self.req, self.warm = due, req, warm

    def record(self) -> stats.RequestRecord:
        r = self.req
        return stats.RequestRecord(
            due=self.due, first=r.t_first_token or None,
            done=r.t_done or None, tokens=len(r.generated),
            failed=r.done and not r.generated)


class Client:
    """Sends the mix's requests to one engine and harvests its replies."""

    def __init__(self, eng, traffic: Traffic):
        self.eng, self.traffic = eng, traffic
        self.recs: Dict[int, _Rec] = {}
        self.sent = 0
        self.t_sched = None
        self.starts = []
        # (time, pages reserved, pages written, slots live) after a step
        self.pool: List = []

    def send(self, due: float, prompt=None, out=None, warm=False) -> None:
        if prompt is None:
            prompt, out = self.traffic.request(self.sent)
            self.sent += 1
        uid = self.eng.add_request(prompt, max_new_tokens=out)
        self.recs[uid] = _Rec(due, self.eng.waiting[-1], warm)

    def start(self, now: float, ramp_s: float) -> None:
        """Open the traffic: the closed loop's clients start one after
        another, evenly over ``ramp_s``, so that the window opens on
        requests of every age; the open loop's schedule starts now."""
        self.t_sched = now
        n = self.traffic.clients
        self.starts = [now + i * ramp_s / n for i in range(n)]

    def _next_due(self) -> float:
        if self.traffic.open:
            return self.t_sched + self.traffic.arrival(self.sent)
        return self.starts[0] if self.starts else float("inf")

    def pump(self, until: float) -> float:
        """Drive the engine until a step boundary at or past ``until``;
        returns that boundary's time."""
        eng, tr = self.eng, self.traffic
        while True:
            now = time.perf_counter()
            if now >= until:
                return now
            while self._next_due() <= now:
                due = self._next_due()
                if not tr.open:
                    self.starts.pop(0)
                self.send(due)
            if eng.has_work():
                eng.step()
                self._sample_pool()
            else:
                time.sleep(max(0.0, min(self._next_due(), until) - now))
            for uid, req in list(eng.finished.items()):
                if not tr.open and not self.recs[uid].warm:
                    self.send(req.t_done)
            eng.finished.clear()

    def generated(self) -> Dict[int, int]:
        return {uid: len(r.req.generated) for uid, r in self.recs.items()}

    def _sample_pool(self) -> None:
        """The page pool and the slots after a step: pages the allocator
        has handed out (each request reserves its prompt and whole output
        budget at admission), pages the live requests' positions fill, and
        the slots they hold (decode runs every slot)."""
        eng = self.eng
        if not eng.paged:
            return
        live = [r for r in eng.slots if r is not None]
        ps = eng.page_size
        written = sum(-(-(len(r.prompt) + len(r.generated)) // ps)
                      for r in live)
        self.pool.append((time.perf_counter(),
                          eng.total_pages - len(eng.allocator.free),
                          written, len(live)))

    def pool_use(self, t0: float, t1: float) -> Dict[str, float]:
        """Pages reserved and written, and slots live, as shares (%) of
        the pool and of the slots: each the mean over ``[t0, t1]``
        weighted by time, and the largest."""
        pts = [x for x in self.pool if t0 <= x[0] <= t1]
        if len(pts) < 2:
            return {}
        eng = self.eng
        out = {"pool_pages": eng.total_pages}
        for k, name, total in ((1, "pool_reserved", eng.total_pages),
                               (2, "pool_written", eng.total_pages),
                               (3, "slots_live", eng.max_batch)):
            area = sum(a[k] * (b[0] - a[0]) for a, b in zip(pts, pts[1:]))
            out[f"{name}_mean_pct"] = (
                100.0 * area / (pts[-1][0] - pts[0][0]) / total)
            out[f"{name}_max_pct"] = 100.0 * max(x[k] for x in pts) / total
        return out


def _admissions(eng, spans: Spans, log: List, chunk, max_len: int,
                max_batch: int) -> None:
    """Wrap ``_admit``: a span, and the prompt lengths it admitted with the
    rows of each projection call they made (``log`` entries ``(t0, t1,
    prompt_lens, ms)``, ``ms`` a list of ``(rows the kernel ran, rows the
    prompts need)``: a chunk's last rows and a bucket's padding and padded
    rows are run but not needed); and ``_flush_pending``, whose wait for
    the block in flight is a span of its own (``admit_flush`` inside an
    admission, ``decode_flush`` inside a decode)."""
    inner, inner_flush = eng._admit, eng._flush_pending
    in_admit = [False]

    def flush():
        name = "admit_flush" if in_admit[0] else "decode_flush"
        with spans.label(name):
            t0 = time.perf_counter()
            inner_flush()
        spans.add(name, t0, time.perf_counter())

    def admit():
        before = list(eng.waiting)
        with spans.label("admit"):
            t0 = time.perf_counter()
            in_admit[0] = True
            try:
                inner()
            finally:
                in_admit[0] = False
            t1 = time.perf_counter()
        spans.add("admit", t0, t1)
        left = {id(r) for r in eng.waiting}
        plens = [len(r.prompt) for r in before if id(r) not in left]
        ms = []
        if chunk:
            for n in plens:
                ms += [(chunk, min(chunk, n - i))
                       for i in range(0, n, chunk)]
        else:
            groups: Dict[int, List[int]] = {}
            for n in plens:
                groups.setdefault(bucket(n, MIN_BUCKET, max_len),
                                  []).append(n)
            for b, lens in groups.items():
                rows = 1
                while rows < len(lens):
                    rows *= 2
                ms.append((min(rows, max_batch) * b, sum(lens)))
        log.append((t0, t1, plens, ms))

    eng._admit, eng._flush_pending = admit, flush


def _decode_lengths(drv: Client, g0: Dict[int, int], g1: Dict[int, int]
                    ) -> List[int]:
    """The positions each decode token emitted between two snapshots
    attended: the j-th generated token (j >= 1) of a prompt of n tokens
    was computed over n + j positions."""
    out = []
    for uid, n1 in g1.items():
        plen = len(drv.recs[uid].req.prompt)
        for j in range(max(g0.get(uid, 0), 1), n1):
            out.append(plen + j)
    return out


def run(run, out) -> None:
    """Set up, warm, ramp, measure, check. ``run`` holds the cell and the
    arguments; ``out`` receives the results (see ``harness.Outcome``)."""
    from onebit_tpu_torch.engine.batching import ContinuousBatchingEngine
    from onebit_tpu_torch.engine.sampler import SamplingConfig
    from onebit_tpu_torch.model.bitllama import fuse_for_decode
    from onebit_tpu_torch.model.config import BitLlamaConfig

    cell, cfg, mix, dev = run.cell, run.cfg, run.mix, run.device
    opts = dict(cell["engine"])
    port_cfg = BitLlamaConfig.from_dict(cfg)
    raw = weights.served(cfg, run.seed, dev)
    params = fuse_for_decode(weights.to_port_served(raw), port_cfg)
    del raw
    eng = ContinuousBatchingEngine(
        params, port_cfg, device=dev, seed=0,
        sampling=SamplingConfig(greedy=bool(mix["greedy"])), **opts)
    eng.warmup()
    traffic = Traffic(mix, run.seed, cfg["vocab_size"])
    drv = Client(eng, traffic)
    run.mark("engine")

    # one prefill of each prompt bucket the mix meets, no decode
    max_len = opts["max_len"]
    for n in traffic.bucket_prompts(MIN_BUCKET, max_len).values():
        drv.send(time.perf_counter(), prompt=[FIRST_ID] * n, out=1,
                 warm=True)
        while eng.has_work():
            eng.step()
        eng.finished.clear()
    run.sync()
    run.mark("warm")

    spans, admits = Spans(), []
    if run.trace:
        _admissions(eng, spans, admits, opts.get("prefill_chunk_size"),
                    max_len, opts["max_batch"])
        wrap(eng, "_decode", spans, "decode")
        wrap(eng, "_dispatch_block", spans, "dispatch")

    t_ramp = time.perf_counter()
    drv.start(t_ramp, mix["ramp_s"])
    t_open = drv.pump(t_ramp + mix["ramp_s"])
    run.mark("ramp")
    out.setup_s = t_open - run.t_start
    tok0, gen0 = eng.total_tokens, drv.generated()
    queue0 = len(eng.waiting)
    t_close = drv.pump(t_open + run.seconds)
    tok1, gen1 = eng.total_tokens, drv.generated()
    window_s = t_close - t_open
    run.mark("window")
    out.notes.update({"window_s": window_s, "queue_open": queue0,
                      "queue_close": len(eng.waiting)})
    out.notes.update(drv.pool_use(t_open, t_close))
    if run.trace:
        in_window = [a for a in admits if t_open <= a[0] < t_close]
        flush_s = spans.seconds("admit_flush", t_open, t_close)
        out.counters = {
            "window_s": window_s, "max_batch": opts["max_batch"],
            "page_size": opts.get("page_size", 16),
            "admit_s": spans.seconds("admit", t_open, t_close) - flush_s,
            "decode_s": spans.seconds("decode", t_open, t_close) + flush_s,
            "token_steps": eng.block_steps * sum(
                1 for a, _ in spans.intervals.get("dispatch", ())
                if t_open <= a < t_close),
            "prompt_lens": [n for a in in_window for n in a[2]],
            "decode_lengths": _decode_lengths(drv, gen0, gen1)}
        # the same load for a few seconds more, under the profiler, its
        # edges flushed so that every launch in it is counted
        eng._flush_pending()
        run.sync()
        p_g0 = drv.generated()
        steps0 = len(spans.intervals.get("dispatch", ()))
        n_admit0 = len(admits)
        spans.labelled = True
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            tp0 = time.perf_counter()
            t = drv.pump(tp0 + PROFILE_S)
            # an admission in it too, so that the prefill's readers read
            while not any(a[2] for a in admits[n_admit0:]) and \
                    t < tp0 + PROFILE_MAX_S:
                t = drv.pump(t + 0.25)
            eng._flush_pending()
            run.sync()
            tp1 = time.perf_counter()
        spans.labelled = False
        out.counters["prof"] = {
            "token_steps": (len(spans.intervals.get("dispatch", ()))
                            - steps0) * eng.block_steps,
            "prefill_m": [m for a in admits[n_admit0:] for m in a[3]],
            "decode_lengths": _decode_lengths(drv, p_g0, drv.generated())}
        out.profile = (device_summary(prof, tp1 - tp0)
                       if dev.type == "cuda" else None)
        del prof
        run.mark("profile")

    recs = [r.record() for r in drv.recs.values() if not r.warm]
    out.attempted = sum(1 for r in recs if t_open <= r.due < t_close)
    out.failed = sum(1 for r in recs if r.failed
                     and t_open <= r.due < t_close)
    ttft = stats.ttft_values(recs, t_open, t_close)
    tpot = stats.tpot_values(recs, t_open, t_close)
    out.e2e = {"output_tok_s": stats.rate(tok1 - tok0, window_s),
               "ttft_p90_ms": 1e3 * stats.percentile(ttft, 90),
               "tpot_p90_ms": 1e3 * stats.percentile(tpot, 90)}
    out.notes.update({"completed": len(tpot), "ttft_n": len(ttft),
                      "sent": drv.sent, "tokens": tok1 - tok0,
                      "ttft_p50_ms": 1e3 * stats.percentile(ttft, 50),
                      "tpot_p50_ms": 1e3 * stats.percentile(tpot, 50)})
    if traffic.open:
        late = [r.req.t_submit - r.due for r in drv.recs.values()
                if not r.warm and t_open <= r.due < t_close]
        out.notes["generator_late_max_ms"] = 1e3 * max(late, default=0.0)

    # the check: a sample of finished requests, the longest among them
    done = [r for r in drv.recs.values()
            if not r.warm and r.req.t_done and r.req.t_done <= t_close
            and len(r.req.generated) > 0]
    out.peak_bytes = run.peak_bytes()
    sample = _sample(done, cell["check"]["requests"], run.seed)
    seqs = [(list(r.req.prompt), list(r.req.generated)) for r in sample]
    del eng, drv, params, done, sample
    gc.collect()
    run.free()
    run.mark("freed")
    raw = weights.served(cfg, run.seed, dev)
    gaps = reference.served_gaps(raw, cfg, seqs, control=run.control)
    del raw
    run.mark("reference")
    out.notes["checked_tokens"] = sum(len(s) for _, s in seqs)
    if run.control:
        # the control in the program's place: at each position of the
        # served sequences, its first token judged as a served token is
        out.check = {"served_gap": gaps["control_gap"]}
        out.notes["program_served_gap"] = gaps["served_gap"]
    else:
        out.check = {"served_gap": gaps["served_gap"]}


def _sample(done, k: int, seed: int):
    """``k`` finished requests: the one with the most served tokens, and
    ``k - 1`` others drawn from ``seed``."""
    if not done:
        return []
    done = sorted(done, key=lambda r: (-len(r.req.generated), r.due))
    rest = done[1:]
    rng = np.random.default_rng([int(seed) % 2 ** 64, 2])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [done[0]] + [rest[i] for i in sorted(pick)]
