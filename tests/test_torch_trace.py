"""The port's tracer (``utils/trace.py``) and the spans and counters the
engine and the KD step record with it, on the CPU at the tiny config."""

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                              host_random_packed_params)
from onebit_tpu_torch.core.build_start import build_start_params
from onebit_tpu_torch.model.bitllama import init_params
from onebit_tpu_torch.train.losses import KDConfig
from onebit_tpu_torch.train.trainer import (TrainConfig, init_train_state,
                                            make_train_step)
from onebit_tpu_torch.utils import trace


@pytest.fixture
def tracing():
    """Tracing on for one test, and off with nothing recorded after it."""
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


@pytest.fixture(scope="module")
def served():
    c = BitLlamaConfig.named("tiny", num_hidden_layers=1)
    return c, host_random_packed_params(c, seed=0, dtype=torch.float32,
                                        device="cpu")


def _engine(served, **kw):
    c, params = served
    opts = dict(max_batch=2, max_len=128, paged=True, block_steps=4,
                pipeline_blocks=True)
    opts.update(kw)
    return ContinuousBatchingEngine(params, c, compute_dtype=torch.float32,
                                    device="cpu", **opts)


def _serve(eng, lens, new=6):
    """Serve prompts of ``lens`` tokens; returns their requests."""
    rng = np.random.default_rng(0)
    for n in lens:
        eng.add_request(rng.integers(3, 500, n).tolist(), max_new_tokens=new)
    reqs = list(eng.waiting)
    eng.run()
    return reqs


def _by_id(spans):
    return {s["id"]: s for s in spans}


def test_off_records_nothing(served):
    trace.reset()
    assert trace.span("a") is trace.span("b", device=True) is trace.NULL
    assert not trace.span("a")
    _serve(_engine(served), [5, 40, 33])
    assert trace.record() == []


def test_engine_span_tree_and_queue(served, tracing):
    """Two slots, three requests: the third waits for a slot while a
    pipelined block is in flight, so its admission flushes the pipeline."""
    eng = _engine(served)
    reqs = {r.uid: r for r in _serve(eng, [5, 40, 33])}
    uids = sorted(reqs)
    spans = trace.record()
    by_id = _by_id(spans)

    def parent(s):
        return by_id[s["parent"]]["name"]

    admits = [s for s in spans if s["name"] == "admit" and s["attrs"]]
    assert sorted(u for s in admits for u in s["attrs"]["uids"]) == uids
    for s in admits:
        assert parent(s) == "engine.step"
    kids = {s["name"] for s in spans
            if s["parent"] in {a["id"] for a in admits}}
    assert {"admit.reserve", "admit.prefill", "admit.sample"} <= kids
    # a block's tokens are fetched and emitted in a decode, or in the
    # flush of the pipeline that a decode's tail or an admission makes
    landing = {"decode", "decode.flush", "admit.flush"}
    for name, up in (("admit.flush", {"admit"}),
                     ("decode", {"engine.step"}),
                     ("decode.inputs", {"decode"}),
                     ("decode.replay", {"decode"}),
                     ("decode.wait", landing), ("decode.emit", landing)):
        seen = {parent(s) for s in spans if s["name"] == name}
        assert seen and seen <= up, (name, seen)
    assert eng.pipeline_flushes >= 1
    for s in spans:
        assert s["t0_ns"] <= s["t1_ns"]
        if s["parent"] is not None:
            up = by_id[s["parent"]]
            assert up["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= up["t1_ns"]
    queue = [s for s in spans if s["name"] == "request.queue"]
    assert sorted(s["attrs"]["uid"] for s in queue) == uids
    for s in queue:
        req = reqs[s["attrs"]["uid"]]
        assert req.t_submit <= req.t_admit <= req.t_first_token
        assert s["t0_ns"] == int(req.t_submit * 1e9)
        assert s["t1_ns"] == int(req.t_admit * 1e9)
    m = eng.metrics()
    assert m["blocks_dispatched"] == eng.blocks_dispatched > 0
    assert m["pipeline_flushes"] == eng.pipeline_flushes
    assert "tokens_per_second_ema" not in m


@pytest.mark.parametrize("chunk,run,needed,spans", [
    # buckets 32 (5) and 64 (40, 33): one row of 32, two of 64
    (None, 32 + 128, 78, "admit.prefill"),
    # chunks of 16: 1 + 3 + 3
    (16, 16 * 7, 78, "admit.chunk")], ids=["buckets", "chunks"])
def test_prefill_rows_counted(served, tracing, chunk, run, needed, spans):
    eng = _engine(served, max_batch=4, prefill_chunk_size=chunk)
    uids = [r.uid for r in _serve(eng, [5, 40, 33], new=2)]
    m = eng.metrics()
    assert (m["prefill_rows_run"], m["prefill_rows_needed"]) == (run, needed)
    got = [s for s in trace.record() if s["name"] == spans]
    assert sum(s["attrs"]["rows"] for s in got) == run
    assert sum(s["attrs"]["needed"] for s in got) == needed
    if chunk:
        assert sorted({s["attrs"]["uid"] for s in got}) == uids
    else:
        assert sorted(s["attrs"]["bucket"] for s in got) == [32, 64]


def test_pages_reserved_and_written(served):
    eng = _engine(served, block_steps=1, pipeline_blocks=False)
    eng.add_request(list(range(3, 23)), max_new_tokens=30)   # 20 tokens
    eng.step()
    m = eng.metrics()
    # bucket 32 or 50 positions: 4 pages of 16 reserved; 21 written: 2
    assert m["pages_reserved"] == 4 and m["pages_written"] == 2
    assert m["free_pages"] == m["total_pages"] - 4


def test_gc_is_a_span(tracing):
    with trace.span("outer") as outer:
        gc.collect()
    got = [s for s in trace.record() if s["name"] == "host.gc"]
    assert got and got[-1]["attrs"]["generation"] == 2
    assert got[-1]["parent"] == outer.id


def test_profiler_carries_spans_on_its_clock(served, tracing):
    eng = _engine(served)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng, [5, 40])
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    marked = {}
    for e in prof.events():
        if e.name.startswith(trace.PREFIX):
            marked.setdefault(e.name[len(trace.PREFIX):], []).append(
                start_ns + e.time_range.start * 1e3)
    spans = [s for s in trace.record()
             if s["name"] not in ("request.queue", "host.gc")]
    assert {"engine.step", "admit", "decode"} <= {s["name"] for s in spans}
    for s in spans:
        near = min(abs(t - s["t0_wall_ns"]) for t in marked[s["name"]])
        assert near < 1e6, (s["name"], near)


def test_kd_step_phases(tracing):
    c = BitLlamaConfig.named("tiny", num_hidden_layers=1)
    teacher = init_params(c, torch.Generator().manual_seed(0),
                          mode="linear", device="cpu")
    tcfg = TrainConfig(warmup_steps=0, total_steps=10)
    state = init_train_state(build_start_params(teacher), tcfg)
    step = make_train_step(c, KDConfig(), tcfg, compute_dtype=torch.float32)
    ids = np.random.default_rng(0).integers(0, c.vocab_size, (2, 16))
    trace.reset()
    step(state, teacher, {"input_ids": ids, "labels": ids})
    spans = trace.record()
    top = [s for s in spans if s["name"] == "kd.step"]
    assert len(top) == 1 and top[0]["parent"] is None
    phases = sorted((s for s in spans if s["parent"] == top[0]["id"]
                     and s["name"] != "host.gc"), key=lambda s: s["t0_ns"])
    assert [s["name"] for s in phases] == ["kd.teacher", "kd.forward",
                                           "kd.backward", "kd.update"]
    assert all("device_ms" not in s for s in spans)   # no card here
