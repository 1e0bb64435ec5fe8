"""Decode blocks of the port against the JAX package's, at the tiny config
in fp32 on the CPU: ``ragged_decode_block`` and ``paged_decode_block`` on
every cache kind against JAX's ``impl="xla"`` blocks on the same weights,
the engine with ``block_steps`` and ``pipeline_blocks``, the
tensor-parallel blocks, ``EngineServer`` and the ``serve`` command line.

Tolerances: none. The blocks' tokens, valid masks and finals must equal
JAX's exactly, and the engines' greedy tokens JAX's engine's. The port's
block reads the whole cache in the plain attention where JAX's step picks a
window: the mask is the same, only the reduction regroups (about 1e-6 on
logits, ROADMAP.md §3), under the tiny model's gaps between greedy logits.

The JAX side of each configuration runs once, in a module fixture; the
tensor-parallel ranks are spawned once for the module, as
``tests/test_torch_tp.py`` spawns them. This module imports only torch,
numpy and the port at its top, so the ranks never load JAX.
"""

import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                              SamplingConfig, params_from_jax)
from onebit_tpu_torch.engine.paged import (init_paged_kv_cache,
                                           paged_decode_block,
                                           paged_prefill_rows)
from onebit_tpu_torch.engine.server import EngineServer
from onebit_tpu_torch.model.bitllama import init_kv_cache
from onebit_tpu_torch.model.kv_cache import (init_quant_kv_cache_kt,
                                             init_quant_kv_cache_kt4)
from onebit_tpu_torch.model.ragged_decode import (prefill_rows,
                                                  ragged_decode_block)
from onebit_tpu_torch.parallel.mesh import spawn_tp

CPU = torch.device("cpu")
F32 = torch.float32
GREEDY = SamplingConfig(greedy=True)
MAX_LEN, PAGE = 64, 4
BLOCK_PROMPTS = [[5, 17, 42, 9, 3], [100, 3, 8], [7, 8, 9, 10, 11, 12, 13],
                 [21, 22]]
BLOCK_STEPS = 6
# row 2 inactive; row 1 ends on its budget inside the block, row 0 on EOS
ACTIVE = [True, True, False, True]
BUDGET = [9, 2, 0, 9]
EOS_STEP = 2                 # EOS: the token row 0 emits at this step
ENGINE_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [3, 1, 4, 1, 5]]
ENGINE_NEW = 9
CACHES = ("dense", "int8_kt", "int4_kt", "paged", "paged_int8")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tiny runs here take one intra-op thread, as the ranks do:
    beside the suite's other workers, torch's default of one thread a core
    made them some 30 times slower. Restored for later modules."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _portable(tree):
    from onebit_tpu_torch.kernels import bitlinear as tbl
    layers = {name: tbl.BitLinearWeights(*w) if isinstance(w, tuple) else w
              for name, w in tree["layers"].items()}
    return dict(tree, layers=layers)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX packed params, the port's config and params, the
    params as a portable numpy tree)."""
    import jax

    from onebit_tpu.model import bitllama as jb
    from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
    jc = JaxConfig.named("tiny")
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(0)))
    tree = _portable(jax.tree.map(np.array, jp))
    c = BitLlamaConfig.named("tiny")
    return jc, jp, c, params_from_jax(tree, c, device=CPU), tree


# ---------------------------------------------------------------------------
# The blocks against JAX's
# ---------------------------------------------------------------------------

def _block_inputs():
    """Right-padded prompts (bucket 8), lengths, slot rows, page tables."""
    ids = np.zeros((len(BLOCK_PROMPTS), 8), np.int64)
    for r, p in enumerate(BLOCK_PROMPTS):
        ids[r, :len(p)] = p
    lens = np.asarray([len(p) for p in BLOCK_PROMPTS], np.int64)
    per = MAX_LEN // PAGE
    tables = (1 + np.arange(len(BLOCK_PROMPTS) * per, dtype=np.int32)
              ).reshape(len(BLOCK_PROMPTS), per)
    return ids, lens, np.arange(len(BLOCK_PROMPTS)), tables


def _port_block(c, params, kind):
    """The port's prefill then one block: (toks, valid, finals) as numpy."""
    ids, lens, rows, tables = _block_inputs()
    b, t = torch.from_numpy, torch.from_numpy
    if kind.startswith("paged"):
        cache = init_paged_kv_cache(c, tables.size + 1, PAGE, dtype=F32,
                                    quantized=kind == "paged_int8",
                                    device=CPU)
        logits, cache = paged_prefill_rows(params, cache, b(ids), b(lens),
                                           tables, c, compute_dtype=F32)
    else:
        init = {"dense": lambda: init_kv_cache(c, 4, MAX_LEN, dtype=F32,
                                               device=CPU),
                "int8_kt": lambda: init_quant_kv_cache_kt(c, 4, MAX_LEN,
                                                          device=CPU),
                "int4_kt": lambda: init_quant_kv_cache_kt4(c, 4, MAX_LEN,
                                                           device=CPU)}
        logits, cache = prefill_rows(params, init[kind](), b(ids), b(lens),
                                     t(rows), c, compute_dtype=F32)
    state = (logits.argmax(-1), b(lens), torch.tensor(ACTIVE),
             torch.tensor(BUDGET))
    kw = dict(sampling=GREEDY, n_steps=BLOCK_STEPS, compute_dtype=F32)
    gen = torch.Generator().manual_seed(0)
    if kind.startswith("paged"):
        tok, pos, act, bud = state
        toks, valid, _, finals = paged_decode_block(
            params, cache, tok, pos, tables, act, bud, gen, c, **kw)
    else:
        toks, valid, _, finals = ragged_decode_block(params, cache, *state,
                                                     gen, c, **kw)
    return toks.numpy(), valid.numpy(), [f.numpy() for f in finals]


def _jax_block(jc, jp, kind):
    import jax
    import jax.numpy as jnp

    from onebit_tpu.engine import paged as jpg
    from onebit_tpu.engine.sampler import SamplingConfig as JaxSampling
    from onebit_tpu.model import ragged_decode as jrd
    from onebit_tpu.model.bitllama import init_kv_cache as jax_cache
    from onebit_tpu.model.kv_cache import (init_quant_kv_cache_kt,
                                           init_quant_kv_cache_kt4)
    ids, lens, rows, tables = _block_inputs()
    a = lambda x, dt=jnp.int32: jnp.asarray(x, dt)  # noqa: E731
    kw = dict(compute_dtype=jnp.float32, impl="xla")
    if kind.startswith("paged"):
        cache = jpg.init_paged_kv_cache(
            jc, tables.size + 1, PAGE, dtype=jnp.float32,
            quantized=kind == "paged_int8")
        logits, cache = jpg.paged_prefill_rows(jp, cache, a(ids), a(lens),
                                               a(tables), jc, **kw)
    else:
        cache = {"dense": lambda: jax_cache(jc, 4, MAX_LEN,
                                            dtype=jnp.float32),
                 "int8_kt": lambda: init_quant_kv_cache_kt(jc, 4, MAX_LEN),
                 "int4_kt": lambda: init_quant_kv_cache_kt4(jc, 4, MAX_LEN)
                 }[kind]()
        logits, cache = jrd.prefill_rows(jp, cache, a(ids), a(lens), a(rows),
                                         jc, **kw)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    blk = dict(kw, sampling=JaxSampling(greedy=True), n_steps=BLOCK_STEPS)
    key = jax.random.PRNGKey(0)
    if kind.startswith("paged"):
        toks, valid, _, _, finals = jpg.paged_decode_block(
            jp, cache, tok, a(lens), a(tables), a(ACTIVE, bool), a(BUDGET),
            key, jc, **blk)
    else:
        toks, valid, _, _, finals = jrd.ragged_decode_block(
            jp, cache, tok, a(lens), a(ACTIVE, bool), a(BUDGET), key, jc,
            **blk)
    return np.asarray(toks), np.asarray(valid), [np.asarray(f)
                                                 for f in finals]


@pytest.fixture(scope="module", params=CACHES)
def blocks(request, tiny):
    """Per cache kind: the port's block and JAX's, with an EOS that row 0
    emits inside the block (taken from the port's run without it)."""
    jc, jp, c, params, _ = tiny
    kind = request.param
    eos = int(_port_block(c, params, kind)[0][EOS_STEP, 0])
    c_eos = dataclasses.replace(c, eos_token_id=eos)
    jc_eos = dataclasses.replace(jc, eos_token_id=eos)
    return (kind, _port_block(c_eos, params, kind),
            _jax_block(jc_eos, jp, kind))


def test_block_equals_jax(blocks):
    """toks, valid and finals exactly JAX's; the EOS and budget stops
    happen inside the block, and the inactive row stays frozen."""
    kind, (toks, valid, finals), (jtoks, jvalid, jfinals) = blocks
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(valid, jvalid)
    for got, want in zip(finals, jfinals):
        np.testing.assert_array_equal(got, want)
    n_valid = valid.sum(0)
    assert n_valid[1] == BUDGET[1] and n_valid[2] == 0
    assert 0 < n_valid[0] <= EOS_STEP + 1 < BLOCK_STEPS, kind
    assert n_valid[3] == BLOCK_STEPS and finals[2].tolist() == [
        True, True, True, False]


# ---------------------------------------------------------------------------
# The engine with decode blocks against JAX's engine
# ---------------------------------------------------------------------------
# (cache options, block_steps, pipeline_blocks): JAX's
# test_block_decode_matches_single_step (dense, 4), test_block_decode_paged
# (paged, 3), test_quant_dense_engine_block_steps (int8 KT, 3) and
# test_pipelined_blocks_match_unpipelined (dense and int8 KT, 4, pipelined),
# with int4 KT and int8 pages beside them
ENGINE_CASES = {
    "dense_4": ("dense", 4, False), "dense_2": ("dense", 2, False),
    "paged_3": ("paged", 3, False), "int8_kt_3": ("int8_kt", 3, False),
    "dense_4_pipelined": ("dense", 4, True),
    "int8_kt_4_pipelined": ("int8_kt", 4, True),
    "int4_kt_2_pipelined": ("int4_kt", 2, True),
    "paged_int8_4_pipelined": ("paged_int8", 4, True),
    "paged_3_pipelined": ("paged", 3, True)}
CACHE_OPTS = {"dense": {}, "int8_kt": dict(quantized_kv=True),
              "int4_kt": dict(quantized_kv="int4"),
              "paged": dict(paged=True, page_size=PAGE),
              "paged_int8": dict(paged=True, page_size=PAGE,
                                 quantized_kv=True)}


def _run(eng, prompts=ENGINE_PROMPTS, n_new=ENGINE_NEW):
    uids = [eng.add_request(list(p), max_new_tokens=n_new) for p in prompts]
    out = eng.run()
    return [out[u] for u in uids]


@pytest.fixture(scope="module")
def jax_engine_tokens(tiny):
    """The JAX engine's greedy tokens per cache kind (one step a call; its
    block engine gives the same, tests/test_batching.py), with an EOS that
    the first request emits mid-run (taken from the port's dense engine
    without it)."""
    import jax.numpy as jnp

    from onebit_tpu.engine.batching import ContinuousBatchingEngine as JaxEng
    jc, jp, c, params, _ = tiny
    plain = _run(ContinuousBatchingEngine(params, c, max_batch=2,
                                          max_len=MAX_LEN, compute_dtype=F32,
                                          device=CPU))
    eos = plain[0][4]
    assert eos not in plain[0][:4]
    jc = dataclasses.replace(jc, eos_token_id=eos)
    out = {}
    for kind in CACHE_OPTS:
        out[kind] = _run(JaxEng(jp, jc, max_batch=2, max_len=MAX_LEN,
                                compute_dtype=jnp.float32,
                                **CACHE_OPTS[kind]))
    return eos, out


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_block_engine_equals_jax_engine(tiny, jax_engine_tokens, case):
    """Four requests through two slots (staggered admission), EOS mid-block:
    JAX's tokens, nothing left in flight, and every token counted."""
    _, _, c, params, _ = tiny
    kind, steps, pipelined = ENGINE_CASES[case]
    eos, want = jax_engine_tokens
    eng = ContinuousBatchingEngine(
        params, dataclasses.replace(c, eos_token_id=eos), max_batch=2,
        max_len=MAX_LEN, compute_dtype=F32, device=CPU, block_steps=steps,
        pipeline_blocks=pipelined, **CACHE_OPTS[kind])
    got = _run(eng)
    assert got == want[kind]
    if kind != "int4_kt":        # int4 pools take another path before it
        assert got[0] == want["dense"][0][:5]     # the EOS stop, mid-block
    assert eng._pending is None and eng.pipeline_blocks == pipelined
    assert eng.total_tokens == sum(map(len, want[kind]))
    if eng.paged:
        assert len(eng.allocator.free) == eng.total_pages


def test_streaming_rows_keep_the_per_token_path(tiny, jax_engine_tokens):
    """A row with on_token sees each token of a block, in order."""
    _, _, c, params, _ = tiny
    eos, want = jax_engine_tokens
    eng = ContinuousBatchingEngine(
        params, dataclasses.replace(c, eos_token_id=eos), max_batch=2,
        max_len=MAX_LEN, compute_dtype=F32, device=CPU, block_steps=4,
        pipeline_blocks=True)
    seen, done = [], []
    uid = eng.add_request(ENGINE_PROMPTS[1], max_new_tokens=ENGINE_NEW,
                          on_token=seen.append,
                          on_done=lambda: done.append(True))
    assert eng.run()[uid] == seen == want["dense"][1] and done == [True]


def test_warmup_leaves_the_engine_empty(tiny):
    _, _, c, params, _ = tiny
    eng = ContinuousBatchingEngine(params, c, max_batch=2, max_len=MAX_LEN,
                                   compute_dtype=F32, device=CPU,
                                   block_steps=4, pipeline_blocks=True)
    eng.warmup(buckets=[32])
    assert not eng.has_work() and eng.total_tokens == 0
    assert not eng.cache.k.any() and eng._graph is None


@pytest.mark.parametrize("kwargs", [
    dict(block_steps=2, pipeline_blocks=True, draft_params={}),
    dict(block_steps=2, draft_params={})], ids=["pipeline", "block_steps"])
def test_block_exclusions_raise_jax_wording(tiny, kwargs):
    from onebit_tpu.engine.batching import ContinuousBatchingEngine as JaxEng
    jc, _, c, _, _ = tiny
    with pytest.raises(ValueError) as want:
        JaxEng({}, jc, draft_config=jc, **kwargs)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine({}, c, device=CPU, **kwargs)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The tensor-parallel blocks
# ---------------------------------------------------------------------------
TP_MAX_LEN, TP_NEW = 32, 8
TP_CASES = {"dense_4": dict(block_steps=4),
            "paged_4_pipelined": dict(block_steps=4, pipeline_blocks=True,
                                      paged=True, page_size=8)}


def _tp_blocks_rank(group, tree):
    torch.set_num_threads(1)
    c = BitLlamaConfig.named("tiny")
    params = params_from_jax(tree, c, device=CPU)
    out = {}
    for name, opts in TP_CASES.items():
        eng = ContinuousBatchingEngine(params, c, max_batch=2,
                                       max_len=TP_MAX_LEN, compute_dtype=F32,
                                       tp_group=group, **opts)
        out[name] = _run(eng, n_new=TP_NEW)
    return out


@pytest.fixture(scope="module")
def tp_ranks(tiny):
    return spawn_tp(_tp_blocks_rank, 2, backend="gloo", device="cpu",
                    timeout=240, args=(tiny[4],))


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_blocks_equal_jax_engine(tiny, tp_ranks, case):
    """JAX's test_tp_engine_block_decode_matches holds its TP block engine
    to its single-device engine; both ranks of the port's give those
    tokens (dense and paged pools, pipelined or not)."""
    import jax.numpy as jnp

    from onebit_tpu.engine.batching import ContinuousBatchingEngine as JaxEng
    jc, jp, _, _, _ = tiny
    opts = {k: v for k, v in TP_CASES[case].items()
            if k in ("paged", "page_size")}
    want = _run(JaxEng(jp, jc, max_batch=2, max_len=TP_MAX_LEN,
                       compute_dtype=jnp.float32, **opts), n_new=TP_NEW)
    assert tp_ranks[0][case] == tp_ranks[1][case] == want


# ---------------------------------------------------------------------------
# EngineServer and serve
# ---------------------------------------------------------------------------

def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def test_engine_server(tiny, jax_engine_tokens):
    """Sync and streamed /generate give the engine's tokens; /metrics and
    /health answer; a bad body and a text body answer 400."""
    _, _, c, params, _ = tiny
    eos, want = jax_engine_tokens
    eng = ContinuousBatchingEngine(
        params, dataclasses.replace(c, eos_token_id=eos), max_batch=2,
        max_len=MAX_LEN, compute_dtype=F32, device=CPU, block_steps=3,
        pipeline_blocks=True)
    server = EngineServer(eng)
    port = server.start(port=0)
    try:
        replies = [None, None]

        def ask(i):
            replies[i] = json.loads(_post(port, {
                "prompt": ENGINE_PROMPTS[i], "max_new_tokens": ENGINE_NEW}))

        threads = [threading.Thread(target=ask, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert [r["tokens"] for r in replies] == want["dense"][:2]
        lines = [json.loads(x) for x in _post(port, {
            "prompt": ENGINE_PROMPTS[3], "max_new_tokens": ENGINE_NEW,
            "stream": True}).splitlines() if x]
        assert [x["token"] for x in lines[:-1]] == want["dense"][3]
        assert lines[-1] == {"done": True, "tokens": want["dense"][3]}
        m = _get(port, "/metrics")
        assert m["completed_requests"] == 3 and m["queue_depth"] == 0
        assert _get(port, "/health") == {"ok": True}
        for bad in ({"max_new_tokens": 3}, {"text": "hello"},
                    {"prompt": [1, 2], "max_new_tokens": MAX_LEN}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, bad)
            assert e.value.code == 400
            error = json.loads(e.value.read())["error"]
            assert ("tokenizer" in error) == ("text" in bad), error
    finally:
        server.stop()


def test_engine_server_under_concurrent_requests(tiny, jax_engine_tokens):
    """Sixteen handler threads post at once, the interpreter switching
    threads every microsecond: every request gets the tokens of its prompt
    alone, and the engine counts each token once."""
    import sys
    _, _, c, params, _ = tiny
    eos, want = jax_engine_tokens
    eng = ContinuousBatchingEngine(
        params, dataclasses.replace(c, eos_token_id=eos), max_batch=2,
        max_len=MAX_LEN, compute_dtype=F32, device=CPU, block_steps=3,
        pipeline_blocks=True)
    server = EngineServer(eng)
    port = server.start(port=0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        replies = [None] * 16

        def ask(i):
            replies[i] = json.loads(_post(port, {
                "prompt": ENGINE_PROMPTS[1], "max_new_tokens": ENGINE_NEW,
                "stream": bool(i % 2)}).splitlines()[-1])["tokens"]

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(replies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert replies == [want["dense"][1]] * len(replies)
        m = _get(port, "/metrics")
        assert m["total_tokens"] == len(replies) * len(want["dense"][1])
        assert m["completed_requests"] == len(replies)
    finally:
        sys.setswitchinterval(interval)
        server.stop()


def test_serve_stdin_ids(tiny, tmp_path, monkeypatch, capsys):
    """``serve --block-steps 3 --pipeline-blocks`` on stdin lines of ids,
    run in-process: one JSON line a prompt, with the tokens of an engine
    that loads the same checkpoint here, one step a call."""
    from onebit_tpu_torch import cli, load_native
    from onebit_tpu_torch.ckpt.native import save_native
    _, _, c, params, _ = tiny
    save_native(str(tmp_path), c, params)
    loaded = load_native(str(tmp_path), device=CPU)
    want = _run(ContinuousBatchingEngine(
        loaded["params"], loaded["config"], max_batch=2, max_len=MAX_LEN,
        sampling=GREEDY, device=CPU))
    lines = "\n".join(",".join(map(str, p)) for p in ENGINE_PROMPTS)
    monkeypatch.setattr("sys.stdin", io.StringIO(lines + "\n\n"))
    cli.main(["serve", "--ckpt", str(tmp_path), "--max-batch", "2",
              "--max-len", str(MAX_LEN), "--max-new-tokens",
              str(ENGINE_NEW), "--greedy", "--block-steps", "3",
              "--pipeline-blocks", "--device", "cpu"])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    assert [o["prompt"] for o in out] == [",".join(map(str, p))
                                          for p in ENGINE_PROMPTS]
    assert [[int(t) for t in o["completion"].split(",")] for o in out] \
        == want


@pytest.mark.parametrize("flags,says", [
    (["--tokenizer", "tok"], "not ported yet"),
    (["--draft", "d"], "not ported yet"), (["--tp", "2"], "item 4"),
    (["--prefill-chunk", "16"], "item 5"),
    (["--paged", "--kv-quant", "fp8"], "item 5"),
    (["--dry-compile"], "not ported yet"),
    (["--prefix-cache"], "--prefix-cache requires --paged"),
    (["--kv-quant", "fp8"], "--kv-quant fp8 requires --paged"),
    (["--paged", "--kv-quant", "int4"], "dense-engine only")],
    ids=["tokenizer", "draft", "tp", "prefill_chunk", "fp8_pages",
         "dry_compile", "prefix_cache", "fp8_dense", "int4_paged"])
def test_serve_refusals(flags, says):
    """``serve`` exits nonzero before it loads anything: the JAX command's
    exclusions in its wording, and what waits, named."""
    from onebit_tpu_torch import cli
    with pytest.raises(SystemExit, match=says):
        cli.main(["serve", "--ckpt", "/nonexistent", *flags])
