"""The paged serving path of the port against the JAX package, at the tiny
config (2 layers) in fp32: ``paged_decode_step``, ``paged_prefill_rows``,
``paged_chunk_append_row`` and ``paged_chunked_prefill_row`` over float and
int8 pages, and ``ContinuousBatchingEngine(paged=True)`` end to end.

On the CPU the port's decode attention gathers the pages, as the JAX
package does by default; kernel B10 is held against that path on the card
(tests/test_torch_cuda.py). Tolerances: logits to 2e-4 on the active rows,
as tests/test_torch_model.py holds the dense path (another summation order
in every matmul); float pages to 2e-4 relative. Int8 page values may
differ by one step where the fp32 K/V of the two sides differ in the last
bits and land on either side of a rounding boundary (in under 1% of the
values). One such step moves a fresh key by absmax/127.5, its scores by
about 1e-2 and the logits by about 2e-3, and the next layer's K/V with
them: on int8 pages logits are held to 1e-2 and scales to 2e-3 relative
(the attention itself, on the same pages, agrees to 1e-6:
tests/test_torch_paged_attention.py). Greedy tokens must be equal off
near-ties of the JAX engine's logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.engine import batching as jbatching
from onebit_tpu.engine import paged as jpg
from onebit_tpu.engine.batching import ContinuousBatchingEngine as JaxEngine
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                              fuse_for_decode, host_random_packed_params,
                              init_paged_kv_cache, params_from_jax)
from onebit_tpu_torch.engine import paged as tpg
from onebit_tpu_torch.parallel.mesh import TPGroup

TOL = dict(rtol=2e-4, atol=2e-4)
QUANT_TOL = dict(rtol=1e-2, atol=1e-2)
PS, NUM_PAGES = 4, 24


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, port params), fused for
    decode on both sides, as the engines run them."""
    jc = JaxConfig.named("tiny")
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(3)))
    c = BitLlamaConfig.named("tiny")
    tp = fuse_for_decode(params_from_jax(jax.tree.map(np.asarray, jp), c,
                                         device="cpu"), c)
    return jc, jb.fuse_for_decode(jp, jc), c, tp


def _random_pools(c, quant, seed):
    """The same random pools as a JAX and a port cache."""
    rng = np.random.default_rng(seed)
    shape = (c.num_hidden_layers, NUM_PAGES, c.num_key_value_heads, PS,
             c.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if quant:
        leaves = [np.asarray(x) for x in (*jpg._quantize_kv_int8(k),
                                          *jpg._quantize_kv_int8(v))]
        jcls, tcls = jpg.QuantPagedKVCache, tpg.QuantPagedKVCache
    else:
        leaves, jcls, tcls = [k, v], jpg.PagedKVCache, tpg.PagedKVCache
    return (jcls(*map(jnp.asarray, leaves)),
            tcls(*(torch.from_numpy(a.copy()) for a in leaves)))


def _check_pools(tcache, jcache):
    rtol = 2e-3 if isinstance(tcache, tpg.QuantPagedKVCache) else 2e-4
    for name, got, want in zip(tcache._fields, tcache, jcache):
        want = np.asarray(want)
        if got.dtype == torch.int8:
            step = np.abs(got.numpy().astype(int) - want.astype(int))
            assert step.max() <= 1, name
            assert (step > 0).mean() < 0.01, name
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                       atol=2e-5, err_msg=name)


# page tables: permuted pages, an inactive row with an all-zero table
TABLES = np.array([[3, 7, 1, 9, 12], [5, 2, 8, 4, 20], [0, 0, 0, 0, 0],
                   [11, 6, 14, 17, 22]], np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_decode_step_matches_jax(models, quant):
    """Four ragged decode steps on random pools: rows at positions in
    different pages, one crossing a page edge, an inactive row on the null
    page."""
    jc, jp, c, tp = models
    jcache, tcache = _random_pools(c, quant, seed=1)
    lengths = np.array([2, 7, 5, 15], np.int32)
    live = np.array([True, True, False, True])
    rng = np.random.default_rng(2)
    tol = QUANT_TOL if quant else TOL
    for step in range(4):
        ids = rng.integers(0, c.vocab_size, (4, 1)).astype(np.int32)
        jl, jcache = jpg.paged_decode_step(
            jp, jcache, jnp.asarray(ids), jnp.asarray(lengths),
            jnp.asarray(TABLES), jc, impl="xla", compute_dtype=jnp.float32)
        tl, tcache = tpg.paged_decode_step(
            tp, tcache, torch.from_numpy(ids.astype(np.int64)), lengths,
            TABLES, c, compute_dtype=torch.float32)
        assert tl.shape == (4, 1, c.vocab_size)
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   err_msg=f"step {step}", **tol)
        _check_pools(tcache, jcache)
        lengths = lengths + live


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_prefill_rows_matches_jax(models, quant):
    """R = 2 prompts (one padded) into their pages, then two decode steps
    over what the prefill wrote."""
    jc, jp, c, tp = models
    jcache, tcache = _random_pools(c, quant, seed=3)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, c.vocab_size, (2, 16)).astype(np.int32)
    lens = np.array([13, 16], np.int32)
    tables = TABLES[[0, 3]]
    jl, jcache = jpg.paged_prefill_rows(
        jp, jcache, jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(tables),
        jc, impl="xla", compute_dtype=jnp.float32)
    tl, tcache = tpg.paged_prefill_rows(
        tp, tcache, torch.from_numpy(ids.astype(np.int64)),
        torch.from_numpy(lens), torch.from_numpy(tables), c,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_pools(tcache, jcache)
    tol = QUANT_TOL if quant else TOL
    for step in range(2):
        nxt = rng.integers(0, c.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = jpg.paged_decode_step(
            jp, jcache, jnp.asarray(nxt), jnp.asarray(lens),
            jnp.asarray(tables), jc, impl="xla", compute_dtype=jnp.float32)
        tl, tcache = tpg.paged_decode_step(
            tp, tcache, torch.from_numpy(nxt.astype(np.int64)), lens, tables,
            c, compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        lens = lens + 1


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_chunk_append_matches_jax(models, quant):
    """A 6-token chunk appended at position 9 of a row whose earlier pages
    hold random K/V (the chunk attends to them and to itself), then the
    chunked prefill loop over a 13-token prompt in chunks of 4 from
    position 4 (a prefix hit's suffix)."""
    jc, jp, c, tp = models
    jcache, tcache = _random_pools(c, quant, seed=5)
    rng = np.random.default_rng(6)
    chunk = np.zeros(8, np.int32)
    chunk[:6] = rng.integers(0, c.vocab_size, 6)
    row = TABLES[1]
    jl, jcache = jpg.paged_chunk_append_row(
        jp, jcache, jnp.asarray(chunk), jnp.int32(9), jnp.int32(6),
        jnp.asarray(row), jc, impl="xla", compute_dtype=jnp.float32)
    tl, tcache = tpg.paged_chunk_append_row(
        tp, tcache, chunk, 9, 6, row, c, compute_dtype=torch.float32)
    assert tl.shape == (c.vocab_size,)
    tol = QUANT_TOL if quant else TOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    _check_pools(tcache, jcache)

    prompt = rng.integers(0, c.vocab_size, 13).tolist()
    row = TABLES[3]
    jl, jcache = jpg.paged_chunked_prefill_row(
        jp, jcache, prompt, row, jc, chunk_size=4, impl="xla",
        compute_dtype=jnp.float32, start=4)
    tl, tcache = tpg.paged_chunked_prefill_row(
        tp, tcache, prompt, row, c, chunk_size=4,
        compute_dtype=torch.float32, start=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    _check_pools(tcache, jcache)


def _prompts():
    """Six prompts through four slots, buckets 32 and 64 (8-9 and 16
    pages of 4)."""
    rng = np.random.default_rng(1)
    return [rng.integers(3, 500, n).tolist() for n in (30, 9, 4, 40, 31, 12)]


def _record_gaps(monkeypatch, eng):
    """Run ``eng`` (a JAX engine) recording, for each token it emits, the
    gap between the two largest logits it was chosen from, per request uid:
    a row of each sample is emitted in the order of the sample's rows at
    admission, and at the slot's row in a decode step."""
    gaps, state = {}, {"decoding": False, "gaps": None, "next": 0}
    sample, emit, decode = jbatching.sample_token, eng._emit, eng._decode

    def sample_token(logits, *args):
        top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
        state["gaps"], state["next"] = top2[:, 1] - top2[:, 0], 0
        return sample(logits, *args)

    def _emit(slot, tok):
        row = slot if state["decoding"] else state["next"]
        state["next"] += 1
        gaps.setdefault(eng.slots[slot].uid, []).append(state["gaps"][row])
        emit(slot, tok)

    def _decode():
        state["decoding"] = True
        try:
            decode()
        finally:
            state["decoding"] = False

    monkeypatch.setattr(jbatching, "sample_token", sample_token)
    eng._emit, eng._decode = _emit, _decode
    return gaps


@pytest.mark.parametrize("kwargs", [
    dict(), dict(quantized_kv=True), dict(prefill_chunk_size=8),
    dict(quantized_kv=True, prefill_chunk_size=16)],
    ids=["float", "int8", "float_chunked", "int8_chunked"])
def test_greedy_tokens_equal_jax_engine(models, kwargs, monkeypatch):
    """Greedy tokens equal the JAX engine's, off near-ties: the two sides'
    logits agree to TOL (float pages) or QUANT_TOL (int8 pages, module
    docstring), so where the JAX engine's two largest logits lie within
    twice that of each other either token may come out, and the rows part
    there. Each request's tokens must be equal, or equal up to a first
    difference that falls on such a near-tie."""
    jc, jp, c, tp = models
    prompts, budgets = _prompts(), [6, 5, 8, 3, 4, 7]
    tie = 2 * (QUANT_TOL if kwargs.get("quantized_kv") else TOL)["atol"]

    def run(eng):
        uids = [eng.add_request(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        out = eng.run()
        return uids, [out[u] for u in uids]

    jax_eng = JaxEngine(jp, jc, max_batch=4, max_len=64, paged=True,
                        page_size=PS, compute_dtype=jnp.float32, **kwargs)
    gaps = _record_gaps(monkeypatch, jax_eng)
    uids, want = run(jax_eng)
    eng = ContinuousBatchingEngine(tp, c, max_batch=4, max_len=64,
                                   paged=True, page_size=PS,
                                   compute_dtype=torch.float32, device="cpu",
                                   **kwargs)
    assert type(eng.cache).__name__ == (
        "QuantPagedKVCache" if kwargs.get("quantized_kv") else "PagedKVCache")
    _, got = run(eng)
    for uid, g, w in zip(uids, got, want):
        first = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                     None)
        assert g == w or (first is not None and gaps[uid][first] < tie), \
            (uid, first, g, w)
    m = eng.metrics()
    assert m["free_pages"] == m["total_pages"] == 4 * 16
    assert eng.allocator.refcount == {} and not eng.page_tables.any()


def test_backpressure_and_unservable_requests(models):
    """A pool of 12 pages, room for one request at a time: the 33-token
    prompt (bucket 64, 16 pages) can never fit and fails at once with no
    tokens (the JAX engine's rule); the others wait for pages and finish
    with the JAX engine's tokens."""
    jc, jp, c, tp = models
    rng = np.random.default_rng(8)
    prompts = [rng.integers(3, 500, n).tolist() for n in (30, 33, 20, 5)]
    budgets = [4, 20, 6, 3]

    def run(eng):
        uids = [eng.add_request(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        out = eng.run()
        return [out[u] for u in uids], eng.metrics()

    want, jm = run(JaxEngine(jp, jc, max_batch=3, max_len=64, paged=True,
                             page_size=PS, num_pages=13,
                             compute_dtype=jnp.float32))
    got, m = run(ContinuousBatchingEngine(
        tp, c, max_batch=3, max_len=64, paged=True, page_size=PS,
        num_pages=13, compute_dtype=torch.float32, device="cpu"))
    assert got == want and got[1] == []
    assert m["free_pages"] == jm["free_pages"] == 12
    assert m["completed_requests"] == jm["completed_requests"] == 3


def test_init_paged_kv_cache():
    c = BitLlamaConfig.named("tiny")
    cache = init_paged_kv_cache(c, 9, 4, dtype=torch.float32, device="cpu")
    assert cache.k_pages.shape == (c.num_hidden_layers, 9,
                                   c.num_key_value_heads, 4, c.head_dim)
    assert cache.page_size == 4 and cache.num_pages == 9
    q = init_paged_kv_cache(c, 9, 4, quantized="int8", device="cpu")
    assert q.k_q.dtype == torch.int8 and q.k_s.shape[-1] == 1
    assert q.page_size == 4 and q.num_pages == 9
    with pytest.raises(NotImplementedError, match="fp8 pages"):
        init_paged_kv_cache(c, 9, 4, quantized="fp8", device="cpu")


def test_host_page_tables_are_checked(models):
    """B10 reads pages at the ids it is given: a table from the host with an
    id outside the pool is refused before anything runs."""
    _, _, c, tp = models
    cache = init_paged_kv_cache(c, 9, 4, dtype=torch.float32, device="cpu")
    for bad in ([[1, 9]], [[-1, 2]]):
        with pytest.raises(ValueError, match="page ids"):
            tpg.paged_decode_step(
                tp, cache, torch.zeros(1, 1, dtype=torch.long), [0],
                np.asarray(bad, np.int32), c, compute_dtype=torch.float32)
    assert not cache.k_pages.any()


@pytest.mark.parametrize("kwargs,error", [
    (dict(paged=True, quantized_kv="int4"), ValueError),
    (dict(paged=True, quantized_kv="fp8"), NotImplementedError),
    (dict(paged=True, block_steps=4), None),
    (dict(paged=True, block_steps=4, pipeline_blocks=True), None),
    (dict(paged=True, draft_params={}), ValueError),
    (dict(paged=True, block_steps=2,
          tp_group=TPGroup(None, 0, 2, torch.device("cpu"))), None)],
    ids=["int4", "fp8", "block_steps", "pipeline_blocks", "draft",
         "tp_group_block_steps"])
def test_paged_exclusions(kwargs, error):
    """Paged int4, and a draft without its config, raise the JAX engine's
    ValueError in its wording; fp8 pages, not ported yet, raise
    NotImplementedError (tests/test_torch_speculative.py serves paged
    targets with a draft). Paged
    decode blocks (``error`` None) are ported: the engine builds and, on
    one device, serves a request; a tensor-parallel rank's engine builds
    its eager blocks (tests/test_torch_blocks.py runs them over two
    ranks)."""
    c = BitLlamaConfig.named("tiny")
    if error is None:
        params = host_random_packed_params(c, seed=0, dtype=torch.float32,
                                           device="cpu")
        eng = ContinuousBatchingEngine(params, c, max_batch=2, max_len=64,
                                       compute_dtype=torch.float32,
                                       device="cpu", page_size=4, **kwargs)
        assert eng.block_steps == kwargs["block_steps"] and eng.paged
        assert eng._graph is None and eng.pipeline_blocks == kwargs.get(
            "pipeline_blocks", False)
        if "tp_group" in kwargs:
            assert eng._tp.block_steps == kwargs["block_steps"]
            return
        uid = eng.add_request([5, 6, 7], max_new_tokens=6)
        assert len(eng.run()[uid]) == 6
        assert len(eng.allocator.free) == eng.total_pages
        return
    with pytest.raises(error) as got:
        ContinuousBatchingEngine({}, c, device="cpu", **kwargs)
    if error is ValueError:
        with pytest.raises(ValueError) as want:
            JaxEngine({}, JaxConfig.named("tiny"), **kwargs)
        assert str(got.value) == str(want.value)
    else:
        assert "not ported yet" in str(got.value)
