"""The paged serving path of the port against the JAX package, at the tiny
config (2 layers) in fp32: ``paged_decode_step``, ``paged_prefill_rows``,
``paged_chunk_append_row`` and ``paged_chunked_prefill_row`` over float,
int8 and fp8 e4m3 pages, and ``ContinuousBatchingEngine(paged=True)`` end
to end.

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
tests/test_torch_paged_attention.py). fp8 pages hold JAX's bytes
(compared through ``uint8`` views) after the batched prefill and the
decode steps, and their logits are held to 2e-4 there: with the same
bytes both sides attend over the same values. An fp32 K/V within the two
sides' difference (a few 1e-7) of an fp8 rounding midpoint may round
either way, as int8 values may: the chunk append's window meets one in
layer 0 (-0.16406249 in JAX, -0.16406262 here, about the midpoint
-0.1640625), so there fp8 bytes may differ in under 1% of the values, by
one step in layer 0 and by what that step moves in the next layer (two
steps there, 0.03125 against 0.02734375), and logits are held to 1e-2, as
on int8 pages. Greedy tokens must be equal off near-ties of the JAX
engine's logits (1e-2 on int8 and fp8 pages).
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
    if quant == "fp8":
        leaves = [np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn))
                  for x in (k, v)]
        return (jpg.PagedKVCache(*map(jnp.asarray, leaves)),
                tpg.PagedKVCache(*(_fp8_tensor(a) for a in leaves)))
    if quant:
        leaves = [np.asarray(x) for x in (*jpg._quantize_kv_int8(k),
                                          *jpg._quantize_kv_int8(v))]
        jcls, tcls = jpg.QuantPagedKVCache, tpg.QuantPagedKVCache
    else:
        leaves, jcls, tcls = [k, v], jpg.PagedKVCache, tpg.PagedKVCache
    return (jcls(*map(jnp.asarray, leaves)),
            tcls(*(torch.from_numpy(a.copy()) for a in leaves)))


def _fp8_tensor(a) -> torch.Tensor:
    """A JAX/ml_dtypes float8_e4m3fn array as a torch tensor of the same
    bytes."""
    return torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(
        torch.float8_e4m3fn)


def _check_pools(tcache, jcache, exact_fp8=True):
    """Pools against JAX's: float pages to 2e-4, int8 values within one
    step in under 1% of them and their scales to 2e-3, fp8 pages byte for
    byte (``exact_fp8``) or else differing in under 1% of the bytes, by at
    most one step in layer 0 (module docstring)."""
    rtol = 2e-3 if isinstance(tcache, tpg.QuantPagedKVCache) else 2e-4
    for name, got, want in zip(tcache._fields, tcache, jcache):
        want = np.asarray(want)
        if got.dtype == torch.float8_e4m3fn:
            # neighbouring fp8 values of one sign: neighbouring bytes
            step = np.abs(got.view(torch.int8).numpy().astype(int)
                          - want.view(np.int8).astype(int))
            if exact_fp8:
                assert step.max() == 0, (name, np.argwhere(step))
            assert step[0].max() <= 1 and (step > 0).mean() < 0.01, name
        elif got.dtype == torch.int8:
            step = np.abs(got.numpy().astype(int) - want.astype(int))
            assert step.max() <= 1, name
            assert (step > 0).mean() < 0.01, name
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                       atol=2e-5, err_msg=name)


# page tables: permuted pages, an inactive row with an all-zero table
TABLES = np.array([[3, 7, 1, 9, 12], [5, 2, 8, 4, 20], [0, 0, 0, 0, 0],
                   [11, 6, 14, 17, 22]], np.int32)


@pytest.mark.parametrize("quant", [False, True, "fp8"],
                         ids=["float", "int8", "fp8"])
def test_paged_decode_step_matches_jax(models, quant):
    """Four ragged decode steps on random pools: rows at positions in
    different pages, one crossing a page edge, an inactive row on the null
    page."""
    jc, jp, c, tp = models
    jcache, tcache = _random_pools(c, quant, seed=1)
    lengths = np.array([2, 7, 5, 15], np.int32)
    live = np.array([True, True, False, True])
    rng = np.random.default_rng(2)
    tol = QUANT_TOL if quant is True else TOL
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


@pytest.mark.parametrize("quant", [False, True, "fp8"],
                         ids=["float", "int8", "fp8"])
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
    tol = QUANT_TOL if quant is True else TOL
    for step in range(2):
        nxt = rng.integers(0, c.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = jpg.paged_decode_step(
            jp, jcache, jnp.asarray(nxt), jnp.asarray(lens),
            jnp.asarray(tables), jc, impl="xla", compute_dtype=jnp.float32)
        tl, tcache = tpg.paged_decode_step(
            tp, tcache, torch.from_numpy(nxt.astype(np.int64)), lens, tables,
            c, compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        _check_pools(tcache, jcache)
        lens = lens + 1


@pytest.mark.parametrize("quant", [False, True, "fp8"],
                         ids=["float", "int8", "fp8"])
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
    # fp8: a K value at a rounding midpoint (module docstring)
    tol = QUANT_TOL if quant else TOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    _check_pools(tcache, jcache, exact_fp8=False)

    prompt = rng.integers(0, c.vocab_size, 13).tolist()
    row = TABLES[3]
    jl, jcache = jpg.paged_chunked_prefill_row(
        jp, jcache, prompt, row, jc, chunk_size=4, impl="xla",
        compute_dtype=jnp.float32, start=4)
    tl, tcache = tpg.paged_chunked_prefill_row(
        tp, tcache, prompt, row, c, chunk_size=4,
        compute_dtype=torch.float32, start=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    _check_pools(tcache, jcache, exact_fp8=False)


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
    dict(quantized_kv=True, prefill_chunk_size=16), dict(quantized_kv="fp8"),
    dict(quantized_kv="fp8", prefill_chunk_size=8)],
    ids=["float", "int8", "float_chunked", "int8_chunked", "fp8",
         "fp8_chunked"])
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
        "QuantPagedKVCache" if kwargs.get("quantized_kv") is True
        else "PagedKVCache")
    if kwargs.get("quantized_kv") == "fp8":
        assert eng.cache.k_pages.dtype == torch.float8_e4m3fn
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
    f8 = init_paged_kv_cache(c, 9, 4, quantized="fp8", device="cpu")
    assert isinstance(f8, tpg.PagedKVCache)
    assert f8.k_pages.dtype == f8.v_pages.dtype == torch.float8_e4m3fn
    assert f8.k_pages.shape == cache.k_pages.shape
    assert not f8.k_pages.view(torch.uint8).any()


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
    (dict(paged=True, quantized_kv="fp8"), None),
    (dict(paged=True, block_steps=4), None),
    (dict(paged=True, block_steps=4, pipeline_blocks=True), None),
    (dict(paged=True, draft_params={}), ValueError),
    (dict(paged=True, block_steps=2,
          tp_group=TPGroup(None, 0, 2, torch.device("cpu"))), None)],
    ids=["int4", "fp8", "block_steps", "pipeline_blocks", "draft",
         "tp_group_block_steps"])
def test_paged_exclusions(kwargs, error):
    """Paged int4, and a draft without its config, raise the JAX engine's
    ValueError in its wording (tests/test_torch_speculative.py serves paged
    targets with a draft). fp8 pages and paged decode blocks (``error``
    None) are ported: the engine builds and, on one device, serves a
    request; a tensor-parallel rank's engine builds its eager blocks
    (tests/test_torch_blocks.py runs them over two ranks)."""
    c = BitLlamaConfig.named("tiny")
    if error is None:
        params = host_random_packed_params(c, seed=0, dtype=torch.float32,
                                           device="cpu")
        eng = ContinuousBatchingEngine(params, c, max_batch=2, max_len=64,
                                       compute_dtype=torch.float32,
                                       device="cpu", page_size=4, **kwargs)
        assert eng.block_steps == kwargs.get("block_steps", 1) and eng.paged
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
    with pytest.raises(ValueError) as want:
        JaxEngine({}, JaxConfig.named("tiny"), **kwargs)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# fp8 e4m3 pages: the bytes of JAX's astype, and the engine's options
# ---------------------------------------------------------------------------

def _fp8_edge_values(dtype):
    """Ties between fp8 neighbours (normal and subnormal), subnormals,
    values past 448 (rounding to it up to 464, NaN beyond), NaN and
    infinities of both signs, then random values over the whole range."""
    edges = [0.0, -0.0, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10, 2.0 ** -12,
             2.0 ** -7, 1.0625, 1.1875, -1.0625, 0.0146484375, 240.0, 232.0,
             248.0, 448.0, 449.0, 456.0, 460.0, 464.0, 465.0, 480.0, 500.0,
             -464.0, -465.0, 1e6, float("inf"), float("-inf"), float("nan"),
             -float("nan")]
    rng = np.random.default_rng(8)
    rand = rng.standard_normal(4096) * np.exp2(rng.integers(-10, 10, 4096))
    return torch.tensor(edges + rand.tolist(), dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fp8_pages_hold_jax_bytes(dtype):
    """A page write (``_write_pages``) stores the bytes of JAX's
    ``k.astype(float8_e4m3fn)`` (``onebit_tpu/engine/paged.py:421-422``),
    ties, subnormals, values past 448 and NaN included, where torch's own
    conversion saturates instead; the other slots keep theirs."""
    c = BitLlamaConfig.named("tiny")
    x = _fp8_edge_values(dtype)
    want = np.asarray(jnp.asarray(np.asarray(x.float())).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32).astype(
            jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(tpg._to_fp8(x).view(torch.uint8).numpy(),
                                  want)
    hd, nkv = c.head_dim, c.num_key_value_heads
    n = x.numel() // (nkv * hd)
    k = x[:n * nkv * hd].reshape(1, n, nkv, hd)
    v = -k
    cache = init_paged_kv_cache(c, 9, 4, quantized="fp8", device="cpu")
    before = cache.k_pages.view(torch.uint8).clone()
    pos = torch.arange(n)
    pages, slots = (1 + pos // 4)[None], (pos % 4)[None]
    tpg._write_pages(cache, 1, pages, slots, k, v)
    for leaf, val in zip(cache, (k, v)):
        got = leaf[1].view(torch.uint8)[pages[0], :, slots[0]]
        np.testing.assert_array_equal(
            got.numpy(), tpg._to_fp8(val[0]).view(torch.uint8).numpy())
    assert torch.equal(cache.k_pages.view(torch.uint8)[0], before[0])


SHARED = [7, 7, 7, 7, 7, 7, 7, 7, 2]          # two full pages of 4


@pytest.mark.parametrize("kwargs", [
    dict(prefix_cache=True), dict(block_steps=3, pipeline_blocks=True),
    dict(draft="self", n_draft=2)],
    ids=["prefix_cache", "blocks", "speculative"])
def test_fp8_engine_options_match_jax(models, kwargs):
    """fp8 pages under the engine's options, against the JAX engine with
    the same options: prefix-cache hits (the suffix chunk-appended onto
    shared fp8 pages), pipelined decode blocks, and a speculative round
    whose verify window attends the fp8 pages (the draft: the target
    itself). Greedy tokens equal JAX's; every page comes back."""
    jc, jp, c, tp = models
    prompts = [SHARED + [i] for i in range(3)] + [[5, 17, 42, 9]]
    opts = dict(max_batch=2, max_len=64, paged=True, page_size=PS,
                quantized_kv="fp8")
    jopts, topts = dict(kwargs), dict(kwargs)
    if kwargs.get("draft"):
        del jopts["draft"], topts["draft"]
        jopts.update(draft_params=jp, draft_config=jc)
        topts.update(draft_params=tp, draft_config=c)

    def run(eng):
        uids = [eng.add_request(p, max_new_tokens=5) for p in prompts]
        out = eng.run()
        return [out[u] for u in uids]

    want = run(JaxEngine(jp, jc, compute_dtype=jnp.float32, **opts, **jopts))
    eng = ContinuousBatchingEngine(tp, c, compute_dtype=torch.float32,
                                   device="cpu", **opts, **topts)
    assert run(eng) == want
    if kwargs.get("prefix_cache"):
        assert eng.prefix_hits > 0
    m = eng.metrics()
    assert m["free_pages"] == m["total_pages"] - m.get(
        "prefix_cache_entries", 0)
