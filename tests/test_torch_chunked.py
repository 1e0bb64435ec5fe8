"""Chunked prefill and the verify window of the port against the JAX
package, at the tiny config (2 layers) in fp32: ``chunk_append_row``,
``chunked_prefill_row`` and ``ragged_verify_window`` over the dense
``KVCache`` and the int8 ``QuantKVCacheKT``, ``paged_verify_window`` over
float pages, and ``ContinuousBatchingEngine(prefill_chunk_size=...)``
without pages against the port's bucketed engine.

Tolerances: logits to 2e-4, as tests/test_torch_model.py holds the dense
path (another summation order in every matmul); float pools and scales
to the same; int8 pool values within one step (the fp32 K/V of the two
sides may land on either side of a rounding boundary). Each JAX function runs once a case: no JAX engine runs here.

Positions at ``max_len`` or past it: JAX's scatter drops those writes (the
verify window of a row that fills the cache), and the port does too. A
chunk that runs past ``max_len`` is where the two part by design: JAX's
``dynamic_update_slice`` moves the whole chunk back over earlier prompt
positions, the port drops only the pad positions past the end
(ROADMAP.md §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.engine import paged as jpg
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model import kv_cache as jk
from onebit_tpu.model import ragged_decode as jrd
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                              fuse_for_decode, params_from_jax)
from onebit_tpu_torch.engine import paged as tpg
from onebit_tpu_torch.model import bitllama as tb
from onebit_tpu_torch.model import kv_cache as tk
from onebit_tpu_torch.model import ragged_decode as trd

TOL = dict(rtol=2e-4, atol=2e-4)
MAX_LEN = 64
B = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _random_cache(kind, c, seed):
    """The same random pools as a JAX and a port cache (float, or int8
    values with their scales)."""
    rng = np.random.default_rng(seed)
    L, nkv, hd = c.num_hidden_layers, c.num_key_value_heads, c.head_dim
    if kind == "dense":
        leaves = [rng.standard_normal((L, B, MAX_LEN, nkv, hd))
                  .astype(np.float32) for _ in range(2)]
        jcls, tcls = jb.KVCache, tb.KVCache
    else:
        leaves = [
            rng.integers(-127, 128, (L, B, nkv, hd, MAX_LEN)).astype(np.int8),
            (rng.random((L, B, nkv, MAX_LEN)) * 0.05).astype(np.float32),
            rng.integers(-127, 128, (L, B, MAX_LEN, nkv, hd)).astype(np.int8),
            (rng.random((L, B, MAX_LEN, nkv)) * 0.05).astype(np.float32)]
        jcls, tcls = jk.QuantKVCacheKT, tk.QuantKVCacheKT
    return (jcls(*map(jnp.asarray, leaves)),
            tcls(*(torch.from_numpy(a.copy()) for a in leaves)))


def _check_pools(tcache, jcache):
    for name, got, want in zip(tcache._fields, tcache, jcache):
        want = np.asarray(want)
        if got.dtype == torch.int8:
            step = np.abs(got.numpy().astype(int) - want.astype(int))
            assert step.max() <= 1, name
            assert (step > 0).mean() < 0.01, name
        else:
            np.testing.assert_allclose(got.numpy(), want, err_msg=name,
                                       **TOL)


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_chunk_append_row_matches_jax(models, kind):
    """One 16-token chunk, 11 of them valid, at position 20 of row 1: the
    last valid token's logits and every pool."""
    jc, jp, c, tp = models
    jcache, tcache = _random_cache(kind, c, seed=1)
    ids = np.random.default_rng(2).integers(0, c.vocab_size, 16)
    jl, jcache = jrd.chunk_append_row(
        jp, jcache, jnp.asarray(ids, jnp.int32), jnp.int32(20), jnp.int32(11),
        jnp.int32(1), jc, impl="xla", compute_dtype=jnp.float32)
    tl, tcache2 = trd.chunk_append_row(tp, tcache, ids, 20, 11, 1, c,
                                       compute_dtype=torch.float32)
    assert tcache2 is tcache and tl.shape == (c.vocab_size,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_pools(tcache, jcache)


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_chunked_prefill_row_matches_jax(models, kind):
    """A 37-token prompt in chunks of 16 (the last one 5 valid) into row 2,
    16 dividing max_len: the JAX and port host loops give the same logits
    and pools. On the dense cache the port's logits also equal its own
    unchunked prefill's (on the int8 one a later chunk attends the
    quantized keys of the earlier ones, the unchunked prefill the fp32
    ones)."""
    jc, jp, c, tp = models
    jcache, tcache = _random_cache(kind, c, seed=3)
    prompt = np.random.default_rng(4).integers(1, c.vocab_size, 37).tolist()
    jl, jcache = jrd.chunked_prefill_row(jp, jcache, prompt, 2, jc,
                                         chunk_size=16, impl="xla",
                                         compute_dtype=jnp.float32)
    tl, tcache = trd.chunked_prefill_row(tp, tcache, prompt, 2, c,
                                         chunk_size=16,
                                         compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_pools(tcache, jcache)
    if kind != "dense":
        return
    _, fresh = _random_cache(kind, c, seed=3)
    ul, _ = trd.prefill_row(tp, fresh, torch.tensor(prompt), 37, 2, c,
                            compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), ul.numpy(), **TOL)


def test_chunk_past_max_len_is_dropped_not_moved(models):
    """A 60-token prompt in chunks of 24: the third chunk starts at 48 and
    its pads run past max_len 64. JAX's dynamic_update_slice then writes
    the chunk at 40-63, over prompt positions 40-47, while rope and the
    mask keep the true start: its logits part from its own unchunked
    prefill. The port drops the pads past the end, and its logits equal
    its unchunked prefill's."""
    jc, jp, c, tp = models
    prompt = np.random.default_rng(5).integers(1, c.vocab_size, 60).tolist()
    jl, _ = jrd.chunked_prefill_row(
        jp, jb.init_kv_cache(jc, 1, MAX_LEN, dtype=jnp.float32), prompt, 0,
        jc, chunk_size=24, impl="xla", compute_dtype=jnp.float32)
    ids = np.zeros((1, MAX_LEN), np.int32)
    ids[0, :60] = prompt
    ju, _ = jrd.prefill_row(
        jp, jb.init_kv_cache(jc, 1, MAX_LEN, dtype=jnp.float32),
        jnp.asarray(ids[0]), jnp.int32(60), jnp.int32(0), jc, impl="xla",
        compute_dtype=jnp.float32)
    assert np.abs(np.asarray(jl) - np.asarray(ju)).max() > 1e-2
    tcache = tb.init_kv_cache(c, 1, MAX_LEN, dtype=torch.float32,
                              device="cpu")
    tl, tcache = trd.chunked_prefill_row(tp, tcache, prompt, 0, c,
                                         chunk_size=24,
                                         compute_dtype=torch.float32)
    fresh = tb.init_kv_cache(c, 1, MAX_LEN, dtype=torch.float32,
                             device="cpu")
    ul, fresh = trd.prefill_row(tp, fresh, torch.tensor(prompt), 60, 0, c,
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), ul.numpy(), **TOL)
    np.testing.assert_allclose(tcache.k[:, :, :60].numpy(),
                               fresh.k[:, :, :60].numpy(), **TOL)


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_ragged_verify_window_matches_jax(models, kind):
    """A 5-token window a row: row 0 mid-cache, row 1 filling the cache
    exactly (its last three positions at max_len and past it, their
    writes dropped on both sides), row 2 inactive. Logits of the active
    rows at every position, and every pool."""
    jc, jp, c, tp = models
    jcache, tcache = _random_cache(kind, c, seed=6)
    row_pos = np.array([9, MAX_LEN - 2, 30], np.int32)
    active = np.array([True, True, False])
    tokens = np.random.default_rng(7).integers(0, c.vocab_size, (B, 5))
    jl, jcache = jrd.ragged_verify_window(
        jp, jcache, jnp.asarray(tokens, jnp.int32), jnp.asarray(row_pos),
        jnp.asarray(active), jc, impl="xla", compute_dtype=jnp.float32)
    tl, tcache = trd.ragged_verify_window(
        tp, tcache, torch.from_numpy(tokens), row_pos, active, c,
        compute_dtype=torch.float32)
    assert tl.shape == (B, 5, c.vocab_size)
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               **TOL)
    _check_pools(tcache, jcache)


def test_paged_verify_window_matches_jax(models):
    """The paged twin over float pages of 4: one row whose window runs off
    its page table (those positions go to the null page 0 on both
    sides) and one mid-table."""
    jc, jp, c, tp = models
    rng = np.random.default_rng(8)
    shape = (c.num_hidden_layers, 24, c.num_key_value_heads, 4, c.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jcache = jpg.PagedKVCache(jnp.asarray(k), jnp.asarray(v))
    tcache = tpg.PagedKVCache(torch.from_numpy(k.copy()),
                              torch.from_numpy(v.copy()))
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    lengths = np.array([13, 9], np.int32)
    tokens = rng.integers(0, c.vocab_size, (2, 5))
    jl, jcache = jpg.paged_verify_window(
        jp, jcache, jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths),
        jnp.asarray(tables), jc, impl="xla", compute_dtype=jnp.float32)
    tl, tcache = tpg.paged_verify_window(tp, tcache, torch.from_numpy(tokens),
                                         lengths, tables, c,
                                         compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # page 0 takes the overshooting writes of row 0: which one lands is
    # the scatter's choice on either side
    for got, want in zip(tcache, jcache):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], **TOL)


@pytest.mark.parametrize("kv,chunk", [(False, 16), (True, 32), (False, 24)],
                         ids=["dense", "int8", "dense_past_end"])
def test_dense_chunked_engine_equals_bucketed(models, kv, chunk):
    """The engine with prefill_chunk_size and no pages gives the bucketed
    engine's greedy tokens (fp32), on the dense and the int8 KT cache;
    at 24 a chunk runs past max_len 64 and the tokens stay equal."""
    _, _, c, tp = models
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, c.vocab_size, n).tolist() for n in (40, 7, 19)]
    out = []
    for chunked in (chunk, None):
        eng = ContinuousBatchingEngine(tp, c, max_batch=2, max_len=MAX_LEN,
                                       compute_dtype=torch.float32,
                                       device="cpu", quantized_kv=kv,
                                       prefill_chunk_size=chunked)
        uids = [eng.add_request(p, max_new_tokens=MAX_LEN - len(p))
                if i == 0 else eng.add_request(p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        got = eng.run()
        out.append([got[u] for u in uids])
    assert out[0] == out[1]
    assert len(out[0][0]) == MAX_LEN - 40
