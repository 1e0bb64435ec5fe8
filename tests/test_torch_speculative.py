"""Speculative decoding in the port: the round against the JAX package, and
the engine with a draft against the port's own plain greedy engine, at the
tiny config (2 layers) in fp32 with one torch thread.

``spec_decode_round`` is held to JAX's on the same caches (emitted
tokens, counts and new positions exact), with a row whose window runs past
``max_len`` and an inactive row, once with the target as its own draft
(full acceptance) and once with a one-layer slice; ``_finalize``'s clamps
to JAX's on random rounds. No JAX engine runs here: the engines with a
draft (dense, int8 KT and paged targets, with and without chunked
prefill, a request that fills ``max_len`` exactly) must give the plain
greedy engine's tokens. The sampled round accepts every proposal when the
draft is the target, and its first emitted token follows the target's
warped distribution (a chi-square test over one round of 480 rows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.engine import speculative as jsp
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu.train import draft as jdraft
from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                              SamplingConfig, fuse_for_decode,
                              params_from_jax)
from onebit_tpu_torch.engine import speculative as tsp
from onebit_tpu_torch.engine.sampler import warp_logits
from onebit_tpu_torch.model import bitllama as tb
from onebit_tpu_torch.model import ragged_decode as trd
from onebit_tpu_torch.train import draft as tdraft

MAX_LEN = 32
F32 = torch.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, port params), fused for
    decode on both sides."""
    jc = JaxConfig.named("tiny")
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(3)))
    c = BitLlamaConfig.named("tiny")
    tp = fuse_for_decode(params_from_jax(jax.tree.map(np.asarray, jp), c,
                                         device="cpu"), c)
    return jc, jb.fuse_for_decode(jp, jc), c, tp


def _caches(c, n_layers_d, seed):
    """The same random dense target and draft caches, JAX's and the
    port's; a full-depth draft's holds the target's numbers."""
    rng = np.random.default_rng(seed)
    shape = (c.num_hidden_layers, 3, MAX_LEN, c.num_key_value_heads,
             c.head_dim)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    out = []
    for layers in (c.num_hidden_layers, n_layers_d):
        k, v = (a[c.num_hidden_layers - layers:] for a in kv)
        out.append((jb.KVCache(jnp.asarray(k), jnp.asarray(v)),
                    tb.KVCache(torch.from_numpy(k.copy()),
                               torch.from_numpy(v.copy()))))
    return out


@pytest.mark.parametrize("draft_layers", [2, 1], ids=["self", "slice"])
def test_spec_decode_round_matches_jax(models, draft_layers):
    """One greedy round of 4 proposals: row 0 mid-cache, row 1 at
    max_len - 2 (its window and the draft's last steps past the end),
    row 2 inactive; budgets 9, 2, 5. The draft is the target (every
    proposal accepted) or its one-layer slice."""
    jc, jp, c, tp = models
    jdc, jdp = jdraft.build_draft(jp, jc, draft_layers)
    tdc, tdp = tdraft.build_draft(tp, c, draft_layers)
    (jt, tt), (jd, td) = _caches(c, draft_layers, seed=1)
    tok = np.array([5, 9, 11], np.int32)
    pos = np.array([7, MAX_LEN - 2, 3], np.int32)
    active = np.array([True, True, False])
    budget = np.array([9, 2, 5], np.int32)
    want = jsp.spec_decode_round(
        jp, jdp, jt, jd, jnp.asarray(tok), jnp.asarray(pos),
        jnp.asarray(active), jnp.asarray(budget), jc, jdc, n_draft=4,
        impl="xla", compute_dtype=jnp.float32)
    got = tsp.spec_decode_round(tp, tdp, tt, td, tok, pos, active, budget, c,
                                tdc, n_draft=4, compute_dtype=F32)
    for name, g, w in zip(("emitted", "n_emit", "new_next", "new_pos"),
                          got[:4], want[:4]):
        w = np.asarray(w)
        if name == "emitted":      # tokens past a row's count are unused
            keep = np.arange(5)[None, :] < np.asarray(want[1])[:, None]
            g, w = g.numpy() * keep, w * keep
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=name)
    if draft_layers == 2:
        assert list(got[1].numpy()) == [5, 2, 0]
    np.testing.assert_allclose(tt.k.numpy(), np.asarray(want[4].k),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(td.k.numpy(), np.asarray(want[5].k),
                               rtol=2e-4, atol=2e-4)


def test_finalize_clamps_match_jax():
    """EOS inside and past a row's count, budgets 0-6, inactive rows:
    _finalize's counts, next tokens and positions are JAX's."""
    rng = np.random.default_rng(2)
    eos = 2
    emitted = rng.integers(0, 5, (64, 5)).astype(np.int32)
    n_emit = rng.integers(1, 6, 64).astype(np.int32)
    next_token = rng.integers(0, 50, 64).astype(np.int32)
    row_pos = rng.integers(0, 30, 64).astype(np.int32)
    active = rng.random(64) < 0.8
    budget = rng.integers(-1, 7, 64).astype(np.int32)
    want = jsp._finalize(*map(jnp.asarray, (emitted, n_emit, next_token,
                                            row_pos, active, budget)),
                         jnp.int32(eos))
    got = tsp._finalize(*(torch.from_numpy(np.asarray(a)).long()
                          if a.dtype != bool else torch.from_numpy(a)
                          for a in (emitted, n_emit, next_token, row_pos,
                                    active, budget)), eos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _run(eng, prompts, news):
    uids = [eng.add_request(p, max_new_tokens=n)
            for p, n in zip(prompts, news)]
    out = eng.run()
    return [out[u] for u in uids]


CASES = {
    "dense": {}, "int8": dict(quantized_kv=True),
    "paged": dict(paged=True, page_size=8),
    "dense_chunked": dict(prefill_chunk_size=8),
    "int8_chunked": dict(quantized_kv=True, prefill_chunk_size=16),
    "paged_chunked": dict(paged=True, page_size=8, prefill_chunk_size=8),
    "paged_prefix": dict(paged=True, page_size=4, prefix_cache=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_engine_equals_plain_greedy(models, case):
    """Greedy speculative engines (a one-layer draft, 3 proposals) give the
    plain engine's tokens; the first request fills max_len exactly, and
    with the prefix cache two prompts share their first pages."""
    _, _, c, tp = models
    d_config, d_params = tdraft.build_draft(tp, c, 1)
    rng = np.random.default_rng(4)
    shared = rng.integers(1, c.vocab_size, 9).tolist()
    prompts = [rng.integers(1, c.vocab_size, 6).tolist(),
               shared + [7, 8], shared + [9],
               rng.integers(1, c.vocab_size, 13).tolist()]
    news = [MAX_LEN - 6, 7, 5, 9]
    kw = dict(max_batch=2, max_len=MAX_LEN, compute_dtype=F32, device="cpu",
              **CASES[case])
    want = _run(ContinuousBatchingEngine(tp, c, **kw), prompts, news)
    eng = ContinuousBatchingEngine(tp, c, draft_params=d_params,
                                   draft_config=d_config, n_draft=3, **kw)
    eng.warmup()
    assert _run(eng, prompts, news) == want
    assert len(want[0]) == MAX_LEN - 6
    assert 0 < eng.spec_rounds < sum(news)
    if eng.paged:
        held = eng.metrics().get("prefix_cache_entries", 0)
        assert len(eng.allocator.free) == eng.total_pages - held


def test_sampled_round_accepts_all_when_draft_is_target(models):
    """draft = target: p/q = 1 up to rounding, so each active row emits
    n_draft + 1 tokens unless an EOS or its budget stops it."""
    _, _, c, tp = models
    caches = [tb.init_kv_cache(c, 3, MAX_LEN, dtype=F32, device="cpu")
              for _ in range(2)]
    ids = torch.tensor([[5, 6, 7, 8]] * 3)
    for cache in caches:
        trd.prefill_rows(tp, cache, ids, torch.tensor([4, 3, 2]),
                         torch.arange(3), c, compute_dtype=F32)
    gen = torch.Generator().manual_seed(0)
    emitted, n_emit, _, new_pos, *_ = tsp.spec_decode_round_sampled(
        tp, tp, *caches, np.array([9, 10, 11]), np.array([4, 3, 2]),
        np.ones(3, bool), np.full(3, 100), gen, c, c, n_draft=4,
        sampling=SamplingConfig(temperature=0.9), compute_dtype=F32)
    for r in range(3):
        row = emitted[r, :n_emit[r]].tolist()
        if c.eos_token_id not in row:
            assert n_emit[r] == 5, (r, row)
    assert new_pos.tolist() == (np.array([4, 3, 2]) + n_emit.numpy()).tolist()


def test_sampled_first_token_follows_the_target(models):
    """480 rows with one context, a one-layer draft, temperature 0.7 and
    top-k 8: the first token one sampled round emits is a draw from the
    target's warped distribution p. Chi-square of the counts against
    480 p over the 8 tokens (7 degrees of freedom) must stay under 24.32,
    the 0.001 quantile; the draft's own distribution q, the wrong
    answer, is far beyond it."""
    _, _, c, tp = models
    d_config, d_params = tdraft.build_draft(tp, c, 1)
    b = 480
    sampling = SamplingConfig(temperature=0.7, top_k=8)
    prompt = torch.tensor([[5, 17, 42, 9]]).repeat(b, 1)
    lens, rows = torch.full((b,), 4), torch.arange(b)
    t_cache = tb.init_kv_cache(c, b, 16, dtype=F32, device="cpu")
    d_cache = tb.init_kv_cache(d_config, b, 16, dtype=F32, device="cpu")
    logits, _ = trd.prefill_rows(tp, t_cache, prompt[:1], lens[:1],
                                 rows[:1], c, compute_dtype=F32)
    trd.prefill_rows(tp, t_cache, prompt, lens, rows, c, compute_dtype=F32)
    trd.prefill_rows(d_params, d_cache, prompt, lens, rows, d_config,
                     compute_dtype=F32)
    # the pending token is the prompt's greedy next: the round's first
    # emitted token is the distribution after it
    pending = int(logits[0].argmax())
    cache1 = tb.init_kv_cache(c, 1, 16, dtype=F32, device="cpu")
    trd.prefill_rows(tp, cache1, prompt[:1], lens[:1], rows[:1], c,
                     compute_dtype=F32)
    step, _ = trd.ragged_decode_step(tp, cache1, torch.tensor([[pending]]),
                                     np.array([4]), np.array([True]), c,
                                     compute_dtype=F32)
    p = torch.softmax(warp_logits(step[0, 0], sampling), -1).numpy()
    gen = torch.Generator().manual_seed(1)
    emitted, n_emit, *_ = tsp.spec_decode_round_sampled(
        tp, d_params, t_cache, d_cache, np.full(b, pending),
        np.full(b, 4), np.ones(b, bool), np.full(b, 100), gen, c, d_config,
        n_draft=3, sampling=sampling, compute_dtype=F32)
    assert (n_emit >= 1).all()
    support = np.flatnonzero(p > 0)
    assert len(support) == 8
    counts = np.bincount(emitted[:, 0].numpy(), minlength=c.vocab_size)
    assert counts[support].sum() == b
    chi2 = ((counts[support] - b * p[support]) ** 2 / (b * p[support])).sum()
    assert chi2 < 24.32, (chi2, counts[support], b * p[support])


def test_sampled_engine_stops_at_budget_or_eos(models):
    """A sampled speculative engine over paged int8 pages: every request
    ends at its budget or at its first EOS (made a frequent token)."""
    _, _, c, tp = models
    d_config, d_params = tdraft.build_draft(tp, c, 1)
    eos = 7
    c7 = dataclasses.replace(c, eos_token_id=eos)
    eng = ContinuousBatchingEngine(
        tp, c7, max_batch=2, max_len=MAX_LEN, compute_dtype=F32,
        device="cpu", paged=True, page_size=8, quantized_kv=True,
        draft_params=d_params, draft_config=d_config, n_draft=3,
        sampling=SamplingConfig(temperature=0.9), seed=5)
    prompts = [[5, 17, 42], [9, 4], [3, 3, 3, 3], [11]]
    news = [9, 5, 12, 20]
    out = _run(eng, prompts, news)
    for toks, cap in zip(out, news):
        assert 0 < len(toks) <= cap
        assert eos not in toks[:-1]
        assert len(toks) == cap or toks[-1] == eos


def test_draft_options_refused_as_in_jax(models):
    """draft_params without draft_config, int4 with a draft, decode blocks
    and pipelining with a draft: the JAX engine's ValueErrors."""
    _, _, c, tp = models
    for kw, says in ((dict(), "requires draft_config"),
                     (dict(draft_config=c, quantized_kv="int4"), "int4"),
                     (dict(draft_config=c, block_steps=4),
                      "mutually exclusive"),
                     (dict(draft_config=c, block_steps=4,
                           pipeline_blocks=True), "pipeline_blocks")):
        with pytest.raises(ValueError, match=says):
            ContinuousBatchingEngine(tp, c, device="cpu", draft_params=tp,
                                     **kw)
