"""The port's continuous-batching engine and sampler against the JAX
package: greedy tokens must be exactly equal on the same weights; sampling
is held to the warped distribution, since torch and jax random streams
differ."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.engine.batching import ContinuousBatchingEngine as JaxEngine
from onebit_tpu.engine.sampler import SamplingConfig as JaxSampling
from onebit_tpu.engine.sampler import warp_logits as jax_warp
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                              SamplingConfig, fuse_for_decode,
                              host_random_packed_params, params_from_jax)
from onebit_tpu_torch.engine.batching import _bucket
from onebit_tpu_torch.engine.sampler import sample_token, warp_logits
from onebit_tpu_torch.model.bitllama import init_kv_cache
from onebit_tpu_torch.parallel.mesh import TPGroup


def _prompts():
    rng = np.random.default_rng(0)
    # two prompts past 128 tokens share bucket 256: a 512-row prefill that
    # runs the large-M kernel's plain version; the rest take small-M
    return [rng.integers(3, 500, n).tolist()
            for n in (150, 140, 4, 2, 31, 9)]


@pytest.mark.parametrize("nkv", [2, 4], ids=["gqa_unfused_qkv", "mha_fused"])
def test_greedy_tokens_equal_jax_engine(nkv):
    """Six requests through four slots (admission as slots free up, buckets
    32 and 256): every token equal. Then an EOS stop on the port's side."""
    jc = JaxConfig.named("tiny", num_key_value_heads=nkv)
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(7)))
    c = BitLlamaConfig.named("tiny", num_key_value_heads=nkv)
    tp = fuse_for_decode(params_from_jax(jax.tree.map(np.asarray, jp), c,
                                         device="cpu"), c)
    jp = jb.fuse_for_decode(jp, jc)
    prompts, budgets = _prompts(), [6, 5, 8, 3, 4, 7]

    def run(eng):
        uids = [eng.add_request(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        out = eng.run()
        return [out[u] for u in uids]

    want = run(JaxEngine(jp, jc, max_batch=4, max_len=256,
                         compute_dtype=jnp.float32))
    got = run(ContinuousBatchingEngine(tp, c, max_batch=4, max_len=256,
                                       compute_dtype=torch.float32,
                                       device="cpu"))
    assert got == want
    # stop on EOS: a token the first request emits mid-run becomes the EOS;
    # every request then ends at its first EOS, as the JAX engine ends it
    eos = want[0][2]
    got_e = run(ContinuousBatchingEngine(
        tp, dataclasses.replace(c, eos_token_id=eos), max_batch=4,
        max_len=256, compute_dtype=torch.float32, device="cpu"))
    assert got_e == [w[:w.index(eos) + 1] if eos in w else w for w in want]
    assert len(got_e[0]) == 3


def test_bucket_and_streaming_callbacks():
    assert [_bucket(n) for n in (1, 32, 33, 129)] == [32, 32, 64, 256]
    c = BitLlamaConfig.named("tiny", num_hidden_layers=1)
    params = host_random_packed_params(c, seed=0, dtype=torch.float32,
                                       device="cpu")
    eng = ContinuousBatchingEngine(params, c, max_batch=2, max_len=64,
                                   compute_dtype=torch.float32, device="cpu")
    seen, done = [], []
    uid = eng.add_request([5, 6, 7], max_new_tokens=4, on_token=seen.append,
                          on_done=lambda: done.append(True))
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(list(range(60)), max_new_tokens=10)
    out = eng.run()
    assert out[uid] == seen and len(seen) == 4 and done == [True]
    m = eng.metrics()
    assert m["completed_requests"] == 1 and m["total_tokens"] == 4
    assert m["ttft_p50_s"] >= 0 and m["tpot_p50_s"] >= 0


@pytest.mark.parametrize("kwargs", [
    pytest.param(dict(paged=True, quantized_kv="fp8"), id="kwargs0-item 5"),
    pytest.param(dict(draft_params="self"), id="kwargs1-item 5"),
    pytest.param(dict(tp_group=TPGroup(None, 0, 2, torch.device("cpu")),
                      prefill_chunk_size=64), id="kwargs2-item 5"),
    pytest.param(dict(prefill_chunk_size=64), id="kwargs3-item 5"),
    pytest.param(dict(block_steps=4), id="kwargs4-None"),
    pytest.param(dict(block_steps=4, pipeline_blocks=True),
                 id="kwargs5-None"),
    pytest.param(dict(paged=True, prefix_cache=True, draft_params="self"),
                 id="kwargs6-item 5")])
def test_unported_options_raise(kwargs):
    """Every option of the JAX engine is ported: fp8 pages, decode
    blocks, dense chunked prefill and a draft (the target itself,
    ``draft_params="self"``) build and serve a request; a tensor-parallel
    rank's engine with chunked prefill builds (tests/test_torch_tp.py
    serves through it over two ranks). The ids are those of the cases
    when they waited."""
    c = BitLlamaConfig.named("tiny")
    params = host_random_packed_params(c, seed=0, dtype=torch.float32,
                                       device="cpu")
    if kwargs.get("draft_params") == "self":
        kwargs = dict(kwargs, draft_params=params, draft_config=c)
    eng = ContinuousBatchingEngine(params, c, max_batch=2, max_len=64,
                                   compute_dtype=torch.float32, device="cpu",
                                   **kwargs)
    assert eng.block_steps == kwargs.get("block_steps", 1)
    assert eng.prefill_chunk_size == kwargs.get("prefill_chunk_size")
    assert eng.pipeline_blocks == kwargs.get("pipeline_blocks", False)
    if "tp_group" in kwargs:
        assert eng._tp is not None
        return
    if kwargs.get("quantized_kv") == "fp8":
        assert eng.cache.k_pages.dtype == torch.float8_e4m3fn
    uid = eng.add_request([5, 6, 7], max_new_tokens=6)
    assert len(eng.run()[uid]) == 6
    # the first token comes from the prefill; a draft that is the target
    # has every proposal accepted, so one round of 4 gives the other 5
    assert eng.spec_rounds == (1 if "draft_params" in kwargs else 0)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without device="cpu" every entry point asks for CUDA and raises when
    no card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = BitLlamaConfig.named("tiny", num_hidden_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        host_random_packed_params(c)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(c, 1, 16)
    params = host_random_packed_params(c, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(params, c)
    jc = JaxConfig.named("tiny", num_hidden_layers=1)
    tree = jax.tree.map(np.asarray, jb.pack_model_params(
        jb.init_params(jc, jax.random.PRNGKey(0))))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(tree, c)


@pytest.mark.parametrize("cfg", [
    dict(temperature=0.7), dict(temperature=1.3, top_k=5),
    dict(top_p=0.8), dict(temperature=0.9, top_k=20, top_p=0.6)])
def test_warp_logits_matches_jax(cfg):
    logits = np.random.default_rng(1).standard_normal((3, 50)).astype(
        np.float32) * 2
    want = np.asarray(jax_warp(jnp.asarray(logits), JaxSampling(**cfg)))
    got = warp_logits(torch.from_numpy(logits), SamplingConfig(**cfg)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-6, atol=1e-6)


def test_sampling_follows_warped_distribution():
    """40000 draws at top-k 8 and temperature 0.8: each token's frequency
    lies within 5 standard errors of the JAX-warped softmax probability,
    and excluded tokens never appear."""
    logits = np.random.default_rng(2).standard_normal(40).astype(np.float32)
    cfg = dict(temperature=0.8, top_k=8)
    probs = np.asarray(jax.nn.softmax(jax_warp(jnp.asarray(logits),
                                               JaxSampling(**cfg))))
    n = 40000
    gen = torch.Generator().manual_seed(0)
    toks = sample_token(torch.from_numpy(logits).expand(n, 40), gen,
                        SamplingConfig(**cfg)).numpy()
    freq = np.bincount(toks, minlength=40) / n
    assert (freq[probs == 0] == 0).all()
    se = np.sqrt(probs * (1 - probs) / n)
    assert (np.abs(freq - probs) <= 5 * se + 1e-9).all()
    greedy = sample_token(torch.from_numpy(logits)[None], gen,
                          SamplingConfig(greedy=True))
    assert int(greedy[0]) == int(np.argmax(logits))
