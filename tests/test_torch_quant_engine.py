"""The quantized-KV serving path of the port against the JAX package, at the
tiny config (2 layers) in fp32: ``ragged_decode_step`` and ``prefill_rows``
over the int8 (``QuantKVCacheKT``) and int4 (``QuantKVCacheKT4``) pools,
and ``ContinuousBatchingEngine(quantized_kv=True | "int4")`` end to end.

The ``max_len``s run both JAX branches: 64 takes its short-cache fallback
(plain scatters and ``_attention_quant``), 128 (int8) and 256 (int4) its
Pallas kernels in interpret mode. The port has one path for all of them.

Tolerances: logits to 2e-4 on the active rows, as tests/test_torch_model.py
holds the dense path (another summation order in every matmul). Quantized
pool values may differ by one step, where the fp32 k/v of the two sides
differ in the last bits and land on either side of a rounding boundary;
scales to 2e-4 relative. Greedy tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.engine.batching import ContinuousBatchingEngine as JaxEngine
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model import kv_cache as jk
from onebit_tpu.model import ragged_decode as jrd
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                              fuse_for_decode, params_from_jax)
from onebit_tpu_torch.model import kv_cache as tk
from onebit_tpu_torch.model import ragged_decode as trd

TOL = dict(rtol=2e-4, atol=2e-4)


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


def _random_cache(kind, c, batch, max_len, seed):
    """The same random pools as a JAX and a port cache: int8 values, or
    int4 values packed (both nibbles live, so a merge that loses the
    partner nibble shows)."""
    rng = np.random.default_rng(seed)
    L, nkv, hd = c.num_hidden_layers, c.num_key_value_heads, c.head_dim
    lo, hi = (-7, 8) if kind == "int4" else (-127, 128)
    k = rng.integers(lo, hi, (L, batch, nkv, hd, max_len)).astype(np.int8)
    v = rng.integers(lo, hi, (L, batch, max_len, nkv, hd)).astype(np.int8)
    ks = (rng.random((L, batch, nkv, max_len)) * 0.05).astype(np.float32)
    vs = (rng.random((L, batch, max_len, nkv)) * 0.05).astype(np.float32)
    if kind == "int4":
        k = np.asarray(jk.pack_int4_halfplane(jnp.asarray(k), axis=4))
        v = np.asarray(jk.pack_int4_halfplane(jnp.asarray(v), axis=2))
    leaves = (k, ks, v, vs)
    jcls, tcls = ((jk.QuantKVCacheKT4, tk.QuantKVCacheKT4) if kind == "int4"
                  else (jk.QuantKVCacheKT, tk.QuantKVCacheKT))
    return (jcls(*map(jnp.asarray, leaves)),
            tcls(*(torch.from_numpy(a.copy()) for a in leaves)))


def _check_pools(tcache, jcache, active=None):
    """Values within one quantization step (int4 compared unpacked),
    scales to 2e-4 relative. An inactive row is compared at layer 0 only:
    the K/V it writes at deeper layers come from its context, which is
    garbage on both sides and another garbage (the JAX kernel leaves the
    fresh column out of its uniform average, the port does not)."""
    int4 = isinstance(tcache, tk.QuantKVCacheKT4)
    for name, got, want in zip(tcache._fields, tcache, jcache):
        want = torch.from_numpy(np.asarray(want).copy())
        if int4 and got.dtype == torch.int8:
            axis = 4 if name == "k_qp" else 2
            got = tk.unpack_int4_halfplane(got, axis=axis)
            want = tk.unpack_int4_halfplane(want, axis=axis)
        if active is not None:
            keep = torch.ones(got.shape[:2], dtype=torch.bool)
            keep[1:, torch.from_numpy(~active)] = False
            got, want = got[keep], want[keep]
        if got.dtype == torch.int8:
            step = (got.int() - want.int()).abs()
            assert step.max() <= 1, name
            assert (step > 0).float().mean() < 0.01, name
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                       atol=1e-7, err_msg=name)


# (kind, max_len): the JAX fallback at 64, its kernel at 128 / 256
PATHS = [("int8", 64), ("int8", 128), ("int4", 64), ("int4", 256)]


@pytest.mark.parametrize("kind,max_len", PATHS)
def test_ragged_decode_step_matches_jax(models, kind, max_len):
    """Three ragged steps, one row in the upper half of T (the int4 high
    nibble plane) and an inactive row, whose pools are still written."""
    jc, jp, c, tp = models
    jcache, tcache = _random_cache(kind, c, 4, max_len, seed=1)
    row_pos = np.array([3, max_len // 2 + 2, 0, 20], np.int32)
    active = np.array([True, True, False, True])
    rng = np.random.default_rng(2)
    for step in range(3):
        ids = rng.integers(0, c.vocab_size, (4, 1)).astype(np.int32)
        jl, jcache = jrd.ragged_decode_step(
            jp, jcache, jnp.asarray(ids), jnp.asarray(row_pos),
            jnp.asarray(active), jc, impl="xla", compute_dtype=jnp.float32)
        tl, tcache = trd.ragged_decode_step(
            tp, tcache, torch.from_numpy(ids.astype(np.int64)), row_pos,
            active, c, compute_dtype=torch.float32)
        assert tl.shape == (4, 1, c.vocab_size)
        np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                                   err_msg=f"step {step}", **TOL)
        _check_pools(tcache, jcache, active)
        row_pos = row_pos + active


@pytest.mark.parametrize("kind,max_len,s_pad,lengths", [
    ("int8", 128, 32, [20, 32]), ("int8", 256, 128, [100, 128]),
    ("int4", 64, 64, [40, 64]), ("int4", 256, 128, [100, 128])],
    ids=["int8_small_m", "int8_large_m", "int4_past_half", "int4_half"])
def test_prefill_rows_matches_jax(models, kind, max_len, s_pad, lengths):
    """R = 2 prompts into rows 2 and 0 of random pools, quantized at
    insertion; int4 prompts longer than T/2 fill the high nibble plane
    and keep every partner nibble."""
    jc, jp, c, tp = models
    jcache, tcache = _random_cache(kind, c, 3, max_len, seed=3)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, c.vocab_size, (2, s_pad)).astype(np.int32)
    lens = np.array(lengths, np.int32)
    rows = np.array([2, 0], np.int32)
    jl, jcache = jrd.prefill_rows(
        jp, jcache, jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(rows),
        jc, impl="xla", compute_dtype=jnp.float32)
    tl, tcache = trd.prefill_rows(
        tp, tcache, torch.from_numpy(ids.astype(np.int64)),
        torch.from_numpy(lens), torch.from_numpy(rows), c,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_pools(tcache, jcache)


def _prompts(max_len):
    """Six prompts through four slots; at max_len >= 128 two take bucket
    128. At 64 and 256 decode crosses T/2, into the int4 high plane."""
    rng = np.random.default_rng(0)
    lengths = {64: (30, 9, 4, 2, 31, 12), 128: (100, 110, 4, 2, 31, 9),
               256: (100, 125, 4, 2, 31, 9)}[max_len]
    return [rng.integers(3, 500, n).tolist() for n in lengths]


@pytest.mark.parametrize("kind,max_len", PATHS)
def test_greedy_tokens_equal_jax_engine(models, kind, max_len):
    jc, jp, c, tp = models
    quantized_kv = True if kind == "int8" else "int4"
    prompts, budgets = _prompts(max_len), [6, 5, 8, 3, 4, 7]

    def run(eng):
        uids = [eng.add_request(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        out = eng.run()
        return [out[u] for u in uids]

    want = run(JaxEngine(jp, jc, max_batch=4, max_len=max_len,
                         quantized_kv=quantized_kv,
                         compute_dtype=jnp.float32))
    eng = ContinuousBatchingEngine(tp, c, max_batch=4, max_len=max_len,
                                   quantized_kv=quantized_kv,
                                   compute_dtype=torch.float32, device="cpu")
    assert type(eng.cache).__name__ == (
        "QuantKVCacheKT4" if kind == "int4" else "QuantKVCacheKT")
    assert run(eng) == want


@pytest.mark.parametrize("kwargs", [
    dict(paged=True, quantized_kv="int4"), dict(quantized_kv="fp8"),
    dict(quantized_kv="int4", draft_params={}),
    dict(quantized_kv="int4", prefill_chunk_size=64)],
    ids=["int4_paged", "fp8_dense", "int4_draft", "int4_chunked"])
def test_quantized_kv_exclusions_match_jax(kwargs):
    """The JAX engine's four ValueErrors, with its wording, raised before
    any unported option is looked at."""
    with pytest.raises(ValueError) as want:
        JaxEngine({}, JaxConfig.named("tiny"), **kwargs)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine({}, BitLlamaConfig.named("tiny"),
                                 device="cpu", **kwargs)
    assert str(got.value) == str(want.value)
