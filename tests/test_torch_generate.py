"""Batch generation of the port against the JAX package, at the tiny config
(2 layers, GQA with 2 query heads per kv head) on the CPU:
``decode_step`` and ``decode_step_flat`` over the four cache types,
``generate``, ``prefill_row`` and ``greedy_until``.

Every decode case runs a multi-token step (``s = 5``) into an empty cache,
then a one-token step, with left-padded rows: explicit ``positions`` and a
``key_start`` that masks one row's pad slots. The JAX functions take their
short-cache paths (``max_len`` 64; the Pallas kernels' plain counterparts
are held to them in tests/test_torch_kv_decode.py and
tests/test_torch_kv_attention.py).

Tolerances: logits to 2e-4 in fp32 (another summation order in every
matmul, as tests/test_torch_model.py holds the dense path); dense caches to
2e-4; quantized values within 3 steps (the fp32 K/V of the two sides differ
in the last bits, and a layer's attention residual feeds the next layer's
quantization, the bound of tests/test_kv_attention.py:185-191), scales to
2e-4 relative. Greedy tokens must be equal; sampled ones need only lie in
the sampled distribution's support.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.engine.generate import generate as jgenerate
from onebit_tpu.engine.sampler import SamplingConfig as JaxSampling
from onebit_tpu.eval.rolling import greedy_until as jgreedy_until
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model import kv_cache as jk
from onebit_tpu.model import ragged_decode as jrd
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch import (BitLlamaConfig, SamplingConfig, decode_step,
                              decode_step_flat, fuse_for_decode, generate,
                              params_from_jax)
from onebit_tpu_torch.eval.rolling import greedy_until
from onebit_tpu_torch.kernels import kv_attention_cuda as kc
from onebit_tpu_torch.model import bitllama as tb
from onebit_tpu_torch.model import kv_cache as tk
from onebit_tpu_torch.model import ragged_decode as trd

TOL = dict(rtol=2e-4, atol=2e-4)
MAX_LEN, B, S = 64, 2, 5
# row 1 is a 3-token prompt left-padded to 5: its slots 0-1 are pads
POSITIONS = [[0, 1, 2, 3, 4], [0, 0, 0, 1, 2]]
KEY_START = [0, 2]


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, port params): unfused, and
    fused for decode on both sides."""
    jc = JaxConfig.named("tiny")
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(3)))
    c = BitLlamaConfig.named("tiny")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), c, device="cpu")
    return dict(jc=jc, jp=jp, c=c, tp=tp, jp_fused=jb.fuse_for_decode(jp, jc),
                tp_fused=fuse_for_decode(tp, c))


def _caches(kind, jc, c):
    """An empty JAX cache and the port's, of one kind, fp32 where dense."""
    if kind == "dense":
        return (jb.init_kv_cache(jc, B, MAX_LEN, dtype=jnp.float32),
                tb.init_kv_cache(c, B, MAX_LEN, dtype=torch.float32,
                                 device="cpu"))
    j_init, t_init = {"quant": (jk.init_quant_kv_cache,
                                tk.init_quant_kv_cache),
                      "kt": (jk.init_quant_kv_cache_kt,
                             tk.init_quant_kv_cache_kt),
                      "kt4": (jk.init_quant_kv_cache_kt4,
                              tk.init_quant_kv_cache_kt4)}[kind]
    return j_init(jc, B, MAX_LEN), t_init(c, B, MAX_LEN, device="cpu")


def _leaves(kind, cache, jax_side):
    """The cache's leaves as numpy, int4 pools unpacked."""
    leaves = [np.asarray(x) for x in cache] if jax_side else \
        [x.numpy() for x in cache]
    if kind == "kt4":
        leaves[0] = np.asarray(jk.unpack_int4_halfplane(
            jnp.asarray(leaves[0]), axis=4))
        leaves[2] = np.asarray(jk.unpack_int4_halfplane(
            jnp.asarray(leaves[2]), axis=2))
    return leaves


def _check_cache(kind, got, want):
    for g, w in zip(_leaves(kind, got, False), _leaves(kind, want, True)):
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 3
        else:
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("fn", ["decode_step", "decode_step_flat"])
@pytest.mark.parametrize("kind", ["dense", "quant", "kt", "kt4"])
def test_decode_step_matches_jax(models, fn, kind):
    m = models
    jfn = {"decode_step": jb.decode_step,
           "decode_step_flat": jb.decode_step_flat}[fn]
    tfn = {"decode_step": decode_step,
           "decode_step_flat": decode_step_flat}[fn]
    jcache, tcache = _caches(kind, m["jc"], m["c"])
    rng = np.random.default_rng(5)
    ids = rng.integers(3, m["c"].vocab_size, (B, S + 1))
    if fn == "decode_step" and kind in ("kt", "kt4"):
        for f, p, cache in ((jfn, m["jp_fused"], jcache),
                            (tfn, m["tp_fused"], tcache)):
            with pytest.raises(TypeError, match="decode_step_flat"):
                f(p, cache, jnp.asarray(ids[:, :1]) if f is jfn else
                  torch.from_numpy(ids[:, :1]), 0,
                  m["jc"] if f is jfn else m["c"])
        return
    key_start = np.asarray(KEY_START, np.int32)
    steps = ((ids[:, :S], 0, np.asarray(POSITIONS)),
             (ids[:, S:], S, np.asarray(POSITIONS)[:, -1:] + 1))
    for tokens, index, positions in steps:
        want, jcache = jfn(m["jp_fused"], jcache, jnp.asarray(tokens),
                           jnp.int32(index), m["jc"],
                           compute_dtype=jnp.float32,
                           positions=jnp.asarray(positions),
                           key_start=jnp.asarray(key_start))
        got, tcache = tfn(m["tp_fused"], tcache, torch.from_numpy(tokens),
                          index, m["c"], compute_dtype=torch.float32,
                          positions=torch.from_numpy(positions),
                          key_start=torch.from_numpy(key_start))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _check_cache(kind, tcache, jcache)


def _prompts(c, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, c.vocab_size, n).tolist() for n in (4, 9, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_tokens_equal_jax(models, dtype):
    """Left-padded prompts of unequal length; then with an EOS that one row
    emits, so that row stops there while the others run on."""
    m = models
    prompts = _prompts(m["c"])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(max_new_tokens=7)
    want = jgenerate(m["jp"], m["jc"], prompts,
                     sampling=JaxSampling(greedy=True), compute_dtype=jdt,
                     **kw)
    got = generate(m["tp"], m["c"], prompts, compute_dtype=tdt, **kw)
    assert got == want
    eos = want[1][3]
    want = jgenerate(m["jp"], m["jc"], prompts, eos_id=eos,
                     sampling=JaxSampling(greedy=True), compute_dtype=jdt,
                     **kw)
    got = generate(m["tp"], m["c"], prompts, eos_id=eos, compute_dtype=tdt,
                   **kw)
    assert got == want
    assert got[1][-1] == eos and len(got[1]) <= 4
    assert any(len(row) == 7 for row in got)


def test_ragged_batch_matches_each_prompt_alone(models):
    m = models
    prompts = _prompts(m["c"], seed=1)
    batch = generate(m["tp"], m["c"], prompts, max_new_tokens=6,
                     compute_dtype=torch.float32)
    for p, row in zip(prompts, batch):
        assert generate(m["tp"], m["c"], [p], max_new_tokens=6,
                        compute_dtype=torch.float32)[0] == row


def test_max_len_too_short_raises(models):
    m = models
    with pytest.raises(ValueError, match="exceeds max_len 8"):
        generate(m["tp"], m["c"], [[1, 2, 3, 4]], max_new_tokens=5,
                 max_len=8)


def test_sampled_tokens_lie_in_the_top_k_support(models):
    """The first sampled token of each row is among the top 3 of its
    prompt's next-token logits (JAX forward of the prompt alone), for
    several seeds; two seeds give different samples somewhere."""
    m = models
    prompts = _prompts(m["c"], seed=2)
    top = []
    for p in prompts:
        logits = np.asarray(jb.forward(m["jp"], jnp.asarray([p]), m["jc"],
                                       compute_dtype=jnp.float32))[0, -1]
        top.append(set(np.argsort(logits)[-3:].tolist()))
    cfg = SamplingConfig(temperature=1.0, top_k=3)
    runs = [generate(m["tp"], m["c"], prompts, max_new_tokens=3,
                     sampling=cfg, seed=seed, compute_dtype=torch.float32)
            for seed in range(4)]
    for run in runs:
        assert all(row[0] in t for row, t in zip(run, top))
        assert all(0 <= tok < m["c"].vocab_size for row in run for tok in row)
    assert len({str(r) for r in runs}) > 1


def test_prefill_row_matches_jax(models):
    m = models
    rng = np.random.default_rng(4)
    ids = np.zeros(16, np.int32)
    ids[:11] = rng.integers(3, m["c"].vocab_size, 11)
    jcache = jb.init_kv_cache(m["jc"], 3, MAX_LEN, dtype=jnp.float32)
    tcache = tb.init_kv_cache(m["c"], 3, MAX_LEN, dtype=torch.float32,
                              device="cpu")
    want, jcache = jrd.prefill_row(m["jp_fused"], jcache, jnp.asarray(ids),
                                   jnp.int32(11), jnp.int32(1), m["jc"],
                                   compute_dtype=jnp.float32)
    got, tcache = trd.prefill_row(m["tp_fused"], tcache,
                                  torch.from_numpy(ids), 11, 1, m["c"],
                                  compute_dtype=torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in zip(tcache, jcache):
        np.testing.assert_allclose(g[:, 1, :11].numpy(),
                                   np.asarray(w)[:, 1, :11], **TOL)
        assert not g[:, [0, 2]].any()


def test_greedy_until_matches_jax(models):
    """A char detokenizer (token t -> chr(ord('a') + t % 26)); stops cut the
    text at their first occurrence."""
    m = models
    prompts = _prompts(m["c"], seed=3)

    def detok(toks):
        return "".join(chr(ord("a") + t % 26) for t in toks)

    full = [detok(row) for row in generate(m["tp"], m["c"], prompts,
                                           max_new_tokens=8)]
    requests = [(prompts[0], [full[0][3:5]]), (prompts[1], ["\n"]),
                (prompts[2], [full[2][1], "zz"])]
    kw = dict(max_new_tokens=8, batch_size=2)
    want = jgreedy_until(m["jp"], m["jc"], requests, detok, **kw)
    got = greedy_until(m["tp"], m["c"], requests, detok, **kw)
    assert got == want
    assert got[1] == full[1] and len(got[0]) <= 3


def test_dense_ragged_step_on_the_cpu_takes_the_window(models):
    """On the CPU the dense ragged decode step attends the length-aware
    window, as before: no kernel is counted, and impl="auto" gives
    impl="torch"'s logits exactly."""
    m = models
    c, tp = m["c"], m["tp_fused"]
    kc.reset_launch_counts()
    out = []
    for impl in ("auto", "torch"):
        cache = tb.init_kv_cache(c, B, MAX_LEN, dtype=torch.float32,
                                 device="cpu")
        ids = torch.tensor([[5, 6, 7, 8], [9, 10, 0, 0]])
        trd.prefill_rows(tp, cache, ids, torch.tensor([4, 2]),
                         torch.tensor([0, 1]), c,
                         compute_dtype=torch.float32)
        logits, _ = trd.ragged_decode_step(
            tp, cache, torch.tensor([[11], [12]]), np.array([4, 2]),
            np.array([True, True]), c, impl=impl,
            compute_dtype=torch.float32)
        out.append(logits)
    assert torch.equal(out[0], out[1])
    assert all(k.launches == 0 for k in kc.KERNELS)
