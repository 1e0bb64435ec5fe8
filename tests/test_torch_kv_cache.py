"""The port's quantized KV caches against the JAX package's, on the same
numpy inputs: quantized values are exactly equal (``torch.round`` and
``jnp.round`` both round half to even), scales to rtol 1e-6, relayouts and
the int4 pack/unpack round trip exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.model import kv_cache as jk
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch.model import kv_cache as tk
from onebit_tpu_torch.model.config import BitLlamaConfig

SCALE_TOL = dict(rtol=1e-6, atol=0)


def _kv(seed, shape=(2, 3, 5, 2, 64)):
    """Values over several magnitudes, an all-zero head row (the eps
    floor) and exact halves (the round-half-to-even cases)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) *
         rng.uniform(0.01, 20, shape[:-1] + (1,))).astype(np.float32)
    x[0, 0, 0, 0] = 0
    x[0, 0, 1, 0, :4] = [127.0, 0.5, -1.5, 2.5]
    x[0, 0, 1, 0, 4:] = 0
    return x


@pytest.mark.parametrize("levels", ["int8", "int4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_matches_jax(levels, seed):
    x = _kv(seed)
    jf, tf = ((jk.quantize_kv, tk.quantize_kv) if levels == "int8" else
              (jk.quantize_kv4, tk.quantize_kv4))
    jq, js = jf(jnp.asarray(x))
    tq, ts = tf(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCALE_TOL)
    bound = 127 if levels == "int8" else 7
    assert tq.abs().max() <= bound
    # bf16 input quantizes from its fp32 value on both sides
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jq, js = jf(xb)
    tq, ts = tf(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCALE_TOL)


def test_dequantize_matches_jax():
    x = _kv(2)
    q, s = jk.quantize_kv(jnp.asarray(x))
    want = np.asarray(jk.dequantize_kv(q, s, jnp.float32))
    tq, ts = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))
    got = tk.dequantize_kv(tq, ts, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tk.dequantize_kv(tq, ts).dtype == torch.bfloat16


@pytest.mark.parametrize("axis", [0, 2, 4])
def test_pack_unpack_int4_halfplane(axis):
    rng = np.random.default_rng(3)
    shape = [2, 3, 4, 5, 6]
    shape[axis] = 8
    q = rng.integers(-8, 8, shape).astype(np.int8)
    got = tk.pack_int4_halfplane(torch.from_numpy(q), axis=axis)
    want = np.asarray(jk.pack_int4_halfplane(jnp.asarray(q), axis=axis))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tk.unpack_int4_halfplane(got, axis=axis)
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jk.unpack_int4_halfplane(jnp.asarray(want), axis=axis)))
    # every byte value unpacks as the reference unpacks it
    every = torch.arange(-128, 128, dtype=torch.int8)
    np.testing.assert_array_equal(
        tk.unpack_int4_halfplane(every, axis=0).numpy(),
        np.asarray(jk.unpack_int4_halfplane(jnp.asarray(every.numpy()),
                                            axis=0)))
    with pytest.raises(ValueError, match="not even"):
        tk.pack_int4_halfplane(torch.zeros(3, dtype=torch.int8), axis=0)


def test_init_caches_match_jax():
    jc, c = JaxConfig.named("tiny"), BitLlamaConfig.named("tiny")
    pairs = [(jk.init_quant_kv_cache(jc, 3, 64),
              tk.init_quant_kv_cache(c, 3, 64, device="cpu")),
             (jk.init_quant_kv_cache_kt(jc, 3, 64),
              tk.init_quant_kv_cache_kt(c, 3, 64, device="cpu")),
             (jk.init_quant_kv_cache_kt4(jc, 3, 64),
              tk.init_quant_kv_cache_kt4(c, 3, 64, device="cpu"))]
    for want, got in pairs:
        assert type(got).__name__ == type(want).__name__
        assert got._fields == want._fields and got.max_len == want.max_len
        for a, b in zip(got, want):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            assert not a.any()
    with pytest.raises(ValueError, match="even max_len"):
        tk.init_quant_kv_cache_kt4(c, 1, 63, device="cpu")


def _quant_cache(seed, L=2, B=3, T=16, nkv=2, hd=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (L, B, T, nkv, hd)).astype(np.int8),
            rng.random((L, B, T, nkv)).astype(np.float32),
            rng.integers(-127, 128, (L, B, T, nkv, hd)).astype(np.int8),
            rng.random((L, B, T, nkv)).astype(np.float32))


def test_relayouts_and_requant_match_jax():
    leaves = _quant_cache(4)
    jq = jk.QuantKVCache(*map(jnp.asarray, leaves))
    tq = tk.QuantKVCache(*map(torch.from_numpy, leaves))
    jkt, tkt = jk.kt_from_quant(jq), tk.kt_from_quant(tq)
    for a, b in zip(tkt, jkt):
        assert a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tk.quant_from_kt(tkt), leaves):
        np.testing.assert_array_equal(a.numpy(), b)
    jkt4, tkt4 = jk.kt4_from_kt(jkt), tk.kt4_from_kt(tkt)
    assert tkt4.max_len == jkt4.max_len == 16
    for name, a, b in zip(tkt4._fields, tkt4, jkt4):
        if a.dtype == torch.int8:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **SCALE_TOL)
