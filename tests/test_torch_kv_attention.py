"""The plain versions of kernels B5-B8 (``onebit_tpu_torch/kernels/
kv_attention.py``) against the JAX Pallas kernels in interpret mode, on the
same numpy inputs, and the port's ``_attention_quant`` against the JAX one.

The cases follow tests/test_kv_attention.py: per-row write positions in
different T blocks and in both int4 nibble planes, ``starts``, GQA groups of
1 and 2, and an inactive row (length 0). Pools must be bit-exact after the
append. ``ctx`` is compared in fp32 on the rows with something to attend
(``length > start``) to 1e-5: both sides sum the same fp32 products in
another order (and the Pallas append adds the fresh column's PV term
separately). The inactive row need only be finite: the Pallas kernel gives
a uniform average there, and it is never read.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.kernels import kv_attention as jka
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.kv_cache import pack_int4_halfplane
from onebit_tpu_torch.kernels import kv_attention as tka
from onebit_tpu_torch.model import kv_cache as tk

CTX_TOL = dict(rtol=1e-5, atol=1e-5)
L, B, NKV, HD = 2, 3, 2, 64
LAYER = 1


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(seed, g, t, int4):
    """q, the new K/V with their scales, and the pools of layout KT
    (int8) or KT4 (int4, packed here with the JAX packer)."""
    rng = np.random.default_rng(seed)
    lo, hi = (-8, 8) if int4 else (-127, 128)
    q = rng.standard_normal((B, NKV * g, HD)).astype(np.float32)
    new = [rng.integers(lo, hi, (B, NKV, HD)).astype(np.int8),
           (rng.random((B, NKV)) * 0.3 + 0.01).astype(np.float32),
           rng.integers(lo, hi, (B, NKV, HD)).astype(np.int8),
           (rng.random((B, NKV)) * 0.3 + 0.01).astype(np.float32)]
    k = rng.integers(lo, hi, (L, B, NKV, HD, t)).astype(np.int8)
    v = rng.integers(lo, hi, (L, B, t, NKV, HD)).astype(np.int8)
    if int4:
        k = np.asarray(pack_int4_halfplane(jnp.asarray(k), axis=4))
        v = np.asarray(pack_int4_halfplane(jnp.asarray(v), axis=2))
    pools = [k, rng.random((L, B, NKV, t)).astype(np.float32),
             v, rng.random((L, B, t, NKV)).astype(np.float32)]
    return q, new, pools


def _check_ctx(got, want, lengths, starts):
    got = got.numpy()
    assert got.shape == (B, want.shape[1], HD) and np.isfinite(got).all()
    live = np.asarray(lengths) > (0 if starts is None else np.asarray(starts))
    np.testing.assert_allclose(got[live], np.asarray(want)[live], **CTX_TOL)


def _starts(starts):
    return None if starts is None else np.asarray(starts, np.int32)


def _jstarts(starts):
    return None if starts is None else jnp.asarray(starts, jnp.int32)


# pos per row, lengths per row, starts: ragged rows in three T blocks; the
# same with starts; an inactive row whose pool is still written at its pos
APPEND_CASES = {
    "ragged": ([5, 131, 300], [6, 132, 301], None),
    "starts": ([5, 131, 300], [6, 132, 301], [0, 40, 3]),
    "inactive": ([3, 7, 200], [4, 0, 201], None),
}
# both nibble planes (T/2 = 256), and an inactive row
APPEND4_CASES = {
    "low_plane": ([5, 131, 200], [6, 132, 201], None),
    "both_planes": ([250, 259, 450], [251, 260, 451], [0, 7, 300]),
    "inactive": ([3, 300, 7], [4, 301, 0], None),
}


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("case", sorted(APPEND_CASES))
def test_append_kt_matches_jax(g, case):
    pos, lengths, starts = APPEND_CASES[case]
    q, new, pools = _inputs(21, g, 384, int4=False)
    want = jka.kv_attention_append_kt(
        jnp.asarray(q), *map(jnp.asarray, new), *map(jnp.asarray, pools),
        jnp.asarray(lengths, jnp.int32), jnp.int32(LAYER),
        jnp.asarray(pos, jnp.int32), starts=_jstarts(starts), t_blk=128)
    tpools = [_t(p) for p in pools]
    ctx = tka.kv_attention_append_kt(
        _t(q), *map(_t, new), *tpools, _t(np.int32(lengths)), LAYER,
        _t(np.int32(pos)), starts=_starts(starts))
    for name, got, ref in zip(("k_qt", "k_st", "v_q", "v_s"), tpools,
                              want[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), name)
    _check_ctx(ctx, want[0], lengths, starts)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("starts", [None, [3, 50, 0]])
def test_decode_kt_matches_jax(g, starts):
    q, _, pools = _inputs(5, g, 256, int4=False)
    lengths = [256, 77, 0]
    want = jka.kv_attention_decode_kt(
        jnp.asarray(q), *map(jnp.asarray, pools),
        jnp.asarray(lengths, jnp.int32), jnp.int32(LAYER),
        starts=_jstarts(starts), t_blk=128)
    tpools = [_t(p) for p in pools]
    ctx = tka.kv_attention_decode_kt(_t(q), *tpools, _t(np.int32(lengths)),
                                     LAYER, starts=_starts(starts))
    for got, ref in zip(tpools, pools):
        np.testing.assert_array_equal(got.numpy(), ref)   # read only
    _check_ctx(ctx, want, lengths, starts)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("case", sorted(APPEND4_CASES))
def test_append_kt4_matches_jax(g, case):
    pos, lengths, starts = APPEND4_CASES[case]
    q, new, pools = _inputs(41, g, 512, int4=True)
    want = jka.kv_attention_append_kt4(
        jnp.asarray(q), *map(jnp.asarray, new), *map(jnp.asarray, pools),
        jnp.asarray(lengths, jnp.int32), jnp.int32(LAYER),
        jnp.asarray(pos, jnp.int32), starts=_jstarts(starts), t_blk=256)
    tpools = [_t(p) for p in pools]
    ctx = tka.kv_attention_append_kt4(
        _t(q), *map(_t, new), *tpools, _t(np.int32(lengths)), LAYER,
        _t(np.int32(pos)), starts=_starts(starts))
    for name, got, ref in zip(("k_qp", "k_st", "v_qp", "v_s"), tpools,
                              want[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), name)
    _check_ctx(ctx, want[0], lengths, starts)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("starts", [None, [3, 300, 0]])
def test_decode_kt4_matches_jax(g, starts):
    q, _, pools = _inputs(33, g, 512, int4=True)
    lengths = [512, 400, 0]
    want = jka.kv_attention_decode_kt4(
        jnp.asarray(q), *map(jnp.asarray, pools),
        jnp.asarray(lengths, jnp.int32), jnp.int32(LAYER),
        starts=_jstarts(starts), t_blk=256)
    ctx = tka.kv_attention_decode_kt4(_t(q), *map(_t, pools),
                                      _t(np.int32(lengths)), LAYER,
                                      starts=_starts(starts))
    _check_ctx(ctx, want, lengths, starts)


def test_merge_nibbles_keeps_the_partner():
    """Every byte value, each nibble replaced by every int4 value: the other
    nibble is kept bit for bit."""
    old = torch.arange(-128, 128, dtype=torch.int8)[:, None].expand(256, 16)
    new = torch.arange(-8, 8, dtype=torch.int8)[None, :].expand(256, 16)
    o, n = old.int() & 0xFF, new.int() & 0xF
    for hi in (False, True):
        got = tk.merge_nibbles(old, new, hi).int() & 0xFF
        want = (o & 0x0F) | (n << 4) if hi else (o & 0xF0) | n
        assert torch.equal(got, want)


@pytest.mark.parametrize("s,g", [(1, 1), (1, 2), (5, 2)])
def test_attention_quant_matches_jax(s, g):
    """Scale-folded attention on an int8 cache, with a ragged mask and a
    fully masked row, in fp32."""
    rng = np.random.default_rng(7)
    t = 40
    q = rng.standard_normal((B, s, NKV * g, HD)).astype(np.float32)
    k = rng.integers(-127, 128, (B, t, NKV, HD)).astype(np.int8)
    v = rng.integers(-127, 128, (B, t, NKV, HD)).astype(np.int8)
    ks = (rng.random((B, t, NKV)) * 0.02).astype(np.float32)
    vs = (rng.random((B, t, NKV)) * 0.02).astype(np.float32)
    lengths = np.array([t, 17, 0])
    mask = np.broadcast_to(
        (np.arange(t)[None, :] < lengths[:, None])[:, None, None, :],
        (B, 1, s, t))
    want = jb._attention_quant(*map(jnp.asarray, (q, k, ks, v, vs, mask)),
                               num_kv_groups=g)
    got = tka._attention_quant(*map(_t, (q, k, ks, v, vs, mask)),
                               num_kv_groups=g)
    assert got.shape == (B, s, NKV * g, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CTX_TOL)
