"""The plain versions of the port's three BitLinear kernels (what a wrapper
runs on CPU tensors) against the JAX package: its XLA path and its Pallas
kernels in interpret mode, with random non-unit g and h.

Tolerances: fp32 outputs agree to 2e-4 (LayerNorm outputs of order 1; the
two sides sum the K products in other orders). bf16 outputs agree to 1e-2
relative and absolute (about two bf16 ulps at order 1: a sum that lands
near a rounding boundary may round the other way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.core.bitlinear import bitlinear_fwd as jax_bitlinear_fwd
from onebit_tpu.core.packing import pack_signs_device
from onebit_tpu.kernels import bitlinear as jbl
from onebit_tpu.kernels import bitlinear_pallas as jpl
from onebit_tpu_torch.core.bitlinear import layernorm_noaffine
from onebit_tpu_torch.core.packing import pack_signs_kmajor
from onebit_tpu_torch.kernels import bitlinear as tbl
from onebit_tpu_torch.kernels import bitlinear_cuda as bc

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _single(m, n, k, seed, bias=False):
    x, w = _rand((m, k), seed), _rand((n, k), seed + 1)
    g, h = _rand((k,), seed + 2), _rand((n,), seed + 3)
    b = _rand((n,), seed + 4) if bias else None
    return x, w, g, h, b


def _port_weights(w, g, h, b=None):
    return tbl.BitLinearWeights(
        weight_scale=torch.from_numpy(h), input_factor=torch.from_numpy(g),
        packed=pack_signs_kmajor(torch.from_numpy(w)),
        bias=None if b is None else torch.from_numpy(b))


def _jax_weights(w, g, h, b=None):
    return jbl.BitLinearWeights(
        weight_scale=jnp.asarray(h), input_factor=jnp.asarray(g),
        packed=pack_signs_device(jnp.asarray(w)),
        bias=None if b is None else jnp.asarray(b))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("m,bias", [(1, False), (8, True), (128, False),
                                    (200, False), (300, True)])
def test_single_projection_matches_jax(m, bias):
    """K1 (m <= 128) and K3 (m > 128) plain versions against JAX's XLA
    path and its Pallas kernel in interpret mode."""
    x, w, g, h, b = _single(m, 256, 256, seed=m)
    got = tbl.bitlinear_apply(torch.from_numpy(x), _port_weights(w, g, h, b))
    jw = _jax_weights(w, g, h, b)
    want_xla = jbl.bitlinear_apply(jnp.asarray(x), jw, impl="xla")
    want_pallas = jpl.bitlinear_packed_pallas(
        jnp.asarray(x), jw.packed, jw.input_factor, jw.weight_scale,
        bias=jw.bias, interpret=True)
    np.testing.assert_allclose(got.numpy(), _f32(want_xla), **F32)
    np.testing.assert_allclose(got.numpy(), _f32(want_pallas), **F32)


@pytest.mark.parametrize("m", [8, 160])
def test_single_projection_bf16(m):
    x, w, g, h, _ = _single(m, 128, 256, seed=40 + m)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = tbl.bitlinear_apply(torch.from_numpy(x).to(torch.bfloat16),
                              _port_weights(w, g, h))
    assert got.dtype == torch.bfloat16
    jw = _jax_weights(w, g, h)
    want = jpl.bitlinear_packed_pallas(xb, jw.packed, jw.input_factor,
                                       jw.weight_scale, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **BF16)
    ref = jax_bitlinear_fwd(xb, jnp.sign(jnp.asarray(w)).astype(jnp.bfloat16),
                            jnp.asarray(g), jnp.asarray(h))
    np.testing.assert_allclose(got.float().numpy(), _f32(ref), **BF16)


def _fused_case(m, seed, n_true=192, k=128, ns=3):
    ws = [_rand((n_true, k), seed + j) for j in range(ns)]
    gs = [_rand((k,), seed + 10 + j) for j in range(ns)]
    hs = [_rand((n_true,), seed + 20 + j) for j in range(ns)]
    x = _rand((m, k), seed + 30)
    return x, ws, gs, hs


def _fused_port(ws, gs, hs, seg_pad):
    pad = seg_pad - ws[0].shape[0]
    packed = torch.cat([torch.nn.functional.pad(
        pack_signs_kmajor(torch.from_numpy(w)), (0, pad)) for w in ws], -1)
    h = torch.cat([torch.nn.functional.pad(torch.from_numpy(x), (0, pad))
                   for x in hs])
    g = torch.stack([torch.from_numpy(x) for x in gs])
    return tbl.FusedBitLinearWeights(weight_scale=h, input_factor=g,
                                     packed=packed)


@pytest.mark.parametrize("m", [4, 128, 200])
def test_fused_projection_matches_jax(m):
    """K2 (m <= 128) and fused K3 (m > 128) plain versions, with padded
    segments (n_true 384, the port pads to 448, JAX to 512) against JAX's
    fused Pallas kernel in interpret mode and its per-segment XLA path."""
    n_true, seg_jax = 384, 512
    x, ws, gs, hs = _fused_case(m, seed=m, n_true=n_true)
    got = tbl.fused_bitlinear_apply(torch.from_numpy(x),
                                    _fused_port(ws, gs, hs, 448), n_true)
    jpacked = jnp.concatenate(
        [jnp.pad(pack_signs_device(jnp.asarray(w)),
                 ((0, 0), (0, seg_jax - n_true))) for w in ws], axis=-1)
    jh = jnp.concatenate([jnp.pad(jnp.asarray(v), (0, seg_jax - n_true))
                          for v in hs])
    jw = jbl.FusedBitLinearWeights(weight_scale=jh,
                                   input_factor=jnp.stack(gs),
                                   packed=jpacked)
    want_pallas = jpl.bitlinear_packed_fused(
        jnp.asarray(x), jpacked, jnp.stack(gs), jh, n_true=n_true,
        interpret=True)
    want_xla = jbl.fused_bitlinear_apply(jnp.asarray(x), jw, n_true,
                                         impl="xla")
    assert len(got) == 3
    for j in range(3):
        assert got[j].shape == (m, n_true)
        np.testing.assert_allclose(got[j].numpy(), _f32(want_pallas[j]), **F32)
        np.testing.assert_allclose(got[j].numpy(), _f32(want_xla[j]), **F32)


def test_fused_layernorm_ignores_pads():
    """The pad columns carry garbage h here: a LayerNorm over the padded
    width would see it; the kernels' plain versions must not."""
    x, ws, gs, hs = _fused_case(8, seed=7)
    w = _fused_port(ws, gs, hs, 256)
    poisoned = w.weight_scale.clone().view(3, 256)
    poisoned[:, 192:] = 1e3
    w_bad = w._replace(weight_scale=poisoned.reshape(-1))
    xt = torch.from_numpy(x)
    for a, b in zip(tbl.fused_bitlinear_apply(xt, w, 192),
                    tbl.fused_bitlinear_apply(xt, w_bad, 192)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("m", [8, 200])
def test_raw_projection_matches_jax(m):
    x, w, g, h, _ = _single(m, 128, 128, seed=90 + m)
    stack = lambda a: a[None]                                 # noqa: E731
    pw = _port_weights(w, g, h)
    pw = tbl.BitLinearWeights(*(None if a is None else stack(a) for a in pw))
    jw = _jax_weights(w, g, h)
    jw = jbl.BitLinearWeights(*(None if a is None else stack(a) for a in jw))
    got = tbl.bitlinear_apply_stacked_raw(torch.from_numpy(x), pw, 0)
    want = jbl.bitlinear_apply_stacked_raw(jnp.asarray(x), jw, 0, impl="xla")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=2e-4, atol=2e-3)


def test_dense_sign_mode_matches_jax():
    x, w, g, h, b = _single(6, 64, 96, seed=5, bias=True)
    sign = np.sign(w) + (w == 0)
    pw = tbl.BitLinearWeights(weight_scale=torch.from_numpy(h),
                              input_factor=torch.from_numpy(g),
                              dense_sign=torch.from_numpy(sign),
                              bias=torch.from_numpy(b))
    jw = jbl.BitLinearWeights(weight_scale=jnp.asarray(h),
                              input_factor=jnp.asarray(g),
                              dense_sign=jnp.asarray(sign),
                              bias=jnp.asarray(b))
    got = tbl.bitlinear_apply(torch.from_numpy(x), pw)
    np.testing.assert_allclose(got.numpy(),
                               _f32(jbl.bitlinear_apply(jnp.asarray(x), jw)),
                               **F32)


def test_layernorm_noaffine_matches_jax():
    from onebit_tpu.core.bitlinear import layernorm_noaffine as jln
    x = _rand((5, 300), 11) * 7 + 3
    np.testing.assert_allclose(layernorm_noaffine(torch.from_numpy(x)).numpy(),
                               _f32(jln(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("m,fused,expect", [
    (128, False, "small_m_torch"), (129, False, "large_m_torch"),
    (128, True, "fused_small_m_torch"), (129, True, "large_m_torch")])
def test_dispatch_thresholds(monkeypatch, m, fused, expect):
    """M <= 128 takes the small-M kernels, larger M the large-M kernel; on
    CPU tensors each wrapper runs its plain version and counts no launch."""
    calls = []
    for name in ("small_m_torch", "fused_small_m_torch", "large_m_torch"):
        fn = getattr(bc, name)
        monkeypatch.setattr(bc, name, lambda *a, _f=fn, _n=name, **kw:
                            calls.append(_n) or _f(*a, **kw))
    bc.reset_launch_counts()
    x = torch.from_numpy(_rand((m, 64), 3))
    if fused:
        _, ws, gs, hs = _fused_case(1, seed=3, n_true=64, k=64, ns=2)
        tbl.fused_bitlinear_apply(x, _fused_port(ws, gs, hs, 64), 64)
    else:
        _, w, g, h, _ = _single(1, 64, 64, seed=3)
        tbl.bitlinear_apply(x, _port_weights(w, g, h))
    assert calls == [expect]
    assert all(k.launches == 0 for k in bc.KERNELS)


def test_torch_impl_equals_auto_on_cpu():
    x, w, g, h, b = _single(5, 64, 64, seed=8, bias=True)
    pw = _port_weights(w, g, h, b)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tbl.bitlinear_apply(xt, pw, impl="torch").numpy(),
        tbl.bitlinear_apply(xt, pw, impl="auto").numpy())
    with pytest.raises(ValueError, match="impl"):
        tbl.bitlinear_apply(xt, pw, impl="xla")


def test_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises; a tensor that is
    neither on the CPU nor on a CUDA device is refused."""
    x, w, g, h, _ = _single(4, 64, 64, seed=9)
    pw = _port_weights(w, g, h)
    meta = lambda t: t.to("meta")                             # noqa: E731
    with pytest.raises(ValueError, match="CUDA tensors"):
        bc.small_m(meta(torch.from_numpy(x)), meta(pw.packed),
                   meta(pw.input_factor), meta(pw.weight_scale))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bc.large_m(meta(torch.from_numpy(x)), meta(pw.packed),
                   meta(pw.input_factor[None]), meta(pw.weight_scale),
                   n_true=64)
