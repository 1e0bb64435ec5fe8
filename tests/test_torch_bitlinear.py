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


# ---------------------------------------------------------------------------
# The KD projections' product (core/bitlinear.py project_f32)
# ---------------------------------------------------------------------------
# On the card bf16 operands take the tensor cores (_Bf16Product): an fp32
# result of bf16 products, and a backward that splits its fp32 gradient into
# two bf16 parts. Here the Function runs with the fp32 product of the upcast
# operands standing in for the card's product (_mm_f32 on CPU tensors).

def _bf16_ulp(v):
    """One bf16 ulp at |v| (2**-133 below the least normal)."""
    v = v.abs().float().clamp(min=2.0 ** -126)
    return torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 8)


def test_bf16_split_reconstructs_fp32():
    """hi + lo is d to within 2**-17 |d| (the worst case of two bf16 parts:
    lo's own rounding, half of 2**-8 of |d - hi| <= 2**-8 |d|), and 2**-134
    where d lies below bf16's subnormal step: a binade every 97th value
    (the worst case is in it), random values over the whole range, zeros,
    subnormals and the largest finite values; infinities and NaN carry."""
    from onebit_tpu_torch.core.bitlinear import split_bf16
    binade = torch.arange(0x3F800000, 0x40000000, 97,
                          dtype=torch.int64).to(torch.int32)
    rng = np.random.default_rng(0)
    rand = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)
                            * np.exp2(rng.integers(-140, 127, 100_000))
                            .astype(np.float32))
    f32 = torch.finfo(torch.float32)
    edges = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-40, 3e-39, f32.tiny,
                          -f32.tiny, f32.max, -f32.max, 3.39e38, -3.39e38,
                          np.nextafter(np.float32(3.3895314e38),
                                       np.float32(np.inf))])
    d = torch.cat([binade.view(torch.float32), rand, edges])[None]
    parts = torch.empty((1, 2 * d.shape[1]), dtype=torch.bfloat16)
    split_bf16(d, parts)
    hi, lo = parts[:, :d.shape[1]].double(), parts[:, d.shape[1]:].double()
    err = (hi + lo - d.double()).abs()
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    assert (err <= 2.0 ** -17 * d.double().abs() + 2.0 ** -134).all()
    assert err.max() > 0                       # lo is not the whole of d
    specials = torch.tensor([[float("inf"), -float("inf"), float("nan")]])
    parts = torch.empty((1, 6), dtype=torch.bfloat16)
    split_bf16(specials, parts)
    total = parts[:, :3].float() + parts[:, 3:].float()
    assert total[0, 0] == float("inf") and total[0, 1] == -float("inf")
    assert torch.isnan(total[0, 2])


@pytest.mark.parametrize("m,k,n", [(128, 256, 192), (96, 384, 64)])
def test_bf16_product_backward_matches_fp32_upcast(m, k, n):
    """The Function's gradients of a and of a ±1 (and 0) b, from an fp32
    dZ, against autograd of the fp32 product of the upcast operands: each
    within one bf16 ulp (the rounding to a's dtype may fall either side of
    a tie) plus 1e-5 of the element's sum of |terms| (the split's 2**-17 a
    term, and fp32 sums in another order); the forward is the same."""
    from onebit_tpu_torch.core import bitlinear as cbl
    gen = torch.Generator().manual_seed(m + k)
    a = torch.randn(m, k, generator=gen).bfloat16()
    b = torch.sign(torch.randn(n, k, generator=gen)).bfloat16()
    b[0, :7] = 0
    dz = torch.randn(m, n, generator=gen) * torch.rand(m, 1, generator=gen)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    z = cbl._Bf16Product.apply(a1, b1)
    z.backward(dz)
    a0, b0 = a.clone().requires_grad_(), b.clone().requires_grad_()
    z0 = a0.float() @ b0.float().T
    z0.backward(dz)
    assert z.dtype == torch.float32
    torch.testing.assert_close(z, z0, rtol=0, atol=0)
    terms = {"a": dz.abs() @ b.float().abs(), "b": dz.abs().T @ a.float().abs()}
    for key, got, want in (("a", a1.grad, a0.grad), ("b", b1.grad, b0.grad)):
        assert got.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs()
        bound = _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
        assert (err <= bound + 1e-5 * terms[key]).all(), key


def test_bf16_product_saves_only_what_it_needs():
    """A b without a gradient (a dense sign matrix) returns none and needs
    no a; without a's gradient, no b."""
    from onebit_tpu_torch.core import bitlinear as cbl
    a = torch.randn(8, 32).bfloat16().requires_grad_()
    b = torch.sign(torch.randn(16, 32)).bfloat16()
    z = cbl._Bf16Product.apply(a, b)
    saved = z.grad_fn.saved_tensors
    assert saved[0] is None and saved[1] is not None
    z.sum().backward()
    assert a.grad is not None and a.grad.dtype == torch.bfloat16


def _kd_projection(tensor_cores, monkeypatch):
    """One latent BitLinear (g, h, the STE) in bf16 on CPU tensors, its
    output's gradients; with ``tensor_cores`` through the Function."""
    from onebit_tpu_torch.core import bitlinear as cbl
    if tensor_cores:
        monkeypatch.setattr(cbl, "_on_tensor_cores", lambda a, b: True)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 64, 256, generator=gen).bfloat16().requires_grad_()
    lat = (0.01 * torch.randn(192, 256, generator=gen)).requires_grad_()
    g = (1 + 0.25 * torch.randn(256, generator=gen)).requires_grad_()
    h = (torch.rand(192, generator=gen) + 0.5).requires_grad_()
    r = torch.randn(2, 64, 192, generator=gen)
    out = cbl.bitlinear_train_fwd(x, lat, g, h)
    (out.float() * r).sum().backward()
    monkeypatch.undo()
    return out, {"dx": x.grad, "dg": g.grad, "dh": h.grad, "dlat": lat.grad}


def test_bf16_product_chain_matches_todays_autograd(monkeypatch):
    """dx, dg, dh and the latent gradient through the Function against
    today's autograd path (the fp32 product of the upcasts), both on the
    CPU: the output is the same; every gradient lies within one bf16 ulp
    of its largest element, and in norm within 2**-12 of it (what the
    Function's own rounding to bf16 moves)."""
    out0, want = _kd_projection(False, monkeypatch)
    out1, got = _kd_projection(True, monkeypatch)
    torch.testing.assert_close(out1, out0, rtol=0, atol=0)
    for key, w in want.items():
        g, w = got[key].float(), w.float()
        assert g.dtype == w.dtype and torch.isfinite(g).all()
        assert (g - w).abs().max() <= 2.0 ** -8 * w.abs().max(), key
        assert (g - w).norm() <= 2.0 ** -12 * w.norm(), key


def _count(fn):
    from onebit_tpu_torch.core import bitlinear as cbl
    before = cbl.tensor_core_products, cbl.fp32_products
    fn()
    return (cbl.tensor_core_products - before[0],
            cbl.fp32_products - before[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_and_fp32_products_take_the_fp32_path(dtype):
    """On CPU tensors, and for fp32 operands anywhere, the BitLinear's and
    the FP teacher's products take the fp32 product of the upcasts: counted
    on the fp32 path, the tensor-core path untouched."""
    from onebit_tpu_torch.core.bitlinear import bitlinear_raw
    from onebit_tpu_torch.kernels.linear import LinearWeights, linear_apply
    x = torch.randn(4, 64).to(dtype)
    w = torch.randn(32, 64)
    assert _count(lambda: bitlinear_raw(x, torch.sign(w), torch.ones(64),
                                        torch.ones(32))) == (0, 1)
    assert _count(lambda: linear_apply(x, LinearWeights(w))) == (0, 1)


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, (1, 0)),
                                        (torch.float32, (0, 1))])
def test_fake_operands_take_the_card_path(dtype, path):
    """A memory plan's fake tensors take the card's path: bf16 the
    tensor cores (an fp32 result of the Function's shape), fp32 the fp32
    product."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from onebit_tpu_torch.core.bitlinear import bitlinear_raw
    with FakeTensorMode():
        x = torch.empty(2, 3, 64, dtype=dtype, requires_grad=True)
        sign, g, h = torch.empty(32, 64), torch.empty(64), torch.empty(32)
        out = []
        assert _count(lambda: out.append(bitlinear_raw(x, sign, g,
                                                       h))) == path
        assert out[0].shape == (2, 3, 32) and out[0].dtype == torch.float32
        out[0].sum().backward()
        assert x.grad.shape == x.shape and x.grad.dtype == dtype
