"""The plain version of kernel B9 (``kv_attention_decode`` of
``onebit_tpu_torch/kernels/kv_attention.py``) against the JAX Pallas
kernel in interpret mode, on the same numpy inputs, as
tests/test_kv_attention.py:24-72 runs it.

The cases: int8 pools with scales at GQA groups 1 and 2 and layers 0 and
2, ``starts``, lengths 1 and T, a bf16 pool, an fp32 q with an fp32 pool
and with an int8 pool, fp8 e4m3 pools (no scales) with bf16 and fp32 q,
the same bytes on both sides. Tolerances: 2e-2 where q or the pool is bf16 (the
JAX tests' own: both sides round P to bf16, at different softmax scales);
1e-5 in fp32 (the same fp32 products summed in another order). At a T that
is not a multiple of 128, which the Pallas kernel rejects, the reference is
the JAX package's masked attention. A row with nothing to attend need only
be finite: the Pallas kernel gives a uniform average there, the CUDA
kernel zeros, and no caller reads it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.kernels.kv_attention import kv_attention_decode as jdecode
from onebit_tpu.model import bitllama as jb
from onebit_tpu_torch.kernels import kv_attention as tka

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
L, B, NKV, HD = 3, 2, 4, 128


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(seed, g, t, pool, q_dtype):
    """q, and the pools: int8 with scales absmax/127-like, or float."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, NKV * g, HD).astype(np.float32)
    if pool == "int8":
        kv = [rng.randint(-127, 128, (L, B, t, NKV, HD)).astype(np.int8)
              for _ in range(2)]
        ks, vs = (rng.rand(L, B, t, NKV).astype(np.float32) * 0.02 + 0.001
                  for _ in range(2))
        pools = [kv[0], ks, kv[1], vs]
    else:
        pools = [rng.randn(L, B, t, NKV, HD).astype(np.float32), None,
                 rng.randn(L, B, t, NKV, HD).astype(np.float32), None]
    jq = jnp.asarray(q).astype(q_dtype)
    jpools = [None if p is None else jnp.asarray(p) for p in pools]
    if pool in ("bf16", "fp8"):
        dt = jnp.bfloat16 if pool == "bf16" else jnp.float8_e4m3fn
        jpools = [None if p is None else p.astype(dt) for p in jpools]
    return jq, jpools


def _port(jq, jpools):
    def conv(a):
        if a is None:
            return None
        if a.dtype == jnp.bfloat16:
            return _t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
        if a.dtype == jnp.float8_e4m3fn:    # the same bytes
            return _t(np.asarray(a).view(np.uint8)).view(
                torch.float8_e4m3fn)
        return _t(np.asarray(a))
    return conv(jq), [conv(p) for p in jpools]


def _check(got, want, live, tol):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[live], want[live], **tol)


CASES = {  # pool, q dtype, tolerance
    "int8_bf16q": ("int8", jnp.bfloat16, BF16_TOL),
    "int8_f32q": ("int8", jnp.float32, F32_TOL),
    "bf16": ("bf16", jnp.bfloat16, BF16_TOL),
    "f32": ("f32", jnp.float32, F32_TOL),
    "fp8_bf16q": ("fp8", jnp.bfloat16, BF16_TOL),
    "fp8_f32q": ("fp8", jnp.float32, F32_TOL),
}


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("layer", [0, 2])
def test_int8_matches_jax(g, layer):
    jq, jpools = _inputs(0, g, 256, "int8", jnp.bfloat16)
    lengths = [256, 100]
    want = jdecode(jq, *jpools, jnp.asarray(lengths, jnp.int32),
                   jnp.int32(layer), t_blk=128)
    q, pools = _port(jq, jpools)
    got = tka.kv_attention_decode(q, *pools, torch.tensor(lengths), layer)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _check(got, want, np.ones(B, bool), BF16_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("lengths,starts", [
    ([1, 256], None), ([200, 64], [3, 50]), ([256, 0], [0, 0])],
    ids=["len_1_and_T", "starts", "empty_row"])
def test_pools_match_jax(case, lengths, starts):
    pool, q_dtype, tol = CASES[case]
    jq, jpools = _inputs(3, 2, 256, pool, q_dtype)
    want = jdecode(jq, *jpools, jnp.asarray(lengths, jnp.int32),
                   jnp.int32(1),
                   starts=None if starts is None else jnp.asarray(
                       starts, jnp.int32), t_blk=128)
    q, pools = _port(jq, jpools)
    got = tka.kv_attention_decode(
        q, *pools, np.asarray(lengths, np.int32), 1,
        starts=None if starts is None else torch.tensor(starts))
    assert got.dtype == q.dtype
    live = np.asarray(lengths) > np.asarray(starts or [0] * B)
    _check(got, want, live, tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_t_not_a_multiple_of_128(case):
    """T = 200: the Pallas kernel has no block for it; the reference is
    the JAX package's masked attention on the layer."""
    pool, q_dtype, tol = CASES[case]
    t, layer = 200, 2
    jq, jpools = _inputs(9, 2, t, pool, q_dtype)
    lengths, starts = np.array([200, 37]), np.array([0, 5])
    cols = np.arange(t)[None, :]
    mask = jnp.asarray(((cols < lengths[:, None]) & (cols >= starts[:, None])
                        )[:, None, None, :])
    k, ks, v, vs = (None if p is None else p[layer] for p in jpools)
    if ks is not None:
        want = jb._attention_quant(jq[:, None], k, ks, v, vs, mask,
                                   num_kv_groups=2)[:, 0]
    else:
        want = jb._attention(jq[:, None], k.astype(jq.dtype),
                             v.astype(jq.dtype), mask, num_kv_groups=2)[:, 0]
    q, pools = _port(jq, jpools)
    got = tka.kv_attention_decode(q, *pools, torch.tensor(lengths), layer,
                                  starts=torch.tensor(starts))
    _check(got, want, np.ones(B, bool), tol)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_fp8_pool_reads_as_q_dtype(q_dtype):
    """An fp8 e4m3 pool attends as the same pool cast to q's dtype, bit
    for bit: every e4m3 value is exact in bf16 and f32 (JAX's
    ``k.astype(q.dtype)``), values past the normals, at 448 and NaN-free
    extremes included."""
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(B, NKV, HD).astype(np.float32)).to(
        q_dtype)
    pools = [torch.from_numpy(rng.randint(0, 256, (L, B, 128, NKV, HD),
                                          dtype=np.uint8)
                              ).view(torch.float8_e4m3fn) for _ in range(2)]
    for p in pools:     # NaN patterns (0x7f, 0xff) made finite
        p.view(torch.uint8)[(p.view(torch.uint8) & 0x7F) == 0x7F] = 0x7E
    lengths = torch.tensor([128, 77], dtype=torch.int32)
    got = tka.kv_attention_decode(q, pools[0], None, pools[1], None,
                                  lengths, 1)
    want = tka.kv_attention_decode(q, pools[0].to(q_dtype), None,
                                   pools[1].to(q_dtype), None, lengths, 1)
    assert got.dtype == q_dtype and torch.isfinite(got).all()
    assert torch.equal(got, want)
