"""The gradient of B11's plain version (autograd through
``onebit_tpu_torch/kernels/attention.py`` ``_attention`` under the causal
mask) against ``jax.grad`` of the JAX ``flash_causal_attention``, whose
backward runs the upstream Pallas TPU kernels ``_flash_attention_bwd_dkv``
and ``_flash_attention_bwd_dq``, here in interpret mode, on the same numpy
inputs and output cotangent.

Tolerances, relative to each gradient's largest magnitude: fp32 to 1e-5
(sums in other orders; the Pallas kernels recompute P from the forward's
softmax statistics; measured about 1e-6). bf16 to 2**-6: each side rounds
its gradients to bf16, at most one bf16 ulp apart (2**-7 of the top
binade, so at most 2**-7 of the largest value), and rounds operands at
different places before that (the Pallas kernels round P and dS to bf16
before their products, the plain version P and dP), relative errors of
2**-9 per term of sums whose terms peak near the result; measured up to
7.7e-3. q of std 5 peaks the softmax and makes every gradient of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from onebit_tpu.kernels.attention import flash_causal_attention as jflash
from onebit_tpu_torch.kernels import attention as ta
from onebit_tpu_torch.kernels import attention_cuda as fc

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2 ** -6)}


def _inputs(b, s, nkv, g, hd, seed):
    rng = np.random.default_rng(seed)
    q = 5 * rng.standard_normal((b, s, nkv * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, s, nkv * g, hd)).astype(np.float32)
    return q, k, v, do


def _plain_grads(fn, q, k, v, do, g):
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*xs, num_kv_groups=g)
    out.backward(do)
    return out.detach(), [x.grad for x in xs]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [128, 256])
def test_plain_grad_matches_jax_flash(dtype, g, s):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v, do = (torch.from_numpy(a).to(tdt)
                   for a in _inputs(1, s, 2, g, 64, seed=s + g))
    _, got = _plain_grads(ta.flash_causal_attention_torch, q, k, v, do, g)
    with pltpu.force_tpu_interpret_mode():
        jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), jdt)
                           for x in (q, k, v, do))
        _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, num_kv_groups=g),
                         jq, jk, jv)
        want = vjp(jdo)
    for name, a, w in zip("qkv", got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert a.dtype == tdt and a.shape == w.shape, name
        top = np.abs(w).max()
        err = np.abs(a.float().numpy() - w).max()
        assert err <= tol * top, (name, err / top, tol)
        # every (head) of every gradient is of order 1: zeros would fail
        assert np.abs(w).max(axis=(0, 1, 3)).min() >= 0.1, name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cpu_wrapper_backward_is_plain_autograd(dtype):
    """On the CPU the wrapper is its plain version, gradients included: the
    same bits as autograd through ``flash_causal_attention_torch``, and no
    kernel is counted."""
    tdt = DTYPES[dtype][0]
    q, k, v, do = (torch.from_numpy(a).to(tdt)
                   for a in _inputs(2, 37, 2, 4, 64, seed=3))
    before = [info.launches for info in fc.KERNELS]
    out, got = _plain_grads(ta.flash_causal_attention, q, k, v, do, 4)
    ref_out, want = _plain_grads(ta.flash_causal_attention_torch, q, k, v,
                                 do, 4)
    assert torch.equal(out, ref_out)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert [info.launches for info in fc.KERNELS] == before


def test_backward_launch_checks_run_before_any_build():
    """The backward kernels' checks raise on tensors they do not take
    before any library is built or loaded."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 2, 64, 0))
    lse = di = torch.zeros(1, 4, 8)
    for launch in (fc.launch_bwd_dkv, fc.launch_bwd_dq):
        with pytest.raises(TypeError, match="q must be"):
            launch(q.half(), k, v, do, lse, di, 2)
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch(q, k, v, do, lse, di, 2)
    assert {i.name for i in fc.KERNELS} >= {
        "flash_causal_attention_bwd_dkv_f32",
        "flash_causal_attention_bwd_dq_bf16"}
