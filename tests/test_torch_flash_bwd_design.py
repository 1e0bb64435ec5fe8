"""The arithmetic of B11-dkv's and B11-dq's fp32 design, held against JAX
and plain autograd on the CPU before any run on the card
(``onebit_tpu_torch/csrc/flash_attention_bwd.cu``).

``flash_causal_attention_bwd_split`` mirrors it step by step: q, k, v and
do split into three bf16 parts, each fp32 product six products of parts
(hi x hi summed apart from the five small ones), P and dS unrounded and
split for dV, dK and dQ, each tile's product afresh. Its residuals are
those of the kernel path: lse and the output of B11 fp32's mirror
(``flash_causal_attention_split``), di = Σ o·do in fp32.

Each gradient is held per (row, head) relative to that slice's largest
|value| (at least 1), to 1e-4 (chip_smoke.py FLASH_BWD_TOL, fp32): against
``jax.vjp`` of the JAX ``flash_causal_attention``, whose backward runs the
upstream Pallas kernels ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq`` in interpret mode (measured up to 3.1e-6),
and against autograd through the plain version at S = 1 and on the edges
of the 64-row tiles (measured up to 3.6e-6). q of std 5 peaks the softmax
and makes every gradient of order 1. With three products a product (hi x
hi, hi x mid, mid x hi) dP loses v's and do's low parts; at S = 1, where
dK and dQ are zero, di = Σ o·do then leaves dK 1.5e-4 - 2e-4 off: the
reason the kernels run six.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from onebit_tpu.kernels.attention import flash_causal_attention as jflash
from onebit_tpu_torch.kernels import attention as ta

TOL = 1e-4
THREE = ((0, 1), (1, 0))   # hi x mid, mid x hi beside hi x hi


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, s, nkv, g, hd, seed):
    rng = np.random.default_rng(seed)
    q = 5 * rng.standard_normal((b, s, nkv * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, s, nkv * g, hd)).astype(np.float32)
    return q, k, v, do


def _mirror(q, k, v, do, g, small=ta.SPLIT_SMALL):
    out, lse = ta.flash_causal_attention_split(q, k, v, num_kv_groups=g)
    di = (out * do).sum(-1).transpose(1, 2).contiguous()
    return ta.flash_causal_attention_bwd_split(q, k, v, do, lse, di,
                                               num_kv_groups=g, small=small)


def _plain(q, k, v, do, g):
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ta.flash_causal_attention_torch(*xs, num_kv_groups=g).backward(do)
    return [x.grad for x in xs]


def _row_head_err(got, want):
    top = want.abs().amax(dim=(1, 3)).clamp(min=1.0)
    return ((got - want).abs().amax(dim=(1, 3)) / top).max().item()


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("s", [128, 256])
def test_bwd_split_matches_jax(s, g, hd):
    q, k, v, do = _inputs(1, s, 2, g, hd, seed=s + g + hd)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, num_kv_groups=g),
                         *(jnp.asarray(x) for x in (q, k, v)))
        want = [torch.from_numpy(np.array(w)) for w in vjp(jnp.asarray(do))]
    got = _mirror(*(torch.from_numpy(x) for x in (q, k, v, do)), g)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        assert _row_head_err(a, w) <= TOL, name
        # every head of every gradient is of order 1: zeros would fail
        assert w.abs().amax(dim=(0, 1, 3)).min() >= 1.0, name


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 130])
def test_bwd_split_matches_plain(s, hd):
    """S = 1 and the edges of the kernels' 64-row tiles, GQA g = 2."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(2, s, 2, 2, hd, seed=s + hd))
    got = _mirror(q, k, v, do, 2)
    want = _plain(q, k, v, do, 2)
    for name, a, w in zip("qkv", got, want):
        assert a.shape == w.shape, name
        assert _row_head_err(a, w) <= TOL, name
    assert want[2].abs().max() >= 1.0     # dv is of order 1 at every S


@pytest.mark.parametrize("g", [2, 4])
def test_bwd_three_products_break_at_one_key(g):
    """At S = 1 (P = 1, dK and dQ zero) six products keep dK within 1e-4
    of plain autograd; three, which drop v's and do's low parts from dP,
    do not."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(2, 1, 2, g, 128, seed=g))
    want = _plain(q, k, v, do, g)
    six = _mirror(q, k, v, do, g)
    three = _mirror(q, k, v, do, g, small=THREE)
    assert _row_head_err(six[1], want[1]) <= TOL
    assert _row_head_err(three[1], want[1]) > TOL
