"""B11's plain version (``onebit_tpu_torch/kernels/attention.py``) against the
JAX ``flash_causal_attention``, which runs the upstream Pallas TPU flash
kernel, here in interpret mode, on the same numpy inputs.

Tolerances: fp32 to 2e-5 (the two sides sum the dots and the PV product in
other orders, and the Pallas kernel rescales its accumulator at every key
block). bf16: both sides round P to bf16 (2**-9 relative) at different
scales (the Pallas kernel P = exp(s - m) at each block's running max, the
plain version the normalized probabilities), so their fp32 contexts lie at
most 2**-8 * max|v| apart; each then rounds to bf16, which adds at most one
bf16 ulp of the largest |ctx|. The test computes that bound from the
inputs. q of std 5 peaks the softmax, so the context is of order 1.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from onebit_tpu.kernels.attention import flash_causal_attention as jflash
from onebit_tpu_torch.kernels import attention as ta
from onebit_tpu_torch.kernels import attention_cuda as fc
from onebit_tpu_torch.model import bitllama as tb

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(b, s, nkv, g, hd, seed):
    rng = np.random.default_rng(seed)
    q = 5 * rng.standard_normal((b, s, nkv * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [128, 256])
def test_plain_matches_jax_flash(dtype, g, s):
    tdt, jdt = DTYPES[dtype]
    q, k, v = _inputs(2, s, 2, g, 64, seed=s + g)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = ta.flash_causal_attention_torch(tq, tk, tv, num_kv_groups=g)
    with pltpu.force_tpu_interpret_mode():
        want = jflash(jnp.asarray(tq.float().numpy(), jdt),
                      jnp.asarray(tk.float().numpy(), jdt),
                      jnp.asarray(tv.float().numpy(), jdt), num_kv_groups=g)
    assert got.dtype == tdt and got.shape == (2, s, 2 * g, 64)
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    if tdt == torch.float32:
        tol = 2e-5
    else:
        top = np.abs(want).max()
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        tol = 2 ** -8 * np.abs(tv.float().numpy()).max() + ulp
    assert err <= tol, (err, tol)
    # the context is of order 1 on every (row, head): zeros would fail
    assert np.abs(want).max(axis=(1, 3)).min() >= 8 * tol


@pytest.mark.parametrize("s", [1, 17])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_is_masked_attention(s, dtype):
    """The plain version is ``_attention`` under the causal mask: one
    function, equal to the bit."""
    tdt = DTYPES[dtype][0]
    q, k, v = (torch.from_numpy(a).to(tdt)
               for a in _inputs(3, s, 2, 4, 64, seed=s))
    got = ta.flash_causal_attention_torch(q, k, v, num_kv_groups=4)
    want = tb._attention(q, k, v, tb._causal_mask(s, s, 0),
                         num_kv_groups=4)
    assert torch.equal(got, want)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 40, 2, 2, 64, 0))
    before = [info.launches for info in fc.KERNELS]
    got = ta.flash_causal_attention(q, k, v, num_kv_groups=2)
    assert torch.equal(got, ta.PLAIN[ta.flash_causal_attention](
        q, k, v, num_kv_groups=2))
    assert [info.launches for info in fc.KERNELS] == before


def test_launch_checks_run_before_any_build():
    """The kernel's checks raise on tensors it does not take before any
    library is built or loaded, so they run without a CUDA toolkit."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 2, 64, 0))
    with pytest.raises(TypeError, match="q must be"):
        fc.launch(q.half(), k, v, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fc.launch(q, k, v, 2)
