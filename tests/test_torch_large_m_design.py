"""The arithmetic of K3's tensor-core design, held against JAX on the CPU
before any run on the card (``onebit_tpu_torch/csrc/bitlinear_large_m.cu``).

The fp32 instance splits fp32 ``y = x ⊙ g`` into three bf16 parts
(``split_bf16x3``) and sums their exact products with the ±1 signs in fp32.
That sum must be the fp32 product JAX's large-M kernel computes: 1e-5 of the
largest |z| (both sides sum 11008 terms of |y| < 8 in fp32, in other orders:
a random walk of about sqrt(K) 2**-24 of partial sums near |z|, a few 1e-6).
The column tile rule is pinned at the llama2-7b shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.core.packing import pack_signs_device
from onebit_tpu.kernels import bitlinear_pallas as jpl
from onebit_tpu_torch.core.packing import pack_signs_kmajor, unpack_signs_kmajor
from onebit_tpu_torch.kernels import bitlinear_cuda as bc

REL = 1e-5


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e3, 1e30])
def test_split_bf16x3_rebuilds_y(scale):
    """hi + mid + lo == y exactly wherever y's exponent leaves room for the
    three parts: y's last bit, 2**-23 of its leading one, must be a normal
    bf16 (|y| >= 2**-103; the samples here reach down to about 1e-25);
    hi is y rounded to bf16."""
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32)) * scale
    hi, mid, lo = bc.split_bf16x3(y)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, y.to(torch.bfloat16))
    rebuilt = hi.double() + mid.double() + lo.double()
    assert torch.equal(rebuilt, y.double())


def _case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    g = (1 + 0.5 * rng.standard_normal(k)).astype(np.float32)
    h = (rng.random(n) + 0.5).astype(np.float32)
    return x, w, g, h


def _three_passes(x, w, g, h):
    """The fp32 instance's product: the three bf16 parts of y, each times
    the ±1 signs (exact), summed in fp32, times h."""
    y = torch.from_numpy(x) * torch.from_numpy(g)
    sign = unpack_signs_kmajor(pack_signs_kmajor(torch.from_numpy(w)),
                               dtype=torch.float32)               # [N, K]
    z = sum(p.float() @ sign.T for p in bc.split_bf16x3(y))
    return z * torch.from_numpy(h)


@pytest.mark.parametrize("seed", [0, 1])
def test_three_passes_match_jax_large_m(seed):
    """At K = 11008 (down_proj) on a narrow N, against JAX's fp32
    ``_call_large_m`` in interpret mode."""
    x, w, g, h = _case(129, 11008, 128, seed)
    got = _three_passes(x, w, g, h).numpy()
    want = np.asarray(jpl._call_large_m(
        jnp.asarray(x), pack_signs_device(jnp.asarray(w)), jnp.asarray(g),
        jnp.asarray(h), 1e-5, True))
    assert want.dtype == np.float32 and want.shape == got.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("seed", [2, 3])
def test_three_passes_match_plain_large_m(seed):
    """The same sum against K3's plain version (raw: z ⊙ h in fp32)."""
    x, w, g, h = _case(130, 11008, 96, seed)
    got = _three_passes(x, w, g, h)
    want = bc.large_m_torch(
        torch.from_numpy(x), pack_signs_kmajor(torch.from_numpy(w)),
        torch.from_numpy(g)[None], torch.from_numpy(h), n_true=96, raw=True)
    assert (got - want).abs().max() <= REL * want.abs().max()


@pytest.mark.parametrize("n,ns,block_n", [
    (3 * 4096, 3, 128),      # llama2-7b fused q/k/v
    (4096, 1, 128),          # o_proj, down_proj
    (2 * 11008, 2, 128),     # fused gate/up (11008 = 86 x 128)
    (2048, 1, 128),          # a q shard at mp = 2
    (5504, 1, 128),          # a gate shard at mp = 2 (ragged last tile)
    (200, 1, 128),           # a single ragged projection
    (3 * 448, 3, 64),        # fused segments of 448: the 64-column tile
    (2 * 320, 2, 64),
    (2 * 384, 2, 128)])
def test_large_m_block_n_pinned(n, ns, block_n):
    assert bc.large_m_block_n(n, ns) == block_n
