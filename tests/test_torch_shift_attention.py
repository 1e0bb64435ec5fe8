"""S²-Attn (``kernels/shift_attention.py``) against the JAX function on
the same inputs: fp32 to 1e-5 (two einsums and a softmax over at most 8
keys), with one group, several groups, GQA, and the refusal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.kernels.shift_attention import (
    shift_short_attention as jax_s2)
from onebit_tpu_torch.kernels.shift_attention import shift_short_attention


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("s,group,nkv", [(8, 8, 4), (16, 4, 4), (16, 8, 2)],
                         ids=["one_group", "groups", "gqa"])
def test_matches_jax(s, group, nkv):
    b, nh, hd = 2, 4, 16
    q = _rand((b, s, nh, hd), 0)
    k, v = _rand((b, s, nkv, hd), 1), _rand((b, s, nkv, hd), 2)
    got = shift_short_attention(*map(torch.from_numpy, (q, k, v)),
                                group_size=group, num_kv_groups=nh // nkv)
    want = jax_s2(*map(jnp.asarray, (q, k, v)), group_size=group,
                  num_kv_groups=nh // nkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_invalid_group():
    q = torch.zeros((1, 6, 2, 4))
    with pytest.raises(ValueError, match="divisible"):
        shift_short_attention(q, q, q, group_size=4)
