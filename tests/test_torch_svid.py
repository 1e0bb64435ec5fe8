"""The port's SVID init and start checkpoint against the JAX package's, on
the same numpy weights.

Power iteration is deterministic: ``rank1_power`` and ``build_start_params``
agree with JAX to 1e-5 of each vector's largest value (fp32 matrix-vector
products summed in another order, 50 iterations that converge rather than
amplify). ``rank1_nmf`` draws its start from a ``torch.Generator`` (JAX from
``jax.random``, which torch cannot repeat), so it is held to the fixed
point: ``h·gᵀ`` equal to JAX's ``h·gᵀ`` to 1e-4 of its largest value (the
scale split between h and g differs; the forward normalizes it away).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.core import svid as jsvid
from onebit_tpu.core.build_start import build_start_params as jbuild
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch.convert import params_from_jax, params_to_numpy
from onebit_tpu_torch.core import svid as tsvid
from onebit_tpu_torch.core.build_start import build_start_params
from onebit_tpu_torch.model.config import BitLlamaConfig


def _weight(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err / np.abs(want).max()


@pytest.mark.parametrize("shape", [(96, 64), (256, 768), (3, 40, 24)])
def test_rank1_power_matches_jax(shape):
    """One matrix, and a stack of three (the layer axis) at once."""
    w = np.abs(_weight(shape, seed=len(shape)))
    h, g = tsvid.rank1_power(torch.from_numpy(w))
    for i in range(shape[0] if len(shape) == 3 else 1):
        wi = w[i] if len(shape) == 3 else w
        jh, jg = jsvid.rank1_power(jnp.asarray(wi))
        _close(h[i] if len(shape) == 3 else h, jh)
        _close(g[i] if len(shape) == 3 else g, jg)


def test_svid_matches_jax():
    w = _weight((128, 96), seed=5)
    w[0, :3] = 0.0                         # sign(0) = 0 on both sides
    got = tsvid.svid(torch.from_numpy(w))
    want = jsvid.svid(jnp.asarray(w))
    np.testing.assert_array_equal(got.sign_w.numpy(), np.asarray(want.sign_w))
    _close(got.weight_scale, want.weight_scale)
    _close(got.input_factor, want.input_factor)
    latent, h, g = tsvid.svid_latent_init(torch.from_numpy(w))
    jl, _, _ = jsvid.svid_latent_init(jnp.asarray(w))
    assert latent.dtype == torch.float32
    np.testing.assert_array_equal(latent.numpy(), np.asarray(jl))


def test_rank1_nmf_reaches_the_fixed_point():
    w = np.abs(_weight((64, 48), seed=6)) + 0.1
    gen = torch.Generator()
    gen.manual_seed(0)
    h, g = tsvid.rank1_nmf(torch.from_numpy(w), generator=gen)
    jh, jg = jsvid.rank1_nmf(jnp.asarray(w))
    ph, pg = jsvid.rank1_power(jnp.asarray(w))
    want = np.outer(np.asarray(jh), np.asarray(jg))
    got = np.outer(h.numpy(), g.numpy())
    _close(got, want, tol=1e-4)
    _close(got, np.outer(np.asarray(ph), np.asarray(pg)), tol=1e-4)
    with pytest.raises(ValueError, match="unknown SVID method"):
        tsvid.svid(torch.from_numpy(w), method="svd")


@pytest.mark.parametrize("method", ["power", "nmf"])
def test_build_start_params_matches_jax(method):
    """A plain teacher of the tiny config (GQA): every projection's latent
    ``sign(W)·0.01`` bit-equal, h and g to 1e-5 (power) or ``h·gᵀ`` to
    1e-4 (nmf); embeddings, lm_head and norms pass through untouched."""
    jc = JaxConfig.named("tiny")
    teacher = jb.init_params(jc, jax.random.PRNGKey(3), mode="linear")
    c = BitLlamaConfig.named("tiny")
    tp = params_from_jax(jax.tree.map(np.asarray, teacher), c, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(1)
    got = params_to_numpy(build_start_params(tp, method=method,
                                             generator=gen))
    want = jax.tree.map(np.asarray, jbuild(teacher, method=method))
    for key in ("embed_tokens", "lm_head", "final_norm"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["layers"]["input_layernorm"].tobytes() == \
        want["layers"]["input_layernorm"].tobytes()
    for name in jb.PROJ_NAMES:
        gw, ww = got["layers"][name], want["layers"][name]
        assert list(gw) == ["weight_scale", "input_factor", "latent"]
        assert gw["latent"].dtype == np.float32
        np.testing.assert_array_equal(gw["latent"], ww.latent)
        if method == "power":
            _close(gw["weight_scale"], ww.weight_scale)
            _close(gw["input_factor"], ww.input_factor)
        else:
            for i in range(c.num_hidden_layers):
                _close(np.outer(gw["weight_scale"][i], gw["input_factor"][i]),
                       np.outer(ww.weight_scale[i], ww.input_factor[i]),
                       tol=1e-4)
