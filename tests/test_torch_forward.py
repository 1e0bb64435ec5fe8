"""The port's full-sequence ``forward`` against the JAX ``forward`` at the
tiny config in fp32, on JAX packed params (``pack_model_params`` of
``init_params``) carried over by ``params_from_jax``.

Logits (and pre-logits) agree to 2e-4, as the decode step's do
(tests/test_torch_model.py): another summation order in every matmul and
another libm. The JAX side runs its flash path (the Pallas TPU kernel in
interpret mode) where ``use_flash=True``; the port on the CPU runs B11's
plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch.convert import params_from_jax
from onebit_tpu_torch.kernels import attention_cuda as fc
from onebit_tpu_torch.model import bitllama as tb
from onebit_tpu_torch.model.config import BitLlamaConfig

TOL = dict(rtol=2e-4, atol=2e-4)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _models(mode, nkv=2):
    jc = JaxConfig.named("tiny", num_key_value_heads=nkv)
    jp = jb.init_params(jc, jax.random.PRNGKey(7), mode=mode)
    if mode == "latent":
        jp = jb.pack_model_params(jp)
    c = BitLlamaConfig.named("tiny", num_key_value_heads=nkv)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), c, device="cpu")
    return jc, jp, c, tp


@pytest.fixture(scope="module")
def packed():
    return _models("latent")


def _ids(c, b, s, seed):
    return np.random.default_rng(seed).integers(0, c.vocab_size, (b, s)
                                                ).astype(np.int32)


def _both(jp, tp, jc, c, ids, **kw):
    jkw = dict(kw)
    if "attention_mask" in kw:
        jkw["attention_mask"] = jnp.asarray(kw["attention_mask"])
        kw["attention_mask"] = torch.from_numpy(kw["attention_mask"])
    want = jb.forward(jp, jnp.asarray(ids), jc, compute_dtype=jnp.float32,
                      **jkw)
    got = tb.forward(tp, torch.from_numpy(ids.astype(np.int64)), c,
                     compute_dtype=torch.float32, **kw)
    return got, _np(want)


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "masked"])
def test_forward_matches_jax(packed, use_flash):
    """S = 128, the Pallas kernel's block: the JAX flash path runs the TPU
    kernel in interpret mode."""
    jc, jp, c, tp = packed
    ids = _ids(c, 2, 128, seed=1)
    with pltpu.force_tpu_interpret_mode():
        got, want = _both(jp, tp, jc, c, ids, use_flash=use_flash)
    assert got.shape == (2, 128, c.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_forward_any_length(packed):
    """The port's flash path takes any S (the TPU kernel's 128-blocks do
    not): S = 17 equals the JAX masked path."""
    jc, jp, c, tp = packed
    ids = _ids(c, 3, 17, seed=2)
    got, want = _both(jp, tp, jc, c, ids, use_flash=False)
    flash = tb.forward(tp, torch.from_numpy(ids.astype(np.int64)), c,
                       compute_dtype=torch.float32, use_flash=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(flash, got)


@pytest.mark.parametrize("side", ["left", "right"])
def test_forward_padding_mask(packed, side):
    """Left padding shifts positions (max(cumsum - 1, 0)); right padding
    masks trailing keys. ``use_flash=True`` with a mask takes the masked
    attention, as in JAX."""
    jc, jp, c, tp = packed
    ids = _ids(c, 3, 48, seed=3)
    lengths = np.array([48, 30, 5])
    pos = np.arange(48)[None, :]
    keep = (pos >= 48 - lengths[:, None]) if side == "left" else \
        (pos < lengths[:, None])
    mask = keep.astype(np.int32)
    got, want = _both(jp, tp, jc, c, ids, attention_mask=mask,
                      use_flash=True)
    np.testing.assert_allclose(got.numpy()[keep], want[keep], **TOL)


def test_forward_prelogits(packed):
    jc, jp, c, tp = packed
    ids = _ids(c, 2, 20, seed=4)
    got, want = _both(jp, tp, jc, c, ids, return_prelogits=True)
    assert got.shape == (2, 20, c.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("nkv", [2, 4], ids=["gqa", "mha"])
def test_forward_teacher_linear_weights(nkv):
    """The FP teacher: ``LinearWeights`` projections dispatch to a plain
    matmul, as the JAX ``_project`` does."""
    jc, jp, c, tp = _models("linear", nkv=nkv)
    assert type(tp["layers"]["q_proj"]).__name__ == "LinearWeights"
    ids = _ids(c, 2, 24, seed=5)
    got, want = _both(jp, tp, jc, c, ids, use_flash=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_forward_impl_torch_and_no_launch_on_cpu(packed):
    """On the CPU ``impl="torch"`` and ``"auto"`` run the same plain
    versions, and no kernel is counted."""
    _, _, c, tp = packed
    ids = torch.from_numpy(_ids(c, 2, 33, seed=6).astype(np.int64))
    before = [k.launches for k in fc.KERNELS]
    a = tb.forward(tp, ids, c, compute_dtype=torch.float32, use_flash=True)
    b = tb.forward(tp, ids, c, compute_dtype=torch.float32, impl="torch")
    assert torch.equal(a, b)
    assert [k.launches for k in fc.KERNELS] == before


@pytest.mark.parametrize("option", ["output_hidden_states",
                                    "output_attentions", "remat"])
def test_forward_unported_options_raise(packed, option):
    """The training options, which raised until training was ported, now
    run and give the JAX forward's outputs (hidden states ``[L+1, B, S,
    d]``, attention maps ``[L, B, nh, S, S]``, remat the same logits)."""
    jc, jp, c, tp = packed
    ids = _ids(c, 2, 24, seed=8)
    if option == "remat":
        got, want = _both(jp, tp, jc, c, ids, remat=True)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        return
    jout = jb.forward(jp, jnp.asarray(ids), jc, compute_dtype=jnp.float32,
                      **{option: True})
    got = tb.forward(tp, torch.from_numpy(ids.astype(np.int64)), c,
                     compute_dtype=torch.float32, **{option: True})
    assert len(got) == 2 and got[1].shape == jout[1].shape
    for a, w in zip(got, jout):
        np.testing.assert_allclose(a.numpy(), _np(w), **TOL)
