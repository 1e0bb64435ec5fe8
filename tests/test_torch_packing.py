"""The port's sign packing and weight converter against the JAX package's
packing functions: every comparison is bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.core import packing as jp
from onebit_tpu.kernels.bitlinear import BitLinearWeights as JaxBLW
from onebit_tpu_torch.convert import params_from_jax
from onebit_tpu_torch.core import packing as tp
from onebit_tpu_torch.model.config import BitLlamaConfig


def _w(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 64), (3, 5, 96)])
def test_canonical_words_match_jax(shape):
    w = _w(shape, 0)
    want = np.asarray(jp.pack_signs(jnp.asarray(w)))
    got = tp.pack_signs(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tp.unpack_signs(got, dtype=torch.float32).numpy(),
        np.asarray(jp.unpack_signs(jnp.asarray(want), dtype=jnp.float32)))


def test_canonical_pack_other_axis():
    w = _w((64, 6), 1)
    want = np.asarray(jp.pack_signs(jnp.asarray(w), axis=0))
    got = tp.pack_signs(torch.from_numpy(w), axis=0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tp.unpack_signs(got, dtype=torch.float32, axis=0).numpy(),
        np.sign(w) + (w == 0))


def test_int8_reference_format_matches_jax():
    w = _w((5, 64), 2)
    b = tp.pack_signs_int8_np(w)
    np.testing.assert_array_equal(b, jp.pack_signs_int8_np(w))
    np.testing.assert_array_equal(tp.unpack_signs_int8_np(b),
                                  jp.unpack_signs_int8_np(b))
    words = tp.int8_bytes_to_words_np(b)
    np.testing.assert_array_equal(words, jp.int8_bytes_to_words_np(b))
    np.testing.assert_array_equal(jp.words_to_int8_bytes_np(words), b)
    # the int8 checkpoint viewed as int32 is the canonical word format
    np.testing.assert_array_equal(words, tp.pack_signs(torch.from_numpy(w))
                                  .numpy())


def test_device_layout_reader_matches_jax():
    w = _w((2, 48, 128), 3)                       # [L, out, in]
    words = np.array(jp.pack_signs_device(jnp.asarray(w)))
    want = np.asarray(jp.unpack_signs_device(jnp.asarray(words),
                                             dtype=jnp.float32))
    got = tp.unpack_signs_device(torch.from_numpy(words), dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_to_kmajor_is_exact():
    """TPU words with every bit pattern (random int32, sign bit included)
    convert to the port's layout holding the same signs."""
    words = np.random.default_rng(4).integers(
        -2 ** 31, 2 ** 31 - 1, (8, 40), dtype=np.int64).astype(np.int32)
    dense = np.array(jp.unpack_signs_device(jnp.asarray(words),
                                            dtype=jnp.float32))
    km = tp.device_to_kmajor(torch.from_numpy(words))
    assert km.dtype == torch.int32 and km.shape == (8, 40)
    np.testing.assert_array_equal(
        tp.unpack_signs_kmajor(km, dtype=torch.float32).numpy(), dense)
    np.testing.assert_array_equal(
        km.numpy(), tp.pack_signs_kmajor(torch.from_numpy(dense)).numpy())


def test_kmajor_layout_is_transposed_canonical():
    w = _w((24, 64), 5)                           # [out, in]
    km = tp.pack_signs_kmajor(torch.from_numpy(w))
    assert km.shape == (2, 24)
    np.testing.assert_array_equal(
        km.numpy(), np.asarray(jp.pack_signs(jnp.asarray(w))).T)
    # a reference int8 checkpoint loads with one transpose
    np.testing.assert_array_equal(
        tp.int8_bytes_to_words_np(jp.pack_signs_int8_np(w)).T, km.numpy())
    # bit j of word (i, n) is the sign of in-index 32*i + j of column n
    n, k = 7, 45
    bit = (int(km[k // 32, n]) >> (k % 32)) & 1
    assert bit == int(w[n, k] < 0)


def test_converter_carries_jax_params():
    config = BitLlamaConfig.named("tiny")
    from onebit_tpu.model.bitllama import init_params, pack_model_params
    from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
    jparams = pack_model_params(init_params(JaxConfig.named("tiny"),
                                            jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(tree, config, device="cpu")
    np.testing.assert_array_equal(params["embed_tokens"].numpy(),
                                  tree["embed_tokens"])
    for name, w in tree["layers"].items():
        if not isinstance(w, JaxBLW):
            np.testing.assert_array_equal(params["layers"][name].numpy(), w)
            continue
        pw = params["layers"][name]
        assert pw.packed.shape == w.packed.shape
        np.testing.assert_array_equal(
            tp.unpack_signs_kmajor(pw.packed, dtype=torch.float32).numpy(),
            np.asarray(jp.unpack_signs_device(jnp.asarray(w.packed),
                                              dtype=jnp.float32)))
        assert pw.weight_scale.dtype == torch.float32
        np.testing.assert_array_equal(pw.input_factor.numpy(),
                                      w.input_factor)


def test_converter_rejects_fused_and_unpacked():
    from onebit_tpu.model.bitllama import (fuse_for_decode, init_params,
                                           pack_model_params)
    from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
    jc = JaxConfig.named("tiny")
    latent = init_params(jc, jax.random.PRNGKey(0))
    config = BitLlamaConfig.named("tiny")
    # latent (training) projections convert; dense-sign ones do not
    params_from_jax(jax.tree.map(np.asarray, latent), config, device="cpu")
    dense = dict(latent, layers={
        k: (v._replace(latent=None, dense_sign=np.sign(np.asarray(v.latent)))
            if hasattr(v, "latent") else v)
        for k, v in latent["layers"].items()})
    with pytest.raises(ValueError, match="only packed"):
        params_from_jax(jax.tree.map(np.asarray, dense), config,
                        device="cpu")
    fused = fuse_for_decode(pack_model_params(latent), jc)
    with pytest.raises(ValueError, match="fuse_for_decode"):
        params_from_jax(jax.tree.map(np.asarray, fused), config,
                        device="cpu")


def test_converter_bfloat16_leaves():
    config = BitLlamaConfig.named("tiny", num_hidden_layers=1)
    from onebit_tpu.utils.randinit import host_random_packed_params
    from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
    jparams = host_random_packed_params(
        JaxConfig.named("tiny", num_hidden_layers=1), seed=3)
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(tree, config, device="cpu")
    assert params["lm_head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["lm_head"].float().numpy(),
        np.asarray(jparams["lm_head"].astype(jnp.float32)))
