"""The port's model pieces against the JAX package at tiny sizes: config,
rope, rms_norm, attention, fuse_for_decode, random weights, and the ragged
decode step and batched prefill (logits and caches in fp32).

Tolerances: logits and caches agree to 2e-4 (test_decode_flat.py holds two
JAX paths to 2e-5; the port adds another summation order in every matmul
and another libm). Element-wise pieces agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.model import bitllama as jb
from onebit_tpu.model import ragged_decode as jrd
from onebit_tpu.model import rope as jrope
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch.core.packing import unpack_signs_kmajor
from onebit_tpu_torch.convert import params_from_jax
from onebit_tpu_torch.kernels import bitlinear as tbl
from onebit_tpu_torch.model import bitllama as tb
from onebit_tpu_torch.model import ragged_decode as trd
from onebit_tpu_torch.model import rope as trope
from onebit_tpu_torch.model.config import BitLlamaConfig

TOL = dict(rtol=2e-4, atol=2e-4)
EXACT_ISH = dict(rtol=1e-5, atol=1e-5)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _models(nkv):
    """(JAX config, JAX params, port config, port params), fused and not."""
    jc = JaxConfig.named("tiny", num_key_value_heads=nkv)
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(nkv)))
    c = BitLlamaConfig.named("tiny", num_key_value_heads=nkv)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), c, device="cpu")
    return jc, jp, c, tp


@pytest.fixture(scope="module", params=[2, 4], ids=["gqa", "mha"])
def models(request):
    return _models(request.param)


@pytest.fixture(params=[False, True], ids=["unfused", "fused"])
def variant(models, request):
    jc, jp, c, tp = models
    if request.param:
        jp, tp = jb.fuse_for_decode(jp, jc), tb.fuse_for_decode(tp, c)
    return jc, jp, c, tp


def test_config_matches_jax():
    for name in ("tiny", "llama2-7b", "llama2-13b"):
        a, b = BitLlamaConfig.named(name), JaxConfig.named(name)
        assert a.to_dict() == b.to_dict()
        assert (a.head_dim, a.num_kv_groups) == (b.head_dim, b.num_kv_groups)
    d = BitLlamaConfig.named("tiny", rope_scaling={"type": "linear",
                                                   "factor": 2.0}).to_dict()
    assert BitLlamaConfig.from_dict(d).to_dict() == \
        JaxConfig.from_dict(d).to_dict()
    for bad in ({"type": "yarn", "factor": 2.0}, {"type": "linear",
                                                  "factor": 1.0}):
        with pytest.raises(ValueError):
            BitLlamaConfig.named("tiny", rope_scaling=bad)


def test_config_json_roundtrip(tmp_path):
    c = BitLlamaConfig.named("tiny", rope_scaling={"type": "dynamic",
                                                   "factor": 4.0})
    c.save_json(str(tmp_path))
    assert BitLlamaConfig.from_json(str(tmp_path)).to_dict() == c.to_dict()
    assert JaxConfig.from_json(str(tmp_path)).to_dict() == c.to_dict()


@pytest.mark.parametrize("scaling,seq_len", [
    (None, None), ({"type": "linear", "factor": 2.0}, None),
    ({"type": "dynamic", "factor": 2.0}, 4096),
    ({"type": "dynamic", "factor": 2.0}, 1024)])
def test_rope_matches_jax(scaling, seq_len):
    pos = np.array([[0, 5, 17, 2047, 3000]], np.int32)
    want = jrope.rope_cos_sin(jnp.asarray(pos), 64, 10000.0, scaling, 2048,
                              seq_len=seq_len)
    got = trope.rope_cos_sin(torch.from_numpy(pos), 64, 10000.0, scaling,
                             2048, seq_len=seq_len)
    # one fp32 ulp of inv_freq (the two sides' pow differ) moves the angle
    # at position 3000 by up to 3000 * 2**-24 rad, about 1.8e-4
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=2e-4)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 5, 4, 64)).astype(np.float32)
    k = rng.standard_normal((1, 5, 2, 64)).astype(np.float32)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), *want)
    tq, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), *got)
    np.testing.assert_allclose(tq.numpy(), _np(jq), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tk.numpy(), _np(jk), rtol=0, atol=1e-3)


def test_rms_norm_and_attention_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tb.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        _np(jb.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **EXACT_ISH)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    mask = np.asarray(jb._causal_mask(3, 7, 4)) & \
        (np.arange(7) < np.array([6, 7])[:, None])[:, None, None, :]
    np.testing.assert_array_equal(
        tb._causal_mask(3, 7, 4).numpy(), np.asarray(jb._causal_mask(3, 7, 4)))
    got = tb._attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(mask),
                        num_kv_groups=2)
    want = jb._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(mask), num_kv_groups=2)
    np.testing.assert_allclose(got.numpy(), _np(want), **EXACT_ISH)


def test_fuse_for_decode(models):
    jc, jp, c, tp = models
    fused = tb.fuse_for_decode(tp, c)["layers"]
    jfused = jb.fuse_for_decode(jp, jc)["layers"]
    assert sorted(fused) == sorted(jfused)
    gu = fused["gateup_proj"]
    assert gu.packed.shape == (2, 256 // 32, 2 * 768)      # no pad at 768
    np.testing.assert_array_equal(
        unpack_signs_kmajor(gu.packed[:, :, 768:], torch.float32).numpy(),
        unpack_signs_kmajor(tp["layers"]["up_proj"].packed, torch.float32).numpy())
    if "qkv_proj" in fused:
        assert fused["qkv_proj"].input_factor.shape == (2, 3, 256)


def test_fuse_pads_segments():
    config = BitLlamaConfig(vocab_size=64, hidden_size=128,
                            intermediate_size=320, num_hidden_layers=1,
                            num_attention_heads=2)
    jc = JaxConfig.from_dict(config.to_dict())
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), config, device="cpu")
    gu = tb.fuse_for_decode(tp, config)["layers"]["gateup_proj"]
    assert gu.packed.shape[-1] == 2 * 384
    h = gu.weight_scale.reshape(1, 2, 384)
    assert (h[..., 320:] == 0).all() and (h[..., :320] != 0).all()
    x = torch.randn(3, 128)
    want = [tbl.bitlinear_apply_stacked(x, tp["layers"][n], 0)
            for n in ("gate_proj", "up_proj")]
    for a, b in zip(tbl.fused_bitlinear_apply_stacked(x, gu, 0, 320), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_random_params_match_jax():
    from onebit_tpu.utils.randinit import host_random_packed_params as jrand
    from onebit_tpu_torch.utils.randinit import host_random_packed_params
    c = BitLlamaConfig.named("tiny")
    jp = jrand(JaxConfig.named("tiny"), seed=5)
    tp = host_random_packed_params(c, seed=5, device="cpu")
    for name in ("embed_tokens", "lm_head"):
        assert tp[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp[name].view(torch.int16).numpy(),
                                      np.asarray(jp[name]).view(np.int16))
    from onebit_tpu.core.packing import unpack_signs_device
    for name, (out, inp) in tb._proj_dims(c).items():
        w = tp["layers"][name]
        np.testing.assert_array_equal(
            unpack_signs_kmajor(w.packed, dtype=torch.float32).numpy(),
            np.asarray(unpack_signs_device(jp["layers"][name].packed,
                                           dtype=jnp.float32)))
        assert w.input_factor.shape == (2, inp)


def _random_cache(config, b, max_len, seed):
    rng = np.random.default_rng(seed)
    shape = (config.num_hidden_layers, b, max_len,
             config.num_key_value_heads, config.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return (jb.KVCache(jnp.asarray(k), jnp.asarray(v)),
            tb.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())))


@pytest.mark.parametrize("pos0", [[3, 20, 0, 50], [3, 130, 0, 50]],
                         ids=["window128", "window256"])
def test_ragged_decode_step_matches_jax(variant, pos0):
    """Several steps with ragged positions and an inactive row (whose cache
    row is still written); the window ladder picks 128 or 256."""
    jc, jp, c, tp = variant
    jcache, tcache = _random_cache(c, 4, 256, seed=1)
    row_pos = np.array(pos0, np.int32)
    active = np.array([True, True, False, True])
    rng = np.random.default_rng(2)
    for step in range(3):
        ids = rng.integers(0, c.vocab_size, (4, 1)).astype(np.int32)
        jl, jcache = jrd.ragged_decode_step(
            jp, jcache, jnp.asarray(ids), jnp.asarray(row_pos),
            jnp.asarray(active), jc, impl="xla", compute_dtype=jnp.float32)
        tl, tcache = trd.ragged_decode_step(
            tp, tcache, torch.from_numpy(ids.astype(np.int64)), row_pos,
            active, c, compute_dtype=torch.float32)
        assert tl.shape == (4, 1, c.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), _np(jl), err_msg=f"step {step}",
                                   **TOL)
        np.testing.assert_allclose(tcache.k.numpy(), _np(jcache.k), **TOL)
        np.testing.assert_allclose(tcache.v.numpy(), _np(jcache.v), **TOL)
        row_pos = row_pos + active


def test_attention_width_ladder():
    assert trd.attention_widths(64) == [64]
    assert trd.attention_widths(256) == [128, 256]
    assert trd.attention_widths(600) == [128, 256, 512, 600]
    pos, act = np.array([3, 300, 0]), np.array([True, False, True])
    assert trd.attention_width(pos, act, 600) == 128     # inactive ignored
    assert trd.attention_width(np.array([127]), np.array([True]), 600) == 128
    assert trd.attention_width(np.array([128]), np.array([True]), 600) == 256
    assert trd.attention_width(np.array([599]), np.array([True]), 600) == 600


@pytest.mark.parametrize("s_pad,lengths", [(32, [20, 32]), (128, [100, 128])],
                         ids=["small_m", "large_m"])
def test_prefill_rows_matches_jax(variant, s_pad, lengths):
    """R = 2 prompts into rows 2 and 0; 2 x 128 = 256 rows take the
    large-M kernel's plain version."""
    jc, jp, c, tp = variant
    jcache, tcache = _random_cache(c, 3, 256, seed=3)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, c.vocab_size, (2, s_pad)).astype(np.int32)
    lens = np.array(lengths, np.int32)
    rows = np.array([2, 0], np.int32)
    jl, jcache = jrd.prefill_rows(
        jp, jcache, jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(rows),
        jc, impl="xla", compute_dtype=jnp.float32)
    tl, tcache = trd.prefill_rows(
        tp, tcache, torch.from_numpy(ids.astype(np.int64)),
        torch.from_numpy(lens), torch.from_numpy(rows), c,
        compute_dtype=torch.float32)
    assert tl.shape == (2, c.vocab_size)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    np.testing.assert_allclose(tcache.k.numpy(), _np(jcache.k), **TOL)
    np.testing.assert_allclose(tcache.v.numpy(), _np(jcache.v), **TOL)


def test_decode_step_rejects_multi_token():
    _, _, c, tp = _models(2)
    cache = tb.init_kv_cache(c, 2, 16, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="one token"):
        trd.ragged_decode_step(tp, cache, torch.zeros(2, 2, dtype=torch.long),
                               np.zeros(2), np.ones(2, bool), c)
