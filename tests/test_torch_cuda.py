"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file
imports no JAX (the card's machine has none); run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 outputs to 1e-3 (LayerNorm outputs of order 1; the kernel
sums the K products in another order and uses the hardware rsqrt); bf16
outputs to 0.0625 (two bf16 ulps below 8: a sum near a rounding boundary
may round the other way).
"""

import pytest
import torch

from onebit_tpu_torch.kernels import bitlinear_cuda as bc

TOL = {torch.float32: 1e-3, torch.bfloat16: 0.0625}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, m, k, n_true, ns=1, seg_pad=None, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    seg_pad = seg_pad or n_true
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    g = (1 + 0.5 * torch.randn(ns, k, generator=gen, device=dev)).to(dtype)
    h = torch.rand(ns, seg_pad, generator=gen, device=dev) + 0.5
    h[:, n_true:] = 0
    packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (k // 32, ns * seg_pad),
                           generator=gen, device=dev, dtype=torch.int64
                           ).to(torch.int32)
    bias = torch.randn(ns * seg_pad, generator=gen, device=dev)
    return x, g, h.reshape(-1).contiguous(), packed, bias


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (8, 4096, 4096),
                                   (37, 1024, 200), (128, 11008, 512)])
def test_small_m_matches_plain(dev, dtype, m, k, n):
    x, g, h, packed, bias = _case(dev, dtype, m, k, n)
    before = bc.SMALL_M.launches
    _close(bc.small_m(x, packed, g[0], h), bc.small_m_torch(x, packed, g[0], h),
           dtype)
    assert bc.SMALL_M.launches == before + 1
    _close(bc.small_m(x, packed, g[0], h, bias),
           bc.small_m_torch(x, packed, g[0], h, bias), dtype)
    raw = bc.small_m(x, packed, g[0], h, raw=True)
    want = bc.small_m_torch(x, packed, g[0], h, raw=True)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert (raw - want).abs().max().item() <= 1e-5 * scale * k ** 0.5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n_true,ns,seg_pad", [
    (8, 4096, 4096, 3, 4096), (8, 4096, 11008, 2, 11008),
    (5, 512, 300, 3, 320), (128, 256, 384, 2, 448)])
def test_fused_small_m_matches_plain(dev, dtype, m, k, n_true, ns, seg_pad):
    x, g, h, packed, _ = _case(dev, dtype, m, k, n_true, ns, seg_pad)
    before = bc.FUSED_SMALL_M.launches
    got = bc.fused_small_m(x, packed, g, h, n_true=n_true)
    assert bc.FUSED_SMALL_M.launches == before + 1
    assert got.shape == (ns, m, n_true)
    _close(got, bc.fused_small_m_torch(x, packed, g, h, n_true=n_true), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n_true,ns,seg_pad", [
    (129, 256, 200, 1, 200), (300, 1024, 384, 3, 448),
    (1024, 4096, 4096, 1, 4096), (256, 11008, 512, 2, 512)])
def test_large_m_matches_plain(dev, dtype, m, k, n_true, ns, seg_pad):
    x, g, h, packed, bias = _case(dev, dtype, m, k, n_true, ns, seg_pad)
    before = bc.LARGE_M.launches
    got = bc.large_m(x, packed, g, h, n_true=n_true)
    assert bc.LARGE_M.launches == before + 1
    _close(got, bc.large_m_torch(x, packed, g, h, n_true=n_true), dtype)
    if ns == 1:
        _close(bc.large_m(x, packed, g, h, n_true=n_true, bias=bias),
               bc.large_m_torch(x, packed, g, h, n_true=n_true, bias=bias),
               dtype)


def test_wrappers_check_inputs(dev):
    x, g, h, packed, _ = _case(dev, torch.float32, 8, 256, 128)
    with pytest.raises(TypeError, match="g must be"):
        bc.small_m(x, packed, g[0].to(torch.bfloat16), h)
    with pytest.raises(ValueError, match="contiguous"):
        bc.small_m(x.t().contiguous().t(), packed, g[0], h)
    with pytest.raises(ValueError, match="at most"):
        bc.small_m(torch.zeros(129, 256, device=dev), packed, g[0], h)
    with pytest.raises(ValueError, match="match"):
        bc.small_m(x[:, :128].contiguous(), packed, g[0], h)
    with pytest.raises(ValueError, match="segments"):
        bc.fused_small_m(x, packed, torch.cat([g, g, g]), h, n_true=32)


def test_engine_kernel_path_matches_plain(dev):
    """A small model served on the card: the first decode step's logits
    through the kernels agree with impl="torch" in fp32, and every kernel
    launched."""
    import numpy as np
    from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                                  fuse_for_decode, host_random_packed_params)
    from onebit_tpu_torch.model.ragged_decode import ragged_decode_step
    config = BitLlamaConfig.named("tiny", num_key_value_heads=4,
                                  max_position_embeddings=512)
    params = fuse_for_decode(host_random_packed_params(
        config, seed=1, dtype=torch.float32, device=dev), config)
    eng = ContinuousBatchingEngine(params, config, max_batch=4, max_len=256,
                                   compute_dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    for n in (150, 140, 7, 3):
        eng.add_request(rng.integers(3, 500, n).tolist(), max_new_tokens=4)
    bc.reset_launch_counts()
    eng._admit()
    tokens = torch.from_numpy(eng.next_token[:, None].astype(np.int64)).to(dev)
    out = {}
    for impl in ("auto", "torch"):
        cache = type(eng.cache)(eng.cache.k.clone(), eng.cache.v.clone())
        out[impl], _ = ragged_decode_step(
            params, cache, tokens, eng.row_pos, np.ones(4, bool), config,
            impl=impl, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (out["auto"] - out["torch"]).abs().max().item() < 1e-3
    assert all(k.launches > 0 for k in bc.KERNELS)
    assert all(len(v) == 4 for v in eng.run().values())
