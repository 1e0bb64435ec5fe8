"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file
imports no JAX (the card's machine has none); run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 outputs to 1e-3 (LayerNorm outputs of order 1; the kernel
sums the K products in another order and uses the hardware rsqrt); bf16
outputs to 0.0625 (two bf16 ulps below 8: a sum near a rounding boundary
may round the other way).

The KV-attention kernels (B5-B8) must leave the pools bit-exact with their
plain versions. Their inputs make the context of order 1 on every row:
scales of 0.5-1.5 units over the integer range give dequantized K/V with
|v| < 1.8, and q of std 5 a softmax peaked on a few positions; each live
row's largest |ctx| must be at least 8 times the tolerance, so an output of
zeros fails. The context is held to 1e-4 in fp32 (another summation order)
and to 1/32 in bf16 (kernel and plain version round each P * v_scale to
bf16, 2**-9 relative, at different softmax maxima, and ctx to bf16, ulp
2**-7 below 2: apart by at most 2**-8 * 1.8 + 2**-7 < 1/64, half the
tolerance), on the rows with something to attend; an inactive row need
only be finite.
"""

import pytest
import torch

from onebit_tpu_torch.kernels import bitlinear_cuda as bc
from onebit_tpu_torch.kernels import kv_attention as ka
from onebit_tpu_torch.kernels import kv_attention_cuda as kc

TOL = {torch.float32: 1e-3, torch.bfloat16: 0.0625}
KV_TOL = {torch.float32: 1e-4, torch.bfloat16: 1 / 32}

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
    (1024, 4096, 4096, 1, 4096), (256, 11008, 512, 2, 512),
    (8193, 800, 200, 1, 200), (300, 800, 384, 3, 448),
    (8193, 4096, 1024, 2, 1024), (8192, 11008, 512, 1, 512)])
def test_large_m_matches_plain(dev, dtype, m, k, n_true, ns, seg_pad):
    """The edges of K3's tiles: ragged M (129, 300, 8193), ragged N (200),
    K of an odd number of words (800: a last half k step), fused segments
    of 448 (the 64-column instance), and the eval's K = 11008 at M = 8192;
    each also raw (B4's z in x's dtype: fp32 z to 1e-5 sqrt(K) of its
    largest |z|, bf16 z to one bf16 ulp of each row's largest |z|)."""
    x, g, h, packed, bias = _case(dev, dtype, m, k, n_true, ns, seg_pad)
    info = bc.LARGE_M_F32 if dtype == torch.float32 else bc.LARGE_M
    before = info.launches
    got = bc.large_m(x, packed, g, h, n_true=n_true)
    assert info.launches == before + 1
    _close(got, bc.large_m_torch(x, packed, g, h, n_true=n_true), dtype)
    if ns == 1:
        _close(bc.large_m(x, packed, g, h, n_true=n_true, bias=bias),
               bc.large_m_torch(x, packed, g, h, n_true=n_true, bias=bias),
               dtype)
    before = bc.RAW_LARGE_M.launches
    raw = bc.large_m(x, packed, g, h, n_true=n_true, raw=True)
    want = bc.large_m_torch(x, packed, g, h, n_true=n_true, raw=True)
    torch.cuda.synchronize()
    assert bc.RAW_LARGE_M.launches == before + 1
    assert raw.dtype == dtype and raw.shape == want.shape == (m, ns * seg_pad)
    assert torch.isfinite(raw).all()
    top = want.float().abs().amax(-1, keepdim=True)
    tol = (torch.full_like(top, 1e-5 * top.max().item() * k ** 0.5)
           if dtype == torch.float32
           else torch.exp2(torch.floor(torch.log2(top)) - 7))
    assert ((raw.float() - want.float()).abs() <= tol).all()


@pytest.mark.parametrize("n,ns", [(4096, 1), (200, 1), (3 * 4096, 3),
                                  (2 * 11008, 2), (3 * 448, 3), (2 * 384, 2),
                                  (2048, 1), (5504, 1)])
def test_large_m_block_n_matches_the_kernel(dev, n, ns):
    """The column tile ``large_m_block_n`` states is the one the kernel's
    launch picks."""
    lib = bc._large_m_lib()
    assert lib.onebit_large_m_block_n(ns, n // ns) == \
        bc.large_m_block_n(n, ns)


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
    # fp32 throughout: K3's bf16 instance has nothing to do, and B4 (the
    # raw instances) runs only under tensor parallelism
    assert all(k.launches > 0 for k in (bc.SMALL_M, bc.FUSED_SMALL_M,
                                        bc.LARGE_M_F32))
    assert all(len(v) == 4 for v in eng.run().values())


# ---------------------------------------------------------------------------
# B4: the raw projection of a tensor-parallel shard (K1/K3 with raw=True)
# ---------------------------------------------------------------------------

def _tp_shards(d, inter, mp):
    """(K, N) of every shard of tensor-parallel llama over ``mp`` ranks:
    q/k/v and gate/up column-parallel, o and down row-parallel."""
    return [(d, d // mp), (d, inter // mp), (d // mp, d), (inter // mp, d)]


B4_SHAPES = sorted({kn for d, inter in ((4096, 11008), (5120, 13824))
                    for mp in (2, 4) for kn in _tp_shards(d, inter, mp)})
# fp32 z (M <= 128): the two sides sum the same bf16 y over K signed terms
# in another order, partial sums under 1024: 1e-2 (chip_smoke.py's
# RAW_TOL_F32); bf16 z (M > 128): one bf16 ulp of each row's largest |z|
B4_TOL_F32 = 1e-2


@pytest.mark.parametrize("m", [1, 8, 128, 129, 2048])
@pytest.mark.parametrize("k,n", B4_SHAPES)
def test_b4_matches_plain_at_tp_shards(dev, k, n, m):
    """Every shard shape of 7B and 13B at mp = 2 and 4 (most K end in a
    partial 1024-k chunk), decode and admission M; launches counted as
    B4's instances, never as K1 or K3."""
    x, g, h, packed, _ = _case(dev, torch.bfloat16, m, k, n)
    small = m <= bc.SMALL_M_MAX
    info = bc.RAW_SMALL_M if small else bc.RAW_LARGE_M
    before = [i.launches for i in bc.KERNELS]
    if small:
        got = bc.small_m(x, packed, g[0], h, raw=True)
        want = bc.small_m_torch(x, packed, g[0], h, raw=True)
    else:
        got = bc.large_m(x, packed, g, h, n_true=n, raw=True)
        want = bc.large_m_torch(x, packed, g, h, n_true=n, raw=True)
    torch.cuda.synchronize()
    assert [i.launches - b for i, b in zip(bc.KERNELS, before)] == \
        [int(i is info) for i in bc.KERNELS]
    assert got.dtype == (torch.float32 if small else torch.bfloat16)
    assert got.shape == want.shape == (m, n) and torch.isfinite(got).all()
    top = want.float().abs().amax(-1, keepdim=True)
    tol = (torch.full_like(top, B4_TOL_F32) if small
           else torch.exp2(torch.floor(torch.log2(top)) - 7))
    assert ((got.float() - want.float()).abs() <= tol).all()
    assert (top >= 8 * tol).all()


def _tp_engine_rank(group, seed):
    """A rank of a 2-rank tensor-parallel engine on the card (fp32, tiny):
    its greedy tokens and launch counts."""
    import numpy as np

    from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                                  host_random_packed_params)
    config = BitLlamaConfig.named("tiny", max_position_embeddings=512)
    params = host_random_packed_params(config, seed=seed,
                                       dtype=torch.float32,
                                       device=group.device)
    eng = ContinuousBatchingEngine(params, config, max_batch=4, max_len=256,
                                   compute_dtype=torch.float32,
                                   tp_group=group)
    rng = np.random.default_rng(0)
    infos = bc.KERNELS + kc.KERNELS
    for i in infos:
        i.launches = 0
    uids = [eng.add_request(rng.integers(3, 500, n).tolist(),
                            max_new_tokens=8) for n in (150, 140, 7, 3)]
    out = eng.run()
    torch.cuda.synchronize()
    return [out[u] for u in uids], {i.name: i.launches for i in infos}


def test_tp_engine_on_the_card_matches_single_device(dev):
    """Two gloo ranks sharing the card: both emit the single-device
    engine's greedy tokens, through B4 and B9 and never K1-K3."""
    import numpy as np

    from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                                  host_random_packed_params)
    from onebit_tpu_torch.parallel.mesh import spawn_tp
    config = BitLlamaConfig.named("tiny", max_position_embeddings=512)
    params = host_random_packed_params(config, seed=1, dtype=torch.float32,
                                       device=dev)
    eng = ContinuousBatchingEngine(params, config, max_batch=4, max_len=256,
                                   compute_dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    uids = [eng.add_request(rng.integers(3, 500, n).tolist(),
                            max_new_tokens=8) for n in (150, 140, 7, 3)]
    out = eng.run()
    want = [out[u] for u in uids]
    ranks = spawn_tp(_tp_engine_rank, 2, backend="gloo", device="cuda",
                     timeout=300, args=(1,))
    for tokens, launches in ranks:
        assert tokens == want
        assert launches[bc.RAW_SMALL_M.name] > 0
        assert launches[bc.RAW_LARGE_M.name] > 0
        # B9 once a layer (2) in each of the 7 decode steps
        assert launches[kc.DECODE_F32.name] == 2 * 7
        assert not any(launches[i.name] for i in (
            bc.SMALL_M, bc.FUSED_SMALL_M, bc.LARGE_M, bc.LARGE_M_F32))


# ---------------------------------------------------------------------------
# B5-B8: the quantized-KV attention kernels
# ---------------------------------------------------------------------------

def _kv_case(dev, dtype, shape, int4, seed=0):
    """q, this step's K/V and scales, and random pools of layout KT (int8)
    or KT4 (int4: random bytes, so every nibble pair occurs)."""
    n_layers, b, nkv, g, hd, t = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tb = t // 2 if int4 else t
    lo = -128 if int4 else -127
    levels = 7 if int4 else 127

    def ints(*s, lo=lo, hi=128):
        return torch.randint(lo, hi, s, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*s):
        return (torch.rand(s, generator=gen, device=dev) + 0.5) / levels

    q = (5 * torch.randn(b, nkv * g, hd, generator=gen, device=dev)).to(dtype)
    nlo, nhi = (-8, 8) if int4 else (-127, 128)
    new = [ints(b, nkv, hd, lo=nlo, hi=nhi), scales(b, nkv),
           ints(b, nkv, hd, lo=nlo, hi=nhi), scales(b, nkv)]
    pools = [ints(n_layers, b, nkv, hd, tb), scales(n_layers, b, nkv, t),
             ints(n_layers, b, tb, nkv, hd), scales(n_layers, b, t, nkv)]
    return q, new, pools


def _rows_of(t, b):
    """Ragged lengths with an inactive row (row 1), write positions at
    length - 1 (the inactive row's frozen at T/3), and starts: positions in
    several tiles and, for int4, on both sides of T/2. The last row of 8
    and of 16 is full."""
    pattern = [t, 0, t // 2 + 1, t // 2, 129, 1, t - 117, t]
    lengths = [pattern[i % 8] for i in range(b)]
    pos = [n - 1 if n else t // 3 for n in lengths]
    starts = [[0, 0, t // 2 - 3, 1, 100, 0, 5, 76][i % 8] for i in range(b)]
    return lengths, pos, starts


def _kv_check(dev, dtype, shape, int4, append, starts_on, layer):
    q, new, pools = _kv_case(dev, dtype, shape, int4)
    lengths, pos, starts = _rows_of(shape[5], shape[1])
    as_dev = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
    lengths, pos = as_dev(lengths), as_dev(pos)
    starts = as_dev(starts) if starts_on else None
    fns = ((ka.kv_attention_append_kt4, ka.kv_attention_decode_kt4) if int4
           else (ka.kv_attention_append_kt, ka.kv_attention_decode_kt))
    kern = fns[0] if append else fns[1]
    info = {ka.kv_attention_append_kt: kc.APPEND_KT,
            ka.kv_attention_decode_kt: kc.DECODE_KT,
            ka.kv_attention_append_kt4: kc.APPEND_KT4,
            ka.kv_attention_decode_kt4: kc.DECODE_KT4}[kern]
    args = (new if append else [])
    tail = (lengths, layer) + ((pos,) if append else ())
    want_pools = [p.clone() for p in pools]
    want = ka.PLAIN[kern](q, *args, *want_pools, *tail, starts=starts)
    before = info.launches
    got = kern(q, *args, *pools, *tail, starts=starts)
    torch.cuda.synchronize()
    assert info.launches == before + 1
    for name, a, b in zip(("k", "k_scale", "v", "v_scale"), pools,
                          want_pools):
        assert torch.equal(a, b), name
    del pools, want_pools
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    live = lengths > (starts if starts is not None else 0)
    err = (got[live].float() - want[live].float()).abs().max().item()
    assert err <= KV_TOL[dtype], err
    ctx_scale = want[live].float().abs().amax(dim=(1, 2)).min().item()
    assert ctx_scale >= 8 * KV_TOL[torch.bfloat16], ctx_scale


KV_SHAPES = {  # (L, B, nkv, g, hd, T)
    "small_gqa": (2, 3, 2, 2, 64, 384),
    "odd_t": (2, 3, 2, 4, 64, 390),
    "llama2_7b": (2, 8, 32, 1, 128, 2048),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(KV_SHAPES))
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("append", [True, False], ids=["append", "decode"])
def test_kv_attention_matches_plain(dev, dtype, shape, int4, append):
    _kv_check(dev, dtype, KV_SHAPES[shape], int4, append, starts_on=False,
              layer=1)


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("append", [True, False], ids=["append", "decode"])
def test_kv_attention_starts(dev, int4, append):
    _kv_check(dev, torch.bfloat16, KV_SHAPES["small_gqa"], int4, append,
              starts_on=True, layer=0)


def test_kv_attention_pools_past_2_31_elements(dev):
    """int8 pools of 32 x 16 x 32 x 128 x 2048 = 2**32 elements (4.3 GB
    each): the append at layer 31 lands where the plain version puts it,
    row 15 included, and nothing else changes."""
    _kv_check(dev, torch.bfloat16, (32, 16, 32, 1, 128, 2048), False, True,
              starts_on=False, layer=31)


def test_kv_wrappers_check_inputs(dev):
    q, new, pools = _kv_case(dev, torch.float32, KV_SHAPES["small_gqa"],
                             False)
    lengths = torch.full((3,), 10, dtype=torch.int32, device=dev)
    pos = torch.full((3,), 9, dtype=torch.int32, device=dev)
    k, ks, v, vs = pools

    def call(k=k, v=v, q=q, layer=0, lengths=lengths, pos=pos):
        return ka.kv_attention_append_kt(q, *new, k, ks, v, vs, lengths,
                                         layer, pos)

    with pytest.raises(TypeError, match="k_pool must be"):
        call(k=k.to(torch.int16))
    with pytest.raises(TypeError, match="q must be"):
        call(q=q.half())
    with pytest.raises(ValueError, match="contiguous"):
        call(v=v.transpose(3, 4))
    with pytest.raises(ValueError, match="does not match"):
        call(k=k[..., :200].contiguous())
    with pytest.raises(ValueError, match="layer"):
        call(layer=2)
    # positions and lengths reach the kernel as device int32, never copied
    # per call
    with pytest.raises(ValueError, match="lengths is on cpu"):
        call(lengths=lengths.cpu())
    with pytest.raises(TypeError, match="pos must be"):
        call(pos=pos.long())
    with pytest.raises(ValueError, match="head_dim"):
        qq = torch.zeros(3, 4, 96, device=dev)
        ka.kv_attention_decode_kt(
            qq, torch.zeros(1, 3, 2, 96, 8, dtype=torch.int8, device=dev),
            torch.zeros(1, 3, 2, 8, device=dev),
            torch.zeros(1, 3, 8, 2, 96, dtype=torch.int8, device=dev),
            torch.zeros(1, 3, 8, 2, device=dev), lengths, 0)
    with pytest.raises(ValueError, match="even T"):
        ka.kv_attention_decode_kt4(
            q, torch.zeros(2, 3, 2, 64, 4, dtype=torch.int8, device=dev),
            torch.zeros(2, 3, 2, 9, device=dev),
            torch.zeros(2, 3, 4, 2, 64, dtype=torch.int8, device=dev),
            torch.zeros(2, 3, 9, 2, device=dev), lengths, 0)


@pytest.mark.parametrize("quantized_kv", [True, "int4"],
                         ids=["int8", "int4"])
def test_quant_engine_kernel_path_matches_plain(dev, quantized_kv):
    """A small model served from quantized pools on the card: the first
    decode step's logits through the kernels agree with impl="torch" in
    fp32, the fused append+attend kernel runs once per layer, and the
    requests finish."""
    import numpy as np
    from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                                  fuse_for_decode, host_random_packed_params)
    from onebit_tpu_torch.model.ragged_decode import ragged_decode_step
    config = BitLlamaConfig.named("tiny", max_position_embeddings=512)
    params = fuse_for_decode(host_random_packed_params(
        config, seed=1, dtype=torch.float32, device=dev), config)
    eng = ContinuousBatchingEngine(params, config, max_batch=4, max_len=256,
                                   quantized_kv=quantized_kv,
                                   compute_dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    for n in (150, 140, 7, 3):
        eng.add_request(rng.integers(3, 500, n).tolist(), max_new_tokens=4)
    eng._admit()
    tokens = torch.from_numpy(eng.next_token[:, None].astype(np.int64)).to(dev)
    fused = kc.APPEND_KT4 if quantized_kv == "int4" else kc.APPEND_KT
    out = {}
    for impl in ("auto", "torch"):
        cache = type(eng.cache)(*(t.clone() for t in eng.cache))
        before = fused.launches
        out[impl], cache = ragged_decode_step(
            params, cache, tokens, eng.row_pos, np.ones(4, bool), config,
            impl=impl, compute_dtype=torch.float32)
        runs = fused.launches - before
        assert runs == (config.num_hidden_layers if impl == "auto" else 0)
    torch.cuda.synchronize()
    assert (out["auto"] - out["torch"]).abs().max().item() < 1e-3
    assert all(len(v) == 4 for v in eng.run().values())


# ---------------------------------------------------------------------------
# B9: decode attention over the flat pools
# ---------------------------------------------------------------------------
# q and float pools on a grid of 1/16 (q of std 5 within +-15.9, K/V
# uniform in +-1.5), int8 pools of integers with scales of 0.5-1.5 units
# over the range: every q . k dot is exact in fp32 in any order, so fp32
# results differ only in the softmax's and the PV sum's last bits, far
# under 1e-5. bf16: both sides round P (times the V scale) to bf16 at
# different softmax scales, at most 2**-8 * 1.5 apart, then the context to
# bf16 (ulp 2**-7 below 2): under 1/64, and the tolerance is 1/32. q of
# std 5 gives a peaked softmax and a context of order 1; each live row's
# largest |ctx| must be at least 8 times the bf16 tolerance.
FLAT_TOL = {torch.float32: 1e-5, torch.bfloat16: 1 / 32}


def _on_grid(x):
    return torch.round(x * 16) / 16


def _flat_case(dev, q_dtype, pool, shape, seed=0):
    """q, the pools (with scales for int8) and ragged rows of 8 kinds:
    full, empty, one position, starts inside the row and at its end."""
    n_layers, b, t, nkv, g, hd = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = _on_grid(5 * torch.randn(b, nkv * g, hd, generator=gen, device=dev)
                 ).clamp(-15.9375, 15.9375).to(q_dtype)
    pshape = (n_layers, b, t, nkv, hd)
    if pool == "int8":
        def ints():
            return torch.randint(-127, 128, pshape, generator=gen,
                                 device=dev, dtype=torch.int8)

        def scales():
            return (torch.rand(pshape[:-1], generator=gen, device=dev)
                    + 0.5) / 127
        pools = [ints(), scales(), ints(), scales()]
    else:
        dt = torch.bfloat16 if pool == "bf16" else torch.float32
        pools = [_on_grid(3 * torch.rand(pshape, generator=gen, device=dev)
                          - 1.5).to(dt) for _ in range(2)]
        pools = [pools[0], None, pools[1], None]
    pattern = [(t, 0), (0, 0), (t // 2 + 1, 0), (1, 0), (t, t // 3),
               (t - 3, min(100, t - 3)), (min(64, t), 0), (t, t)]
    rows = [pattern[i % 8] for i in range(b)]
    as_dev = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
    return q, pools, as_dev([r[0] for r in rows]), as_dev([r[1] for r in rows])


def _flat_check(dev, q_dtype, pool, shape, layer, starts_on=True):
    q, pools, lengths, starts = _flat_case(dev, q_dtype, pool, shape)
    starts = starts if starts_on else None
    info = kc.FLAT_KERNELS[torch.int8 if pool == "int8" else q.dtype]
    want = ka.kv_attention_decode_torch(q, *pools, lengths, layer,
                                        starts=starts)
    before = [x.clone() for x in pools if x is not None]
    launches = info.launches
    got = ka.kv_attention_decode(q, *pools, lengths, layer, starts=starts)
    torch.cuda.synchronize()
    assert info.launches == launches + 1
    assert all(torch.equal(a, b) for a, b in
               zip([x for x in pools if x is not None], before))
    del before, pools
    assert got.dtype == q_dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    live = lengths > (0 if starts is None else starts)
    assert (got[~live] == 0).all()          # nothing to attend: zeros
    err = (got[live].float() - want[live].float()).abs().max().item()
    assert err <= FLAT_TOL[q_dtype], err
    ctx_scale = want[live].float().abs().amax(dim=(1, 2)).min().item()
    assert ctx_scale >= 8 * FLAT_TOL[torch.bfloat16], ctx_scale


FLAT_KINDS = {"int8_f32": (torch.float32, "int8"),
              "int8_bf16": (torch.bfloat16, "int8"),
              "bf16": (torch.bfloat16, "bf16"),
              "f32": (torch.float32, "f32")}


@pytest.mark.parametrize("kind", sorted(FLAT_KINDS))
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("t", [1, 77, 300, 2048, 4096])
def test_kv_decode_matches_plain(dev, kind, g, hd, t):
    """B9 at layer 1 of 2, 8 rows of 8 kinds, with starts."""
    q_dtype, pool = FLAT_KINDS[kind]
    _flat_check(dev, q_dtype, pool, (2, 8, t, 2, g, hd), 1)


@pytest.mark.parametrize("kind", sorted(FLAT_KINDS))
def test_kv_decode_without_starts(dev, kind):
    q_dtype, pool = FLAT_KINDS[kind]
    _flat_check(dev, q_dtype, pool, (2, 8, 390, 2, 2, 128), 0,
                starts_on=False)


def test_kv_decode_pool_past_2_31_elements(dev):
    """bf16 pools of 32 x 9 x 2048 x 32 x 128 = 2,415,919,104 elements
    (4.8 GB each): layer 31's rows lie past 2**31 elements, and past 2**32
    bytes, and read what the plain version reads."""
    _flat_check(dev, torch.bfloat16, "bf16", (32, 9, 2048, 32, 1, 128), 31)


def test_kv_decode_wrapper_checks_inputs(dev):
    q, pools, lengths, starts = _flat_case(dev, torch.float32, "f32",
                                           (2, 3, 64, 2, 2, 64))
    k, _, v, _ = pools

    def call(q=q, k=k, v=v, ks=None, vs=None, lengths=lengths, layer=0):
        return ka.kv_attention_decode(q, k, ks, v, vs, lengths, layer,
                                      starts=starts)

    call()
    with pytest.raises(TypeError, match="k_pool must be"):
        call(k=k.to(torch.bfloat16), v=v.to(torch.bfloat16))
    with pytest.raises(ValueError, match="both scales"):
        call(ks=torch.ones(2, 3, 64, 2, device=dev))
    with pytest.raises(ValueError, match="lengths is on cpu"):
        call(lengths=lengths.cpu())
    with pytest.raises(TypeError, match="lengths must be"):
        call(lengths=lengths.long())
    with pytest.raises(ValueError, match="contiguous"):
        call(v=v.transpose(3, 4).contiguous().transpose(3, 4))
    with pytest.raises(ValueError, match="does not match"):
        call(k=k[:, :, :32].contiguous())
    with pytest.raises(ValueError, match="layer"):
        call(layer=2)
    with pytest.raises(NotImplementedError, match="item 5"):
        call(k=k.to(torch.float8_e4m3fn), v=v.to(torch.float8_e4m3fn))


@pytest.mark.parametrize("dtype", DTYPES)
def test_generate_kernel_path_matches_plain(dev, dtype):
    """A small model generating on the card: B9 launches once per layer
    of every decode step and the greedy tokens through the kernels equal
    impl="torch"'s in fp32 (in bf16 the two paths round at different
    places, and a near tie may go either way); the dense engine's decode
    launches B9 too."""
    import numpy as np
    from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                                  generate, host_random_packed_params)
    config = BitLlamaConfig.named("tiny", max_position_embeddings=512)
    params = host_random_packed_params(config, seed=1, dtype=dtype,
                                       device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 500, n).tolist() for n in (150, 7, 40)]
    info = kc.FLAT_KERNELS[dtype]
    out = {}
    for impl in ("auto", "torch"):
        before = info.launches
        out[impl] = generate(params, config, prompts, max_new_tokens=6,
                             impl=impl, compute_dtype=dtype, eos_id=-1)
        runs = info.launches - before
        assert runs == (5 * config.num_hidden_layers if impl == "auto"
                        else 0)
    if dtype == torch.float32:
        assert out["auto"] == out["torch"]
    assert all(len(row) == 6 for row in out["auto"])
    eng = ContinuousBatchingEngine(params, config, max_batch=4, max_len=256,
                                   compute_dtype=dtype, device=dev)
    for p in prompts:
        eng.add_request(p, max_new_tokens=4)
    before = info.launches
    assert all(len(v) == 4 for v in eng.run().values())
    assert info.launches - before == 3 * config.num_hidden_layers


# ---------------------------------------------------------------------------
# B10: paged decode attention
# ---------------------------------------------------------------------------
# Inputs with a context of order 1, as for B5-B8: float pages of N(0, 1);
# int8 pages with raw absmax scales of 64/127.5-191/127.5, so that the
# integer range dequantizes to about +-0.5-1.5; q of std 5. The output is
# float32 on both sides; in bf16 they round P = exp(s - m) to bf16 (2**-9
# relative) at different softmax maxima, apart by at most 2**-8 * max |v|
# < 1/32 (|v| < 8).

def _paged_case(dev, dtype, quant, shape, seed=0):
    """q, the pool leaves, lengths and page tables (each row a random
    permutation of pages 1..P-1) on the card. ``shape`` is (L, P, nkv, g,
    ps, hd, B, mp)."""
    n_layers, n_pages, nkv, g, ps, hd, b, mp = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pshape = (n_layers, n_pages, nkv, ps, hd)
    q = (5 * torch.randn(b, nkv * g, hd, generator=gen, device=dev)
         ).to(dtype)
    if quant:
        def ints():
            return torch.randint(-127, 128, pshape, generator=gen,
                                 device=dev, dtype=torch.int8)

        def scales():
            return torch.randint(64, 192, pshape[:-1] + (1,), generator=gen,
                                 device=dev).float() / 127.5
        pool = [ints(), scales(), ints(), scales()]
    else:
        pool = [torch.randn(pshape, generator=gen, device=dev).to(dtype)
                for _ in range(2)]
    tables = torch.stack([
        torch.randperm(n_pages - 1, generator=gen, device=dev)[:mp] + 1
        for _ in range(b)]).to(torch.int32)
    t = mp * ps
    pattern = [t, 0, 3 * ps + 1, 1, t - 3, ps, 2 * ps - 1, t // 2 + 5]
    lengths = torch.tensor([min(pattern[i % 8], t) for i in range(b)],
                           dtype=torch.int32, device=dev)
    return q, pool, lengths, tables


def _paged_check(dev, dtype, quant, shape, layer):
    from onebit_tpu_torch.kernels import paged_attention as pa
    from onebit_tpu_torch.kernels import paged_attention_cuda as pc
    q, pool, lengths, tables = _paged_case(dev, dtype, quant, shape)
    info = pc.PAGED_INT8 if quant else pc.PAGED
    before_pool = [x.clone() for x in pool]
    want = pa.paged_attention_flat_torch(q, *pool, lengths=lengths,
                                         page_indices=tables, layer=layer,
                                         quant=quant)
    before = info.launches
    got = pa.paged_attention_flat(q, *pool, lengths=lengths,
                                  page_indices=tables, layer=layer,
                                  quant=quant)
    torch.cuda.synchronize()
    assert info.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(pool, before_pool))
    del before_pool
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.isfinite(got).all()
    live = lengths > 0
    assert (got[~live] == 0).all()          # a length-0 row gets zeros
    err = (got[live] - want[live]).abs().max().item()
    assert err <= KV_TOL[dtype], err
    ctx_scale = want[live].abs().amax(dim=(1, 2)).min().item()
    assert ctx_scale >= 8 * KV_TOL[torch.bfloat16], ctx_scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("ps", [4, 16, 64])
def test_paged_attention_matches_plain(dev, dtype, quant, g, hd, ps):
    """Rows of 8 kinds (full table, length 0, one position, page edges),
    ragged page tables, layer 1 of 2."""
    mp = max(2, 512 // ps)
    _paged_check(dev, dtype, quant, (2, mp + 9, 2, g, ps, hd, 8, mp), 1)


def test_paged_attention_pool_past_2_31_elements(dev):
    """The llama2-7b pool of the engine's defaults, [32, 1025, 32, 16, 128]
    bf16 = 2,149,580,800 elements per leaf (4.3 GB): layer 31's last pages
    lie past 2**31 elements, and rows there read what the plain version
    reads."""
    _paged_check(dev, torch.bfloat16, False,
                 (32, 1025, 32, 1, 16, 128, 8, 128), 31)


def test_paged_wrapper_checks_inputs(dev):
    from onebit_tpu_torch.kernels import paged_attention as pa
    q, pool, lengths, tables = _paged_case(
        dev, torch.float32, False, (2, 9, 2, 2, 4, 64, 3, 2))

    def call(q=q, pool=pool, lengths=lengths, tables=tables, layer=0,
             quant=False):
        return pa.paged_attention_flat(q, *pool, lengths=lengths,
                                       page_indices=tables, layer=layer,
                                       quant=quant)

    call()
    with pytest.raises(TypeError, match="k_pages must be"):
        call(pool=[p.to(torch.bfloat16) for p in pool])
    with pytest.raises(ValueError, match="lengths is on cpu"):
        call(lengths=lengths.cpu())
    with pytest.raises(TypeError, match="lengths must be"):
        call(lengths=lengths.long())
    with pytest.raises(TypeError, match="page_indices must be"):
        call(tables=tables.long())
    with pytest.raises(ValueError, match="contiguous"):
        call(tables=tables.t().contiguous().t())
    with pytest.raises(ValueError, match="layer"):
        call(layer=2)
    with pytest.raises(ValueError, match="pool tensors"):
        call(quant=True)
    with pytest.raises(ValueError, match="head_dim"):
        call(q=torch.zeros(3, 4, 96, device=dev),
             pool=[torch.zeros(2, 9, 2, 4, 96, device=dev)] * 2)


@pytest.mark.parametrize("quantized_kv", [False, True],
                         ids=["float", "int8"])
def test_paged_engine_kernel_path_matches_plain(dev, quantized_kv):
    """A small model served from pages on the card: the first decode step's
    logits through B10 agree with the gather path (impl="torch") in fp32,
    B10 runs once per layer, and the requests finish with every page back
    in the pool. Int8 pages: B10 dequantizes before the dot, the gather
    path folds the scales in after it, 5e-3 apart at most (the JAX
    package's own bound, tests/test_paged_kernel.py)."""
    import numpy as np
    from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                                  fuse_for_decode, host_random_packed_params)
    from onebit_tpu_torch.engine.paged import paged_decode_step
    from onebit_tpu_torch.kernels import paged_attention_cuda as pc
    config = BitLlamaConfig.named("tiny", max_position_embeddings=512)
    params = fuse_for_decode(host_random_packed_params(
        config, seed=1, dtype=torch.float32, device=dev), config)
    eng = ContinuousBatchingEngine(params, config, max_batch=4, max_len=256,
                                   paged=True, quantized_kv=quantized_kv,
                                   compute_dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    for n in (150, 140, 7, 3):
        eng.add_request(rng.integers(3, 500, n).tolist(), max_new_tokens=4)
    eng._admit()
    tokens = torch.from_numpy(eng.next_token[:, None].astype(np.int64)).to(dev)
    info = pc.PAGED_INT8 if quantized_kv else pc.PAGED
    out = {}
    for impl in ("auto", "torch"):
        cache = type(eng.cache)(*(t.clone() for t in eng.cache))
        before = info.launches
        out[impl], cache = paged_decode_step(
            params, cache, tokens, eng.row_pos, eng.page_tables, config,
            impl=impl, compute_dtype=torch.float32)
        runs = info.launches - before
        assert runs == (config.num_hidden_layers if impl == "auto" else 0)
    torch.cuda.synchronize()
    tol = 5e-3 if quantized_kv else 1e-3
    assert (out["auto"] - out["torch"]).abs().max().item() < tol
    assert all(len(v) == 4 for v in eng.run().values())
    m = eng.metrics()
    assert m["free_pages"] == m["total_pages"]


# ---------------------------------------------------------------------------
# B11: causal flash attention
# ---------------------------------------------------------------------------
# q of std 5, k and v of N(0, 1): a peaked softmax and a context of order 1.
# fp32 to 1e-4 (the dots and the PV sum in another order, the softmax online).
# bf16: both sides round P to bf16 (2**-9 relative) at different scales
# (the kernel exp(s - m) at the running max, the plain version the normalized
# probabilities), at most 2**-8 * max|v| apart in fp32 (< 0.02 for |v| < 5),
# then each rounds the context to bf16, one ulp apart at most (2**-5 below
# 8): under 1/16. Each (row, head)'s largest |ctx| must be at least 8 times
# the tolerance.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 1 / 16}


def _flash_case(dev, dtype, b, s, nkv, g, hd, fused, seed=0):
    """q, k, v on the card. ``fused``: views of one ``[B*S, (nh + 2 nkv) *
    hd]`` projection output, as a fused q/k/v projection gives them (the
    sequence stride is the fused width); else three contiguous outputs."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nh = nkv * g
    widths = (nh * hd, nkv * hd, nkv * hd)
    scale = torch.tensor([5.0] * widths[0] + [1.0] * 2 * widths[1],
                         device=dev)
    x = torch.randn(b * s, sum(widths), generator=gen, device=dev) * scale
    x = x.to(dtype)
    parts = torch.split(x, widths, dim=1)
    if not fused:
        parts = [p.contiguous() for p in parts]
    return [p.view(b, s, n, hd) for p, n in zip(parts, (nh, nkv, nkv))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 17, 128, 300, 2048])
def test_flash_attention_matches_plain(dev, dtype, b, g, hd, s):
    """B = 3 reads strided views of a fused projection output, B = 1
    contiguous tensors."""
    from onebit_tpu_torch.kernels import attention as ta
    from onebit_tpu_torch.kernels import attention_cuda as fc
    q, k, v = _flash_case(dev, dtype, b, s, 2, g, hd, fused=b > 1)
    assert (b == 1) == q.is_contiguous()
    info = fc.FLASH_F32 if dtype == torch.float32 else fc.FLASH_BF16
    want = ta.flash_causal_attention_torch(q, k, v, num_kv_groups=g)
    before = info.launches
    got = ta.flash_causal_attention(q, k, v, num_kv_groups=g)
    torch.cuda.synchronize()
    assert info.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert got.is_contiguous() and torch.isfinite(got).all()
    tol = FLASH_TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err
    ctx_scale = want.float().abs().amax(dim=(1, 3)).min().item()
    assert ctx_scale >= 8 * tol, ctx_scale


def test_flash_wrapper_checks_inputs(dev):
    from onebit_tpu_torch.kernels import attention as ta
    q, k, v = _flash_case(dev, torch.float32, 2, 40, 2, 2, 64, fused=False)

    def call(q=q, k=k, v=v, g=2):
        return ta.flash_causal_attention(q, k, v, num_kv_groups=g)

    call()
    with pytest.raises(TypeError, match="k must be"):
        call(k=k.to(torch.bfloat16))
    with pytest.raises(TypeError, match="q must be"):
        call(q=q.half(), k=k.half(), v=v.half())
    with pytest.raises(ValueError, match="groups"):
        call(g=4)
    with pytest.raises(ValueError, match="contiguous"):
        call(v=v.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="do not match"):
        call(k=k[:, :39])
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros(2, 8, 4, 96, device=dev)
        call(q=x, k=x[:, :, :2], v=x[:, :, :2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_flash_path_matches_plain(dev, dtype):
    """``forward`` on the card at the tiny config (GQA, hd 64), S = 300:
    B11 launches once per layer with no mask and not at all with one; the
    logits agree with impl="torch" (fp32 to 1e-3 as the engine's, bf16 to
    5e-2 of the largest logit as chip_smoke's)."""
    import numpy as np
    from onebit_tpu_torch import BitLlamaConfig, host_random_packed_params
    from onebit_tpu_torch.kernels import attention_cuda as fc
    from onebit_tpu_torch.model.bitllama import forward
    config = BitLlamaConfig.named("tiny", max_position_embeddings=512)
    params = host_random_packed_params(config, seed=1, dtype=dtype,
                                       device=dev)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, config.vocab_size, (2, 300))).to(dev)
    info = fc.FLASH_F32 if dtype == torch.float32 else fc.FLASH_BF16
    out = {}
    for impl in ("auto", "torch"):
        before = info.launches
        out[impl] = forward(params, ids, config, impl=impl,
                            compute_dtype=dtype)
        assert info.launches - before == (config.num_hidden_layers
                                          if impl == "auto" else 0)
    before = info.launches
    masked = forward(params, ids, config, compute_dtype=dtype,
                     attention_mask=torch.ones_like(ids))
    assert info.launches == before
    torch.cuda.synchronize()
    err = (out["auto"] - out["torch"]).abs().max().item()
    if dtype == torch.float32:
        assert err < 1e-3, err
        assert (masked - out["torch"]).abs().max().item() < 1e-3
    else:
        assert err <= 5e-2 * out["torch"].abs().max().item(), err


# ---------------------------------------------------------------------------
# B11-dkv and B11-dq: the backward of causal flash attention
# ---------------------------------------------------------------------------
# Each gradient is held per (row, head) relative to that slice's largest
# |value| (at least 1), so a kernel leaving a head's gradient zero fails:
# fp32 to 1e-4 (sums in another order, P recomputed from the forward's
# log-sum-exp, a few 1e-6 relative), bf16 to 2**-6 (each side rounds its
# gradients to bf16, one ulp apart at most, after rounding operands at
# different places; chip_smoke.py FLASH_BWD_TOL gives the reasoning).
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}


def _flash_do(dev, dtype, b, s, nh, hd, readable, seed=1):
    """The output gradient: a strided view the kernels read in place
    (``readable``), or a transposed tensor's view, which the wrapper copies
    first."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if readable:
        x = torch.randn(b * s, nh * hd + 64, generator=gen, device=dev)
        return x.to(dtype)[:, :nh * hd].view(b, s, nh, hd)
    x = torch.randn(b, nh, s, hd, generator=gen, device=dev).to(dtype)
    return x.transpose(1, 2)


def _grads(fn, q, k, v, do, g):
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    fn(*xs, num_kv_groups=g).backward(do)
    return [x.grad for x in xs]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 17, 63, 64, 65, 128, 129, 300, 2048])
def test_flash_bwd_matches_plain(dev, dtype, b, g, hd, s):
    """dq, dk and dv through B11's autograd rule (B11, B11-dkv, B11-dq)
    against autograd through the plain version. B = 3 reads strided views
    of a fused projection output and a strided ``do`` in place; B = 1
    contiguous q, k, v and a transposed ``do``. S of 63-65 and 128-129 sit
    on the edges of the kernels' 64-row tiles."""
    from onebit_tpu_torch.kernels import attention as ta
    from onebit_tpu_torch.kernels import attention_cuda as fc
    q, k, v = _flash_case(dev, dtype, b, s, 2, g, hd, fused=b > 1)
    do = _flash_do(dev, dtype, b, s, 2 * g, hd, readable=b > 1)
    infos = [i for i in fc.KERNELS if i.name.endswith(
        "_f32" if dtype == torch.float32 else "_bf16")]
    before = [i.launches for i in infos]
    want = _grads(ta.flash_causal_attention_torch, q, k, v, do, g)
    got = _grads(ta.flash_causal_attention, q, k, v, do, g)
    torch.cuda.synchronize()
    assert [i.launches - n for i, n in zip(infos, before)] == [1, 1, 1]
    tol = FLASH_BWD_TOL[dtype]
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        assert torch.isfinite(a).all(), name
        top = w.float().abs().amax(dim=(1, 3)).clamp(min=1.0)
        err = (a.float() - w.float()).abs().amax(dim=(1, 3))
        assert (err <= tol * top).all(), (name, (err / top).max().item())


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_bwd_bf16_is_deterministic(dev, g, hd):
    """Two launches of each bf16 backward kernel on the same inputs give
    the same bits: each CTA owns its outputs and sums in a fixed order, with
    no atomics."""
    from onebit_tpu_torch.kernels import attention_cuda as fc
    q, k, v = _flash_case(dev, torch.bfloat16, 2, 300, 2, g, hd, fused=True)
    do = _flash_do(dev, torch.bfloat16, 2, 300, 2 * g, hd, readable=True)
    out, lse = fc.launch(q, k, v, g, with_lse=True)
    di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()

    def grads():
        return [*fc.launch_bwd_dkv(q, k, v, do, lse, di, g),
                fc.launch_bwd_dq(q, k, v, do, lse, di, g)]

    first, second = grads(), grads()
    torch.cuda.synchronize()
    for name, a, b in zip(("dk", "dv", "dq"), first, second):
        assert torch.isfinite(a).all() and a.abs().max() > 0, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 17, 100, 300, 2048])
def test_flash_lse_matches_logsumexp(dev, dtype, s):
    """The forward's optional log-sum-exp against ``torch.logsumexp`` of
    the plain scaled causal scores (fp32, of order 10: to 1e-4); the
    output is the same with and without it."""
    from onebit_tpu_torch.kernels import attention as ta
    from onebit_tpu_torch.kernels import attention_cuda as fc
    q, k, v = _flash_case(dev, dtype, 2, s, 2, 4, 128, fused=True)
    out, lse = fc.launch(q, k, v, 4, with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 8, s)
    assert torch.equal(out, fc.launch(q, k, v, 4))
    qg = q.float().reshape(2, s, 2, 4, 128)
    scores = torch.einsum("bsngh,btnh->bngst", qg, k.float()) * 128 ** -0.5
    scores = scores.masked_fill(~ta._causal_mask(s, s, 0, dev)[:, :, None],
                                float("-inf"))
    want = torch.logsumexp(scores, -1).reshape(2, 8, s)
    torch.cuda.synchronize()
    assert (lse - want).abs().max().item() <= 1e-4


def test_flash_bwd_checks_inputs(dev):
    from onebit_tpu_torch.kernels import attention_cuda as fc
    q, k, v = _flash_case(dev, torch.float32, 2, 40, 2, 2, 64, fused=False)
    do = torch.randn_like(q)
    lse = di = torch.zeros(2, 4, 40, device=dev)
    for launch in (fc.launch_bwd_dkv, fc.launch_bwd_dq):
        launch(q, k, v, do, lse, di, 2)
        with pytest.raises(TypeError, match="do must be"):
            launch(q, k, v, do.to(torch.bfloat16), lse, di, 2)
        with pytest.raises(ValueError, match="do .* does not match"):
            launch(q, k, v, do[:, :, :2], lse, di, 2)
        with pytest.raises(ValueError, match="lse must be"):
            launch(q, k, v, do, lse[:, :, :39], di, 2)
        with pytest.raises(ValueError, match="di must be"):
            launch(q, k, v, do, lse, di.double(), 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_kernel_path_matches_plain(dev, dtype, remat):
    """One KD train step of a latent student (tiny config: GQA, hd 64) at
    S = 300 on the card, its kernel path against impl="torch": the
    metrics and the updated trainable leaves (relative in norm) to 1e-4 in
    fp32 and 5e-2 in bf16 (activations rounded at different places, as
    chip_smoke.py's logits); B11 launches 2 (3 with remat) times a layer,
    B11-dkv and B11-dq once."""
    from onebit_tpu_torch import BitLlamaConfig
    from onebit_tpu_torch.kernels import attention_cuda as fc
    from onebit_tpu_torch.model.bitllama import init_params
    from onebit_tpu_torch.train import trainer as tt
    from onebit_tpu_torch.train.losses import KDConfig
    config = BitLlamaConfig.named("tiny", max_position_embeddings=512)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    teacher = init_params(config, gen, mode="linear", device=dev)
    student = init_params(config, gen, device=dev)
    ids = torch.randint(0, config.vocab_size, (2, 300), generator=gen,
                        device=dev)
    batch = {"input_ids": ids, "labels": ids}
    cfg = tt.TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=4,
                         remat=remat)
    kd = KDConfig(kd_beta=1.0, kd_loss_scale=0.01)
    suffix = "_f32" if dtype == torch.float32 else "_bf16"
    infos = [i for i in fc.KERNELS if i.name.endswith(suffix)]
    out = {}
    for impl in ("auto", "torch"):
        state = tt.init_train_state(tt.clone_params(student), cfg)
        step = tt.make_train_step(config, kd, cfg, compute_dtype=dtype,
                                  impl=impl)
        before = [i.launches for i in infos]
        state, metrics = step(state, teacher, batch)
        torch.cuda.synchronize()
        L = config.num_hidden_layers
        assert [i.launches - n for i, n in zip(infos, before)] == (
            [(3 if remat else 2) * L, L, L] if impl == "auto" else [0, 0, 0])
        out[impl] = (state, metrics)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    (sk, mk), (st, mt) = out["auto"], out["torch"]
    for key, val in mt.items():
        assert abs(mk[key].item() - val.item()) <= tol * abs(val.item()), key
    for a, w in zip(tt.trainable_leaves(sk.params),
                    tt.trainable_leaves(st.params)):
        assert torch.isfinite(a).all()
        assert (a - w).norm().item() <= tol * w.norm().item()
