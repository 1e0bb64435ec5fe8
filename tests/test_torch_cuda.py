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
                                   (37, 1024, 200), (128, 11008, 512),
                                   (9, 800, 200), (16, 5504, 4096),
                                   (17, 11008, 256), (1, 5504, 200),
                                   (128, 800, 4096)])
def test_small_m_matches_plain(dev, dtype, m, k, n):
    """The edges of the small-M kernel's tiles: M 1, 8, 9, 16, 17, 37 and
    128 (row blocks of 8), ragged N (200), K of an odd number of words
    (800 = 25) and splits that end short (5504, 11008); with bias and
    raw."""
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
    (5, 512, 300, 3, 320), (128, 256, 384, 2, 448),
    (9, 800, 300, 3, 320), (17, 5504, 400, 2, 448),
    (16, 11008, 4000, 3, 4096), (1, 4096, 11008, 2, 11008)])
def test_fused_small_m_matches_plain(dev, dtype, m, k, n_true, ns, seg_pad):
    """Segments of 320 and 448 (the 64-column tile), true widths short of
    the pad (h = 0 there), M 1-128."""
    x, g, h, packed, _ = _case(dev, dtype, m, k, n_true, ns, seg_pad)
    before = bc.FUSED_SMALL_M.launches
    got = bc.fused_small_m(x, packed, g, h, n_true=n_true)
    assert bc.FUSED_SMALL_M.launches == before + 1
    assert got.shape == (ns, m, n_true)
    _close(got, bc.fused_small_m_torch(x, packed, g, h, n_true=n_true), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n_true,ns,seg_pad", [
    (8, 4096, 4096, 1, 4096), (8, 11008, 4096, 1, 4096),
    (8, 4096, 4000, 3, 4096), (17, 800, 300, 3, 320)])
def test_small_m_is_deterministic(dev, dtype, m, k, n_true, ns, seg_pad):
    """Two launches on the same inputs give the same bits: the split
    partials and the LayerNorm's tile statistics meet in a fixed order."""
    x, g, h, packed, bias = _case(dev, dtype, m, k, n_true, ns, seg_pad)
    if ns == 1:
        for kw in (dict(bias=bias), dict(raw=True)):
            a = bc.small_m(x, packed, g[0], h, **kw)
            b = bc.small_m(x, packed, g[0], h, **kw)
            torch.cuda.synchronize()
            assert torch.equal(a, b)
    a = bc.fused_small_m(x, packed, g, h, n_true=n_true)
    b = bc.fused_small_m(x, packed, g, h, n_true=n_true)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


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


def _tp_engine_rank(group, seed, opts=None):
    """A rank of a 2-rank tensor-parallel engine on the card (fp32, tiny,
    engine options ``opts``): its greedy tokens and launch counts."""
    import numpy as np

    from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                                  host_random_packed_params)
    config = BitLlamaConfig.named("tiny", max_position_embeddings=512)
    params = host_random_packed_params(config, seed=seed,
                                       dtype=torch.float32,
                                       device=group.device)
    eng = ContinuousBatchingEngine(params, config, max_batch=4, max_len=256,
                                   compute_dtype=torch.float32,
                                   tp_group=group, **(opts or {}))
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


def _kt_call(int4, append, q, new, pools, lengths, layer, pos, starts, *,
             plain=False):
    """B5-B8 (or their plain versions) on one case."""
    fns = ((ka.kv_attention_append_kt4, ka.kv_attention_decode_kt4) if int4
           else (ka.kv_attention_append_kt, ka.kv_attention_decode_kt))
    if plain:
        fns = tuple(ka.PLAIN[fn] for fn in fns)
    if append:
        return fns[0](q, *new, *pools, lengths, layer, pos, starts=starts)
    return fns[1](q, *pools, lengths, layer, starts=starts)


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("append", [True, False], ids=["append", "decode"])
def test_kt_is_deterministic(dev, int4, append):
    """Two launches on the same inputs give the same bits (the chunks of a
    row merge in chunk order), and the pools the same bytes."""
    shape = (2, 8, 2, 4, 128, 2048)
    q, new, pools = _kv_case(dev, torch.bfloat16, shape, int4)
    lengths, pos, starts = _rows_of(shape[5], shape[1])
    as_dev = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
    lengths, pos, starts = as_dev(lengths), as_dev(pos), as_dev(starts)
    a = _kt_call(int4, append, q, new, pools, lengths, 1, pos, starts)
    first = [x.clone() for x in pools]
    b = _kt_call(int4, append, q, new, pools, lengths, 1, pos, starts)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(pools, first))


def _kt_edge_rows(int4):
    """(length, start, pos) at T = 4 chunks: a chunk's size and one either
    side; a start inside a chunk and on a chunk's first column; writes at a
    chunk's first and last column and at the edges of the warps' ring
    stages (tiles of 16 columns; columns 63/64: warp 3's first tile, warp
    0's second, in its second stage; 127/128: warp 3's second, warp 0's
    third, back in its first); an inactive row written in a chunk it does
    not attend. int4 adds rows at T/2 and one either side, a start past
    T/2, writes at the high plane's chunk edges, and a row whose two
    planes leave a gap of columns."""
    c = kc.KT4_CHUNK if int4 else kc.KT_CHUNK      # byte columns a chunk
    t = 4 * c * (2 if int4 else 1)
    h = t // 2
    rows = [(c - 1, 0, c - 2), (c, 0, c - 1), (c + 1, 0, c), (t, 0, t - 1),
            (2 * c + 17, c + 3, 2 * c + 16), (3 * c, c, 3 * c - 1),
            (0, 0, c + 15), (c + 40, 0, 64), (200, 0, 63), (300, 7, 128),
            (150, 0, 127), (c + 200, 5, c + 127)]
    if int4:
        rows += [(h - 1, 0, h - 2), (h, 0, h - 1), (h + 1, 0, h),
                 (h + c + 1, h + 5, h + c), (t - 3, h + 1, h + c - 1),
                 (0, 0, h + 2 * c), (t, 0, h + 3 * c - 1),
                 (h + 60, 200, h + 40), (h + 70, 0, h + 64)]
    return t, rows


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("starts_on", [True, False],
                         ids=["starts", "no_starts"])
@pytest.mark.parametrize("append", [True, False], ids=["append", "decode"])
def test_kt_chunk_edges(dev, int4, g, starts_on, append):
    """Lengths, starts and write positions at chunk and ring-stage edges
    against the plain version: pools bit-exact, ctx within KV_TOL (fp32),
    zeros on the rows with nothing to attend."""
    t, rows = _kt_edge_rows(int4)
    q, new, pools = _kv_case(dev, torch.float32, (1, len(rows), 1, g, 64, t),
                             int4, seed=g)
    as_dev = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
    lengths, pos = as_dev([r[0] for r in rows]), as_dev([r[2] for r in rows])
    starts = as_dev([r[1] for r in rows]) if starts_on else None
    want_pools = [x.clone() for x in pools]
    want = _kt_call(int4, append, q, new, want_pools, lengths, 0, pos, starts,
                    plain=True)
    got = _kt_call(int4, append, q, new, pools, lengths, 0, pos, starts)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(pools, want_pools))
    live = lengths > (starts if starts is not None else 0)
    assert (got[~live] == 0).all()
    err = (got[live] - want[live]).abs().max().item()
    assert err <= KV_TOL[torch.float32], err
    assert want[live].abs().amax(dim=(1, 2)).min() >= 8 * KV_TOL[
        torch.bfloat16]


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


def _bits(t):
    """``t`` to compare bit for bit: fp8 through a ``uint8`` view (few
    operators take fp8)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


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
        dt = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}.get(
            pool, torch.float32)
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
    info = kc.FLAT_KERNELS[pools[0].dtype]
    want = ka.kv_attention_decode_torch(q, *pools, lengths, layer,
                                        starts=starts)
    before = [x.clone() for x in pools if x is not None]
    launches = info.launches
    got = ka.kv_attention_decode(q, *pools, lengths, layer, starts=starts)
    torch.cuda.synchronize()
    assert info.launches == launches + 1
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in
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
              "f32": (torch.float32, "f32"),
              "fp8_bf16": (torch.bfloat16, "fp8"),
              "fp8_f32": (torch.float32, "fp8")}


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


def _shifted_case(dev, pool, q_dtype, shift, span, seed=3):
    """Row 0 attends [0, span); row 1 holds the same K/V at [shift, shift +
    span) and attends exactly those: a left-padded row and its unpadded
    twin."""
    t = 1024
    q, pools, _, _ = _flat_case(dev, q_dtype, pool, (1, 2, t, 2, 2, 64),
                                seed)
    q = q[:1].expand(2, -1, -1).contiguous()
    for x in pools:
        if x is not None:
            x[0, 1, shift:shift + span] = x[0, 0, :span]
    lengths = torch.tensor([span, shift + span], dtype=torch.int32,
                           device=dev)
    starts = torch.tensor([0, shift], dtype=torch.int32, device=dev)
    return q, pools, lengths, starts


@pytest.mark.parametrize("kind", sorted(FLAT_KINDS))
@pytest.mark.parametrize("shift,span", [(1, 1), (100, 255), (300, 256),
                                        (5, 257), (123, 700)])
def test_kv_decode_left_pad_gives_the_same_bits(dev, kind, shift, span):
    """A row that starts at ``shift`` gives bit for bit the output of the
    same K/V and q at start 0: chunks and tiles count from the start."""
    q_dtype, pool = FLAT_KINDS[kind]
    q, pools, lengths, starts = _shifted_case(dev, pool, q_dtype, shift,
                                              span)
    got = ka.kv_attention_decode(q, *pools, lengths, 0, starts=starts)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("kind", sorted(FLAT_KINDS))
def test_kv_decode_is_deterministic(dev, kind):
    """Two launches on the same inputs give the same bits: the chunks merge
    in chunk order."""
    q_dtype, pool = FLAT_KINDS[kind]
    q, pools, lengths, starts = _flat_case(dev, q_dtype, pool,
                                           (2, 8, 2048, 2, 4, 128))
    a = ka.kv_attention_decode(q, *pools, lengths, 1, starts=starts)
    b = ka.kv_attention_decode(q, *pools, lengths, 1, starts=starts)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", sorted(FLAT_KINDS))
@pytest.mark.parametrize("g", [1, 8])
def test_kv_decode_chunk_edges(dev, kind, g):
    """Rows of C - 1, C and C + 1 positions (C the chunk), of many chunks,
    and starts inside a chunk, against the plain version."""
    q_dtype, pool = FLAT_KINDS[kind]
    c = kc.DECODE_CHUNK
    q, pools, _, _ = _flat_case(dev, q_dtype, pool, (1, 8, 6 * c, 1, g, 64))
    rows = [(c - 1, 0), (c, 0), (c + 1, 0), (6 * c, 0), (6 * c - 7, 17),
            (2 * c + 101, 100), (c + 3, c + 2), (5 * c + 1, c - 1)]
    as_dev = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    lengths, starts = as_dev([r[0] for r in rows]), as_dev([r[1] for r in rows])
    want = ka.kv_attention_decode_torch(q, *pools, lengths, 0, starts=starts)
    got = ka.kv_attention_decode(q, *pools, lengths, 0, starts=starts)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= FLAT_TOL[q_dtype], err
    assert want.float().abs().amax(dim=(1, 2)).min() >= 8 * FLAT_TOL[
        torch.bfloat16]


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
    with pytest.raises(TypeError, match="v_pool must be"):
        call(k=k.to(torch.float8_e4m3fn))
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
# Inputs with a context of order 1, as for B5-B8: float (and fp8 e4m3) pages
# of N(0, 1); int8 pages with raw absmax scales of 64/127.5-191/127.5, so
# that the integer range dequantizes to about +-0.5-1.5; q of std 5. The
# helpers' ``quant``: False (pages of q's dtype), True (int8) or "fp8". The
# output is float32 on both sides; in bf16 they round P = exp(s - m) to bf16 (2**-9
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
    if quant is True:
        def ints():
            return torch.randint(-127, 128, pshape, generator=gen,
                                 device=dev, dtype=torch.int8)

        def scales():
            return torch.randint(64, 192, pshape[:-1] + (1,), generator=gen,
                                 device=dev).float() / 127.5
        pool = [ints(), scales(), ints(), scales()]
    else:
        pdt = torch.float8_e4m3fn if quant == "fp8" else dtype
        pool = [torch.randn(pshape, generator=gen, device=dev).to(pdt)
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
    info = {True: pc.PAGED_INT8, "fp8": pc.PAGED_FP8}.get(quant, pc.PAGED)
    quant = quant is True
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
    assert all(torch.equal(_bits(a), _bits(b))
               for a, b in zip(pool, before_pool))
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
@pytest.mark.parametrize("quant", [False, True, "fp8"],
                         ids=["float", "int8", "fp8"])
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


@pytest.mark.parametrize("quant", [False, True, "fp8"],
                         ids=["float", "int8", "fp8"])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("ps", [1, 16, 48])
def test_paged_chunk_edges(dev, quant, g, ps):
    """Rows of C - 1, C and C + 1 positions (C the chunk), of many chunks
    (many pages a chunk at ps 1 and 16), of one page, of one position, and
    of the whole table, against the plain version."""
    from onebit_tpu_torch.kernels import paged_attention as pa
    from onebit_tpu_torch.kernels import paged_attention_cuda as pc
    c = pc.PAGED_CHUNK
    mp = -(-6 * c // ps)
    q, pool, _, tables = _paged_case(dev, torch.bfloat16, quant,
                                     (1, 8 * mp + 1, 1, g, ps, 64, 8, mp))
    lengths = torch.tensor([c - 1, c, c + 1, 6 * c - 7, ps, 1, mp * ps,
                            2 * c + 101], dtype=torch.int32, device=dev)
    kw = dict(lengths=lengths, page_indices=tables, layer=0,
              quant=quant is True)
    want = pa.paged_attention_flat_torch(q, *pool, **kw)
    got = pa.paged_attention_flat(q, *pool, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= KV_TOL[torch.bfloat16], err
    assert want.abs().amax(dim=(1, 2)).min() >= 8 * KV_TOL[torch.bfloat16]


@pytest.mark.parametrize("quant", [False, True, "fp8"],
                         ids=["float", "int8", "fp8"])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_is_deterministic_and_follows_positions(dev, quant, ps):
    """Two launches on the same inputs give the same bits (the chunks merge
    in chunk order), and so do the same positions through a permuted page
    table and its pool against the identity table: chunks and tiles count
    positions, never page ids."""
    from onebit_tpu_torch.kernels import paged_attention as pa
    mp = 2048 // ps
    b = 4
    q, pool, lengths, _ = _paged_case(dev, torch.bfloat16, quant,
                                      (1, b * mp + 1, 2, 4, ps, 128, b, mp))
    ident = (torch.arange(b * mp, device=dev, dtype=torch.int32) + 1
             ).view(b, mp)
    perm = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      torch.randperm(b * mp, device=dev) + 1])
    moved = []
    for x in pool:
        y = torch.empty_like(x)
        yb, xb = ((y.view(torch.uint8), x.view(torch.uint8))
                  if quant == "fp8" else (y, x))
        yb[:, perm] = xb               # page p's contents now at perm[p]
        moved.append(y)
    kw = dict(lengths=lengths, layer=0, quant=quant is True)
    a = pa.paged_attention_flat(q, *pool, page_indices=ident, **kw)
    a2 = pa.paged_attention_flat(q, *pool, page_indices=ident, **kw)
    moved_tables = perm[ident.long()].to(torch.int32)
    c = pa.paged_attention_flat(q, *moved, page_indices=moved_tables, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all() and a.abs().max() > 0
    assert torch.equal(a, a2)
    assert torch.equal(a, c)


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


@pytest.mark.parametrize("quantized_kv", [False, True, "fp8"],
                         ids=["float", "int8", "fp8"])
def test_paged_engine_kernel_path_matches_plain(dev, quantized_kv):
    """A small model served from pages on the card: the first decode step's
    logits through B10 agree with the gather path (impl="torch") in fp32,
    B10 runs once per layer, and the requests finish with every page back
    in the pool. Int8 pages: B10 dequantizes before the dot, the gather
    path folds the scales in after it, 5e-3 apart at most (the JAX
    package's own bound, tests/test_paged_kernel.py). fp8 pages: both read
    the same exact values, 1e-3 as float pages."""
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
    info = {True: pc.PAGED_INT8, "fp8": pc.PAGED_FP8}.get(quantized_kv,
                                                           pc.PAGED)
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
    tol = 5e-3 if quantized_kv is True else 1e-3
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
@pytest.mark.parametrize("s", [1, 17, 63, 64, 65, 128, 129, 300, 2048])
def test_flash_attention_matches_plain(dev, dtype, b, g, hd, s):
    """B = 3 reads strided views of a fused projection output, B = 1
    contiguous tensors. S of 63-65 and 128-129 sit on the edges of the
    64-row tiles."""
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


def _flash_bwd_residuals(dev, dtype, b, s, g, hd):
    """q, k, v, a readable do, and the forward's lse and di = Σ o·do as
    B11's autograd rule forms them."""
    from onebit_tpu_torch.kernels import attention_cuda as fc
    q, k, v = _flash_case(dev, dtype, b, s, 2, g, hd, fused=True)
    do = _flash_do(dev, dtype, b, s, 2 * g, hd, readable=True)
    out, lse = fc.launch(q, k, v, g, with_lse=True)
    di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, di


def _flash_bwd_twice(dev, dtype, g, hd):
    from onebit_tpu_torch.kernels import attention_cuda as fc
    q, k, v, do, lse, di = _flash_bwd_residuals(dev, dtype, 2, 300, g, hd)

    def grads():
        return [*fc.launch_bwd_dkv(q, k, v, do, lse, di, g),
                fc.launch_bwd_dq(q, k, v, do, lse, di, g)]

    first, second = grads(), grads()
    torch.cuda.synchronize()
    for name, a, b in zip(("dk", "dv", "dq"), first, second):
        assert torch.isfinite(a).all() and a.abs().max() > 0, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_bwd_bf16_is_deterministic(dev, g, hd):
    """Two launches of each bf16 backward kernel on the same inputs give
    the same bits: each CTA owns its outputs and sums in a fixed order, with
    no atomics."""
    _flash_bwd_twice(dev, torch.bfloat16, g, hd)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_bwd_f32_is_deterministic(dev, g, hd):
    """The same for the fp32 instances: their two warpgroups meet through
    shared memory at fixed points, and every sum runs in a fixed order."""
    _flash_bwd_twice(dev, torch.float32, g, hd)


# The fp32 kernels against their arithmetic's mirror
# (``flash_causal_attention_bwd_split``) run on the card on the same
# residuals: both form every fp32 product from the same six products of
# bf16 parts, P and dS unrounded, each tile's product afresh; they differ
# in each sum's order and rounding (the mirror's fp32 matmuls round to
# nearest, the tensor cores' fp32 adds toward zero), a few 1e-6 of each
# gradient (the mirror is 1e-6 - 3.5e-6 from plain autograd on the CPU,
# tests/test_torch_flash_bwd_design.py). 5e-5 per (row, head), relative
# to the slice's largest |value| (at least 1), half of FLASH_BWD_TOL: the
# mirror with three products (no lo parts, no mid x mid) lands 1.5e-4 -
# 2e-4 off dk at S = 1, so a kernel that dropped them fails.
FLASH_BWD_MIRROR_TOL = 5e-5


def _row_head_err(got, want):
    top = want.abs().amax(dim=(1, 3)).clamp(min=1.0)
    return ((got - want).abs().amax(dim=(1, 3)) / top).max().item()


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 130, 300])
def test_flash_bwd_f32_matches_split_mirror(dev, g, hd, s):
    """dk, dv and dq of B11-dkv and B11-dq (fp32) against the mirror of
    their arithmetic on the same inputs (B = 3 strided views of a fused
    projection output), within FLASH_BWD_MIRROR_TOL; at S = 1 the
    three-product mirror must miss it."""
    from onebit_tpu_torch.kernels import attention as ta
    from onebit_tpu_torch.kernels import attention_cuda as fc
    q, k, v, do, lse, di = _flash_bwd_residuals(dev, torch.float32, 3, s, g,
                                                hd)
    dk, dv = fc.launch_bwd_dkv(q, k, v, do, lse, di, g)
    dq = fc.launch_bwd_dq(q, k, v, do, lse, di, g)
    want = ta.flash_causal_attention_bwd_split(q, k, v, do, lse, di,
                                               num_kv_groups=g)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert a.shape == w.shape and torch.isfinite(a).all(), name
        err = _row_head_err(a, w)
        assert err <= FLASH_BWD_MIRROR_TOL, (name, err)
    if s == 1:
        three = ta.flash_causal_attention_bwd_split(
            q, k, v, do, lse, di, num_kv_groups=g, small=((0, 1), (1, 0)))
        assert _row_head_err(dk, three[1]) > FLASH_BWD_MIRROR_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [1, 4])
def test_flash_attention_is_deterministic(dev, dtype, g):
    """Two launches of the forward on the same inputs give the same bits,
    the log-sum-exp too: each CTA owns its rows and sums in a fixed
    order."""
    from onebit_tpu_torch.kernels import attention_cuda as fc
    q, k, v = _flash_case(dev, dtype, 2, 300, 2, g, 128, fused=True)
    a, lse_a = fc.launch(q, k, v, g, with_lse=True)
    b, lse_b = fc.launch(q, k, v, g, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(lse_a, lse_b)


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


def _bf16_ulp(v):
    """One bf16 ulp at |v| (2**-133 below the least normal)."""
    v = v.abs().float().clamp(min=2.0 ** -126)
    return torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 8)


@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096)])
def test_kd_projection_on_tensor_cores_matches_fp32(dev, k, n, monkeypatch):
    """A Mistral KD projection's product at M = 2048 (gate/up 4096 ->
    14336, down 14336 -> 4096) on the tensor cores against today's fp32
    product of the upcasts: z to 1e-5 of the row's sum of |terms| (the
    same bf16 products, summed in another order); the bf16 gradients of y
    and of the signs within one bf16 ulp plus 1e-5 of the element's sum of
    |terms| (the split's 2**-17 a term, other sums; a tie may round either
    way), the latent gradient within the same after the STE."""
    from onebit_tpu_torch.core import bitlinear as cbl
    gen = torch.Generator(device=dev)
    gen.manual_seed(k)
    m = 2048
    y0 = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    lat0 = 0.01 * torch.randn(n, k, generator=gen, device=dev)
    dz = (torch.randn(m, n, generator=gen, device=dev)
          * torch.rand(m, 1, generator=gen, device=dev))

    def run(tensor_cores):
        monkeypatch.setattr(cbl, "_on_tensor_cores",
                            lambda a, b: tensor_cores)
        y, lat = y0.clone().requires_grad_(), lat0.clone().requires_grad_()
        s = cbl.sign_ste(lat).to(torch.bfloat16)
        s.retain_grad()
        before = cbl.tensor_core_products, cbl.fp32_products
        z = cbl.project_f32(y, s)
        assert (cbl.tensor_core_products - before[0],
                cbl.fp32_products - before[1]) == (
            (1, 0) if tensor_cores else (0, 1))
        z.backward(dz)
        torch.cuda.synchronize()
        monkeypatch.undo()
        return z, y.grad, s.grad, lat.grad

    z1, dy1, ds1, dl1 = run(True)
    z0, dy0, ds0, dl0 = run(False)
    s0 = torch.sign(lat0)
    assert z1.dtype == torch.float32 and dy1.dtype == ds1.dtype == y0.dtype
    row = y0.float().abs().sum(-1, keepdim=True)
    assert ((z1 - z0).abs() <= 1e-5 * row).all()

    def within(got, want, terms):
        assert torch.isfinite(got).all()
        bound = _bf16_ulp(torch.maximum(got.float().abs(),
                                        want.float().abs())) + 1e-5 * terms
        assert ((got.float() - want.float()).abs() <= bound).all()
        return bound

    within(dy1, dy0, dz.abs() @ s0.abs())
    bound = within(ds1, ds0, dz.abs().T @ y0.float().abs())
    ste = cbl.STE_SLOPE_OFFSET - torch.tanh(lat0) ** 2
    assert ((dl1 - dl0).abs() <= bound * ste + 2.0 ** -22 * dl0.abs()).all()


def test_bf16_kd_step_takes_only_tensor_core_products(dev):
    """One bf16 KD step of a 1-layer tiny config on the card: the
    teacher's and the student's seven projections each take the tensor
    cores, none the fp32 product."""
    from onebit_tpu_torch import BitLlamaConfig
    from onebit_tpu_torch.core import bitlinear as cbl
    from onebit_tpu_torch.model.bitllama import init_params
    from onebit_tpu_torch.train import trainer as tt
    from onebit_tpu_torch.train.losses import KDConfig
    config = BitLlamaConfig.named("tiny", num_hidden_layers=1,
                                  max_position_embeddings=512)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    teacher = init_params(config, gen, mode="linear", device=dev)
    student = init_params(config, gen, device=dev)
    ids = torch.randint(0, config.vocab_size, (2, 300), generator=gen,
                        device=dev)
    cfg = tt.TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=4)
    state = tt.init_train_state(student, cfg)
    step = tt.make_train_step(config, KDConfig(kd_beta=1.0), cfg,
                              compute_dtype=torch.bfloat16)
    before = cbl.tensor_core_products, cbl.fp32_products
    state, metrics = step(state, teacher, {"input_ids": ids, "labels": ids})
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"]).all()
    assert (cbl.tensor_core_products - before[0],
            cbl.fp32_products - before[1]) == (14, 0)


# ---------------------------------------------------------------------------
# Decode blocks as CUDA graphs (engine/block_graph.py)
# ---------------------------------------------------------------------------
# The kernels are deterministic (the same bits twice), so a graph replay of
# a block must equal the same block run eagerly bit for bit: tokens, valid
# mask, finals and every byte of the cache.
BLOCK_CACHES = {"dense": {}, "int8_kt": dict(quantized_kv=True),
                "int4_kt": dict(quantized_kv="int4"),
                "paged": dict(paged=True, page_size=16),
                "paged_int8": dict(paged=True, page_size=16,
                                   quantized_kv=True),
                "paged_fp8": dict(paged=True, page_size=16,
                                  quantized_kv="fp8")}


def _block_engine(dev, kind, dtype, block_steps=4, **kw):
    """A tiny model's engine with 4 prompts admitted (rows of 150, 140, 7
    and 3 tokens)."""
    import numpy as np
    from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                                  fuse_for_decode, host_random_packed_params)
    config = BitLlamaConfig.named("tiny", max_position_embeddings=512)
    params = fuse_for_decode(host_random_packed_params(
        config, seed=1, dtype=dtype, device=dev), config)
    eng = ContinuousBatchingEngine(params, config, max_batch=4, max_len=256,
                                   compute_dtype=dtype, device=dev,
                                   block_steps=block_steps,
                                   **BLOCK_CACHES[kind], **kw)
    rng = np.random.default_rng(0)
    for n in (150, 140, 7, 3):
        eng.add_request(rng.integers(3, 500, n).tolist(), max_new_tokens=9)
    eng._admit()
    return eng


def _block_on(eng, cache):
    """The engine's block function over ``cache``."""
    from onebit_tpu_torch.engine.paged import paged_decode_block
    from onebit_tpu_torch.model.ragged_decode import ragged_decode_block
    kw = dict(sampling=eng.sampling, n_steps=eng.block_steps, impl=eng.impl,
              compute_dtype=eng.compute_dtype)

    def block(tok, pos, act, budget, tables):
        if eng.paged:
            out = paged_decode_block(eng.params, cache, tok, pos, tables, act,
                                     budget, eng.generator, eng.config, **kw)
        else:
            out = ragged_decode_block(eng.params, cache, tok, pos, act,
                                      budget, eng.generator, eng.config, **kw)
        return out[0], out[1], out[3]
    return block


def _step_kernel(kind, dtype):
    from onebit_tpu_torch.kernels import paged_attention_cuda as pc
    return {"dense": kc.FLAT_KERNELS[dtype], "int8_kt": kc.APPEND_KT,
            "int4_kt": kc.APPEND_KT4, "paged": pc.PAGED,
            "paged_int8": pc.PAGED_INT8, "paged_fp8": pc.PAGED_FP8}[kind]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", list(BLOCK_CACHES))
def test_block_graph_replays_equal_eager(dev, kind, dtype):
    """Three replays of a captured block, each equal bit for bit to the
    block run eagerly on a copy of the cache: from the host's state (row 2
    inactive, row 1's budget ending inside the block), chained from the
    first replay's finals, and from new host tokens. Block N's tokens
    survive replay N+1; the ticket counters are all zero after; each
    kernel's launches are what the capture recorded times the replays."""
    import numpy as np
    from onebit_tpu_torch.engine.block_graph import KERNELS, BlockGraph
    eng = _block_engine(dev, kind, dtype)
    clone = lambda c: type(c)(*(t.clone() for t in c))  # noqa: E731
    graph_cache = clone(eng.cache)
    graph = BlockGraph(_block_on(eng, graph_cache), graph_cache, 4,
                       stream=torch.cuda.current_stream(),
                       tables_shape=(eng.page_tables.shape if eng.paged
                                     else None))
    graph.capture(eng.row_pos)
    # the eager side starts from the cache as the capture's eager block
    # left it (its writes sit where the next step writes first)
    eager_cache = clone(graph_cache)
    eager = _block_on(eng, eager_cache)
    tables = eng.page_tables if eng.paged else None
    active = np.asarray([True, True, False, True])
    budget = np.asarray([9, 2, 0, 9])
    host = [(eng.next_token, eng.row_pos, active, budget, tables),
            None, ((eng.next_token + 11) % 500, eng.row_pos + 1, active,
                   budget, tables)]
    as_dev = lambda x, dt=torch.long: torch.as_tensor(  # noqa: E731
        np.asarray(x), dtype=dt, device=dev)
    for k in KERNELS:
        k.launches = k.graph_launches = 0
    outs, wants, fetched = [], [], []
    for h in host:
        if h is None:          # chained: the last block's device finals
            tok, pos, done, bud = wants[-1][2]
            inputs = (tok, pos, ~done, bud)
            outs.append(graph.dispatch(chain=outs[-1].finals))
        else:
            inputs = (as_dev(h[0]), as_dev(h[1]), as_dev(h[2], torch.bool),
                      as_dev(h[3]))
            outs.append(graph.dispatch(host=h))
        if len(outs) > 1:      # block N, fetched after replay N+1
            fetched.append(outs[-2].fetch())
        tab = None if tables is None else as_dev(tables, torch.int32)
        wants.append(eager(*inputs, tab))
    fetched.append(outs[-1].fetch())
    with pytest.raises(RuntimeError, match="reused"):
        outs[0].fetch()        # two replays on, its buffers are block 3's
    torch.cuda.synchronize()
    for (got_toks, got_valid), (toks, valid, _) in zip(fetched, wants):
        assert np.array_equal(got_toks, toks.cpu().numpy())
        assert np.array_equal(got_valid, valid.cpu().numpy())
    # the last replay's finals (the graph's outputs) and both caches
    for got, want in zip(outs[-1].finals, wants[-1][2]):
        assert torch.equal(got, want)
    for got, want in zip(graph_cache, eager_cache):
        assert torch.equal(_bits(got), _bits(want))
    assert wants[0][1].sum(0).tolist()[1:3] == [2, 0]
    assert all(not buf.any() for buf in bc._COUNTERS.values())
    step = _step_kernel(kind, dtype)
    per_replay = graph.per_replay[step.name]
    assert per_replay == 4 * eng.config.num_hidden_layers
    assert graph.per_replay[bc.FUSED_SMALL_M.name] > 0
    for k in KERNELS:
        assert k.graph_launches == 3 * graph.per_replay.get(k.name, 0)
    # the eager blocks launched too, outside the graph
    assert step.launches == 3 * per_replay + 3 * 4 * 2


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["blocks", "pipelined"])
@pytest.mark.parametrize("kind", list(BLOCK_CACHES))
def test_block_engine_on_the_card_matches_eager(dev, kind, pipelined):
    """The engine with graph-replayed blocks serves the tokens of the
    engine that runs one eager step a call, pages all returned. Pipelined,
    ``warmup`` captures the graph; unpipelined, the first block captures it
    with the rows live, driven from a stream that is not the engine's (the
    engine runs on its own)."""
    eng = _block_engine(dev, kind, torch.bfloat16,
                        pipeline_blocks=pipelined)
    ref = _block_engine(dev, kind, torch.bfloat16, block_steps=1)
    if pipelined:
        eng.warmup()
        got = eng.run()
    else:
        with torch.cuda.stream(torch.cuda.Stream()):
            got = eng.run()
    want = ref.run()
    assert got == want and all(len(v) == 9 for v in got.values())
    assert eng._graph.replays > 0 and eng._pending is None
    if eng.paged:
        m = eng.metrics()
        assert m["free_pages"] == m["total_pages"]


def test_block_capture_keeps_the_collector_off(dev):
    """An engine and its graph hold each other, so a dropped engine's graph
    waits for Python's cyclic collector, and a collection inside another
    engine's capture would free it there, which invalidates that capture
    (cudaErrorStreamCaptureInvalidated: it failed so once in
    test_block_engine_on_the_card_matches_eager). The eager block before
    capture runs with the collector on, the capture with it off, and it is
    on again after; the tokens are the eager engine's."""
    import gc
    eng = _block_engine(dev, "dense", torch.bfloat16)
    real, seen = eng._graph.block, []

    def block(*args):
        seen.append((torch.cuda.is_current_stream_capturing(),
                     gc.isenabled()))
        return real(*args)
    eng._graph.block = block
    want = _block_engine(dev, "dense", torch.bfloat16, block_steps=1).run()
    assert eng.run() == want
    assert seen == [(False, True), (True, False)] and gc.isenabled()


def test_sampled_block_graph_runs(dev):
    """A sampled block registers the engine's generator with its graph:
    two replays from the same state draw other tokens, in the vocabulary,
    and the engine then serves its requests."""
    import numpy as np
    from onebit_tpu_torch import SamplingConfig
    eng = _block_engine(dev, "dense", torch.bfloat16,
                        sampling=SamplingConfig(temperature=1.5, top_k=50))
    state = (eng.next_token, eng.row_pos, np.ones(4, bool), np.full(4, 9),
             None)
    a, b = (eng._graph.dispatch(host=state).fetch()[0] for _ in range(2))
    assert not np.array_equal(a, b)
    assert ((0 <= a) & (a < 512)).all() and ((0 <= b) & (b < 512)).all()
    assert all(len(v) == 9 for v in eng.run().values())


# ---------------------------------------------------------------------------
# The task harness and SFT on the card
# ---------------------------------------------------------------------------

def _byte_tokenize(text):
    return [b + 3 for b in text.encode("utf-8")]


def _card_tasks(n=4, seed=0):
    """n synthetic docs of PIQA, ARC-Easy, BoolQ, HellaSwag, Winogrande,
    LAMBADA and one MMLU subject, in their published schemas."""
    import random

    from onebit_tpu_torch.eval.tasks import mmlu, suite
    rnd = random.Random(seed)
    words = "the cat dog river stone blue jumps over lazy tree wind".split()

    def text(lo, hi):
        return " ".join(rnd.choice(words)
                        for _ in range(rnd.randint(lo, hi)))
    r = range(n)
    return [
        suite.PIQA([{"goal": text(4, 8), "sol1": text(3, 6),
                     "sol2": text(3, 6), "label": i % 2} for i in r]),
        suite.ARCEasy([{"question": text(4, 8), "answerKey": "2",
                        "choices": {"text": [text(1, 3) for _ in "123"],
                                    "label": list("123")}} for _ in r]),
        suite.BoolQ([{"passage": text(10, 20), "question": text(3, 5),
                      "label": i % 2} for i in r]),
        suite.HellaSwag([{"activity_label": "Cooking", "ctx_a": text(4, 8),
                          "ctx_b": text(1, 3), "label": "1",
                          "endings": [f"{text(2, 5)} {j}" for j in range(4)]}
                         for _ in r]),
        suite.Winogrande([{"sentence": f"{text(3, 5)} _ {text(3, 5)}.",
                           "option1": text(1, 2), "option2": text(1, 2),
                           "answer": "2"} for _ in r]),
        suite.Lambada([{"text": text(10, 16)} for _ in r]),
        mmlu.MMLUSubject([{"question": text(4, 8), "answer": i % 4,
                           "choices": [text(1, 2) for _ in range(4)]}
                          for i in r], "philosophy")]


def test_evaluate_tasks_kernel_path_matches_plain(dev, monkeypatch):
    """``evaluate_tasks`` at 7B width, 2 layers, fp32, zero- and one-shot:
    every request's log-likelihood within 1e-4 x (1 + |ll|) of
    impl="torch" (chip_smoke.py's EVAL_LL_TOL), the greedy flags and every
    metric equal; K3 fp32 launches, B11 never."""
    from onebit_tpu_torch import BitLlamaConfig, host_random_packed_params
    from onebit_tpu_torch.eval.tasks import base
    from onebit_tpu_torch.kernels import attention_cuda as fc
    config = BitLlamaConfig.named("llama2-7b", num_hidden_layers=2)
    params = host_random_packed_params(config, seed=0, device=dev)
    real = base._run_requests
    for shots in (0, 1):
        runs = {}
        for impl in ("auto", "torch"):
            seen = []

            def run(*args, **kw):
                out = real(*args, **kw)
                seen.extend(out)
                return out
            monkeypatch.setattr(base, "_run_requests", run)
            before = {i.name: i.launches for i in (bc.LARGE_M_F32,
                                                   *fc.KERNELS)}
            res = base.evaluate_tasks(params, config, _card_tasks(),
                                      _byte_tokenize, impl=impl,
                                      num_fewshot=shots)
            torch.cuda.synchronize()
            launched = {i.name: i.launches - before[i.name]
                        for i in (bc.LARGE_M_F32, *fc.KERNELS)}
            runs[impl] = (res, seen, launched)
        (res, got, launched), (want_res, want, plain) = (runs["auto"],
                                                         runs["torch"])
        # a doc's requests in the seven tasks: 2+3+2+4+2+1+4
        assert len(got) == len(want) == 4 * 18
        for (ll, greedy), (ll_w, greedy_w) in zip(got, want):
            assert abs(ll - ll_w) <= 1e-4 * (1 + abs(ll_w))
            assert greedy == greedy_w
        assert res.keys() == want_res.keys()
        for task, metrics in want_res.items():
            for key, val in metrics.items():
                if "ppl" in key:
                    assert abs(res[task][key] / val - 1) <= 1e-3, key
                else:
                    assert res[task][key] == val, (task, key)
        assert launched[bc.LARGE_M_F32.name] > 0
        assert not any(launched[i.name] for i in fc.KERNELS)
        assert not any(plain.values())


def test_run_sft_step_on_the_card(dev, tmp_path):
    """One SFT step of a latent student at 7B width, 2 layers, bf16: a
    finite loss, and its loss and grad norm within 1e-3 of impl="torch"
    (padded batches: both take the plain masked attention)."""
    import json

    from onebit_tpu_torch import BitLlamaConfig, run_sft
    from onebit_tpu_torch.model.bitllama import init_params
    from onebit_tpu_torch.train.run_kd import KDRunConfig
    from onebit_tpu_torch.train.trainer import TrainConfig
    config = BitLlamaConfig.named("llama2-7b", num_hidden_layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    student = init_params(config, gen, device=dev)
    pairs = [("say " * n, "yes " * (n + 3)) for n in range(1, 9)]
    logs = {}
    for impl in ("auto", "torch"):
        out = tmp_path / impl
        state = run_sft(config, student, pairs, _byte_tokenize,
                        cutoff_len=64, train_cfg=TrainConfig(warmup_steps=0),
                        run_cfg=KDRunConfig(output_dir=str(out),
                                            batch_size=4, max_steps=1,
                                            plot=False), impl=impl)
        assert state.step == 1
        logs[impl] = [json.loads(line) for line in
                      (out / "trainer_log.jsonl").read_text().splitlines()]
    got, want = logs["auto"][0], logs["torch"][0]
    assert torch.isfinite(torch.tensor(got["loss"]))
    for key in ("loss", "grad_norm"):
        assert abs(got[key] - want[key]) <= 1e-3 * abs(want[key]), key


# ---------------------------------------------------------------------------
# The serving surface: chunked prefill, verify windows, speculative
# decoding, beam search
# ---------------------------------------------------------------------------

def _surface_model(dev):
    from onebit_tpu_torch import (BitLlamaConfig, fuse_for_decode,
                                  host_random_packed_params)
    config = BitLlamaConfig.named("tiny", num_key_value_heads=4,
                                  max_position_embeddings=512)
    return config, fuse_for_decode(host_random_packed_params(
        config, seed=1, dtype=torch.float32, device=dev), config)


@pytest.mark.parametrize("kind", ["dense", "int8", "paged"])
def test_windows_on_the_card_match_plain(dev, kind):
    """A 64-token chunk (K1/K2) and a 200-token one (K3) through
    chunk_append_row, then a 5-token verify window of 4 rows (K1/K2), one
    of them past max_len: logits of the kernel path within 1e-3 of
    impl="torch" in fp32, each on its own copy of the cache."""
    import numpy as np

    from onebit_tpu_torch import init_paged_kv_cache
    from onebit_tpu_torch.engine.paged import paged_verify_window
    from onebit_tpu_torch.model.bitllama import init_kv_cache
    from onebit_tpu_torch.model.kv_cache import init_quant_kv_cache_kt
    from onebit_tpu_torch.model.ragged_decode import (chunk_append_row,
                                                      ragged_verify_window)
    config, params = _surface_model(dev)
    rng = np.random.default_rng(2)
    kw = dict(compute_dtype=torch.float32)
    tokens = torch.from_numpy(rng.integers(3, 500, (4, 5))).to(dev)
    row_pos = np.array([300, 254, 10, 0])
    active = np.array([True, True, True, False])
    if kind == "paged":
        cache = init_paged_kv_cache(config, 65, 16, dtype=torch.float32,
                                    device=dev)
        tables = np.arange(1, 65, dtype=np.int32).reshape(4, 16)
        lengths = np.array([200, 254, 10, 0])

        def window(c, impl):
            return paged_verify_window(params, c, tokens, lengths, tables,
                                       config, impl=impl, **kw)[0]
        calls = [window]
    else:
        init = init_quant_kv_cache_kt if kind == "int8" else init_kv_cache
        cache = init(config, 4, 256, device=dev) if kind == "int8" else \
            init(config, 4, 256, dtype=torch.float32, device=dev)
        cache = type(cache)(*(torch.randn_like(x.float()).to(x.dtype)
                              if x.dtype != torch.int8 else x for x in cache))
        row_pos = np.minimum(row_pos, 254)

        def chunk(n):
            ids = rng.integers(3, 500, 256)

            def run(c, impl):
                return chunk_append_row(params, c, ids[:n], 0, n, 1, config,
                                        impl=impl, **kw)[0]
            return run

        def window(c, impl):
            return ragged_verify_window(params, c, tokens, row_pos, active,
                                        config, impl=impl, **kw)[0]
        calls = [chunk(64), chunk(200), window]
    for call in calls:
        before = [i.launches for i in bc.KERNELS]
        out = {impl: call(type(cache)(*(x.clone() for x in cache)), impl)
               for impl in ("auto", "torch")}
        torch.cuda.synchronize()
        assert torch.isfinite(out["auto"]).all()
        assert (out["auto"] - out["torch"]).abs().max().item() < 1e-3
        assert sum(i.launches - b for i, b in zip(bc.KERNELS, before)) > 0


@pytest.mark.parametrize("opts", [{}, dict(quantized_kv=True),
                                  dict(paged=True, page_size=16),
                                  dict(prefill_chunk_size=64),
                                  dict(paged=True, page_size=16,
                                       quantized_kv="fp8")],
                         ids=["dense", "int8", "paged", "dense_chunked",
                              "paged_fp8"])
def test_spec_engine_on_the_card_matches_plain(dev, opts):
    """A greedy engine with a 2-layer draft (the target itself, so every
    proposal is accepted) gives the plain engine's tokens on the card in
    fp32, one request filling max_len exactly; each round launches K1 and
    K2 2 x 5 x 2 + 2 x 2 times and B9 (fp32) 5 x 2 times."""
    import numpy as np

    from onebit_tpu_torch import ContinuousBatchingEngine
    config, params = _surface_model(dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 500, n).tolist() for n in (200, 7, 31, 3)]
    news = [56, 9, 12, 20]
    kw = dict(max_batch=4, max_len=256, compute_dtype=torch.float32,
              device=dev, **opts)

    def run(eng):
        uids = [eng.add_request(p, max_new_tokens=n)
                for p, n in zip(prompts, news)]
        eng._admit()
        torch.cuda.synchronize()
        before = {i.name: i.launches for i in bc.KERNELS + kc.KERNELS}
        out = eng.run()
        torch.cuda.synchronize()
        return [out[u] for u in uids], {
            i.name: i.launches - before[i.name] for i in bc.KERNELS
            + kc.KERNELS}
    want, _ = run(ContinuousBatchingEngine(params, config, **kw))
    eng = ContinuousBatchingEngine(params, config, draft_params=params,
                                   draft_config=config, n_draft=4, **kw)
    got, launched = run(eng)
    assert got == want and len(got[0]) == 56
    rounds = eng.spec_rounds
    assert launched[bc.SMALL_M.name] == launched[bc.FUSED_SMALL_M.name] == \
        rounds * (2 * 5 * 2 + 2 * 2)
    assert launched[kc.DECODE_F32.name] == rounds * 5 * 2
    assert rounds < sum(news) // 4


def test_beam_on_the_card_matches_plain(dev):
    """beam_generate through K1/K2 and B9 (fp32) against impl="torch":
    every hypothesis's tokens equal, scores within 1e-4; B9 once a layer
    a step."""
    from onebit_tpu_torch import beam_generate
    config, params = _surface_model(dev)
    prompts = [[5, 9, 3, 17], [7, 2, 11, 4, 6, 8]]
    kw = dict(num_beams=4, max_new_tokens=8, num_return_sequences=4,
              compute_dtype=torch.float32)
    kc.DECODE_F32.launches = 0
    got = beam_generate(params, config, prompts, **kw)
    assert kc.DECODE_F32.launches == 2 * 7
    want = beam_generate(params, config, prompts, impl="torch", **kw)
    for g, w in zip(got, want):
        assert [s for s, _ in g] == [s for s, _ in w]
        assert max(abs(a - b) for (_, a), (_, b) in zip(g, w)) < 1e-4


def test_tp_chunked_engine_on_the_card_matches_single_device(dev):
    """Two gloo ranks sharing the card with prefill_chunk_size=64: both
    emit the single-device chunked engine's greedy tokens; the chunks and
    the decode steps run B4 (raw small-M: every chunk is 64 rows), never
    K1-K3."""
    import numpy as np

    from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                                  host_random_packed_params)
    from onebit_tpu_torch.parallel.mesh import spawn_tp
    config = BitLlamaConfig.named("tiny", max_position_embeddings=512)
    params = host_random_packed_params(config, seed=1, dtype=torch.float32,
                                       device=dev)
    opts = dict(prefill_chunk_size=64)
    eng = ContinuousBatchingEngine(params, config, max_batch=4, max_len=256,
                                   compute_dtype=torch.float32, device=dev,
                                   **opts)
    rng = np.random.default_rng(0)
    uids = [eng.add_request(rng.integers(3, 500, n).tolist(),
                            max_new_tokens=8) for n in (150, 140, 7, 3)]
    out = eng.run()
    want = [out[u] for u in uids]
    ranks = spawn_tp(_tp_engine_rank, 2, backend="gloo", device="cuda",
                     timeout=300, args=(1, opts))
    for tokens, launches in ranks:
        assert tokens == want
        # 3 + 3 + 1 + 1 chunks and 7 decode steps, 7 projections a layer
        assert launches[bc.RAW_SMALL_M.name] == 7 * 2 * (8 + 7)
        assert launches[bc.RAW_LARGE_M.name] == 0
        assert launches[kc.DECODE_F32.name] == 2 * 7
        assert not any(launches[i.name] for i in (
            bc.SMALL_M, bc.FUSED_SMALL_M, bc.LARGE_M, bc.LARGE_M_F32))

