"""The arithmetic of the small-M BitLinear kernel's and B9's designs, held
against JAX on the CPU before any run on the card
(``onebit_tpu_torch/csrc/bitlinear_small_m.cu``,
``onebit_tpu_torch/csrc/kv_attention_decode.cu``).

Small-M: ``small_m_emulation`` (split-K partials summed in split order,
fp32 y as three bf16 parts, the LayerNorm's statistics combined from
per-tile sums and squared deviations) against JAX's small-M Pallas kernels
in interpret mode and the plain version; its split rule ``small_m_plan``
pinned at the llama2-7b shapes. Tolerances are the card's: 1e-4 on fp32
LayerNorm outputs of order 1 (the two sides sum K products in other
orders: a few 1e-6), 0.0625 on bf16 outputs (two bf16 ulps below 8), raw
fp32 z to 1e-5 sqrt(K) of its largest |z|.

B9: ``kv_attention_decode_chunked`` (chunks of ``DECODE_CHUNK`` positions
from each row's start, warps of interleaved 16-position tiles, P rounded
at each tile's running max, merges in warp and chunk order) against JAX's
``kv_attention_decode`` in interpret mode, as tests/test_torch_kv_decode.py
runs it, to the card's tolerances: 1/32 where q is bf16 (both sides round
P to bf16 at different softmax maxima), 1e-5 in fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.core.packing import pack_signs_device
from onebit_tpu.kernels import bitlinear_pallas as jpl
from onebit_tpu.kernels.kv_attention import kv_attention_decode as jdecode
from onebit_tpu_torch.core.packing import pack_signs_kmajor
from onebit_tpu_torch.kernels import bitlinear_cuda as bc
from onebit_tpu_torch.kernels import kv_attention as ka
from onebit_tpu_torch.kernels import kv_attention_cuda as kc

TOL = {torch.float32: 1e-4, torch.bfloat16: 0.0625}
KV_TOL = {torch.float32: 1e-5, torch.bfloat16: 1 / 32}


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the small-M kernel's split rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,ns,plan", [
    (8, 4096, 4096, 1, (128, 6, 22, 8)),         # o_proj
    (8, 11008, 4096, 1, (128, 6, 58, 8)),        # down_proj
    (8, 4096, 3 * 4096, 3, (128, 2, 64, 8)),     # fused q/k/v
    (8, 4096, 2 * 11008, 2, (128, 2, 64, 8)),    # fused gate/up
    (8, 4096, 2048, 1, (128, 8, 16, 8)),         # the mp = 2 shards (B4)
    (8, 4096, 5504, 1, (128, 5, 26, 8)),
    (8, 2048, 4096, 1, (128, 6, 11, 8)),
    (8, 5504, 4096, 1, (128, 6, 29, 8)),
    (128, 4096, 4096, 1, (128, 2, 64, 2)),       # 16 row blocks
    (5, 512, 3 * 320, 3, (64, 4, 4, 5)),         # segments of 320: BN 64
    (9, 800, 200, 1, (128, 7, 4, 2))])           # 25 words, ragged N
def test_small_m_plan_pinned(m, k, n, ns, plan):
    assert bc.small_m_plan(m, k, n, ns) == plan


@pytest.mark.parametrize("m", [1, 8, 9, 17, 128])
@pytest.mark.parametrize("k", [256, 800, 4096, 5504, 11008, 32768])
@pytest.mark.parametrize("n,ns", [(200, 1), (4096, 1), (3 * 320, 3),
                                  (2 * 448, 2), (2 * 11008, 2)])
def test_small_m_plan_covers_k_once(m, k, n, ns):
    """Every word row lies in exactly one split, no split is empty, a CTA
    stages at most SMALL_M_MAX_WORDS word rows, a tile's splits fit in one
    cluster, a column tile never straddles a segment, and the normalisers,
    which wait for the other tiles, stay under a quarter of the SMs."""
    block_n, splits, kw, normalizers = bc.small_m_plan(m, k, n, ns)
    nw = k // 32
    assert 1 <= kw <= bc.SMALL_M_MAX_WORDS
    assert 1 <= splits <= bc.SMALL_M_MAX_SPLITS
    assert (splits - 1) * kw < nw <= splits * kw
    assert ns == 1 or (n // ns) % block_n == 0
    row_blocks = -(-m // 8)
    assert 1 <= normalizers <= -(-(n // ns) // block_n)
    assert normalizers * row_blocks * ns <= max(132 // 4, row_blocks * ns)


def test_small_m_plan_refuses_k_past_its_reach():
    with pytest.raises(ValueError, match="past"):
        bc.small_m_plan(8, 32768 + 32, 4096, 1)


# ---------------------------------------------------------------------------
# the small-M kernel's arithmetic against JAX
# ---------------------------------------------------------------------------

def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _single(m, k, n, seed):
    x, w = _rand((m, k), seed), _rand((n, k), seed + 1)
    g = 1 + 0.5 * _rand((k,), seed + 2)
    h = np.abs(_rand((n,), seed + 3)) + 0.5
    return x, w, g, h, _rand((n,), seed + 4)


def _close(got, want, dtype):
    got = got.float().numpy()
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else _f32(want))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 256), (9, 800, 128),
                                   (1, 5504, 128)])
def test_small_m_emulation_matches_jax(dtype, m, k, n):
    """One projection, with bias and raw, split over k (8, 7 and 8
    splits), against JAX's small-M kernel in interpret mode."""
    x, w, g, h, bias = _single(m, k, n, seed=m + k)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    jp = pack_signs_device(jnp.asarray(w))
    tx = torch.from_numpy(x).to(dtype)
    tg = torch.from_numpy(g).to(dtype)[None]
    tp = pack_signs_kmajor(torch.from_numpy(w))
    th, tb = torch.from_numpy(h), torch.from_numpy(bias)
    assert bc.small_m_plan(m, k, n, 1)[1] > 1
    got = bc.small_m_emulation(tx, tp, tg, th, tb, n_true=n)[0]
    want = jpl.bitlinear_packed_pallas(jx, jp, jg, jnp.asarray(h),
                                       bias=jnp.asarray(bias), interpret=True)
    assert got.dtype == dtype
    _close(got, want, dtype)
    _close(got, bc.small_m_torch(tx, tp, tg[0], th, tb), dtype)
    raw = bc.small_m_emulation(tx, tp, tg, th, n_true=n, raw=True)
    want = _f32(jpl.bitlinear_packed_raw(jx, jp, jg, jnp.asarray(h),
                                         interpret=True))
    assert raw.dtype == torch.float32
    top = np.abs(want).max()
    assert np.abs(raw.numpy() - want).max() <= 1e-5 * top * k ** 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n_true,seg_pad,ns", [(8, 200, 256, 3),
                                                 (17, 384, 384, 2)])
def test_small_m_emulation_fused_matches_jax(dtype, m, n_true, seg_pad, ns):
    """Fused segments (the LayerNorm over n_true of each, h = 0 on the
    pads, tiles of 128 in a segment of 384) against JAX's fused small-M
    kernel in interpret mode."""
    k = 1024
    ws = [_rand((n_true, k), 50 + j) for j in range(ns)]
    gs = np.stack([1 + 0.5 * _rand((k,), 60 + j) for j in range(ns)])
    hs = [np.abs(_rand((n_true,), 70 + j)) + 0.5 for j in range(ns)]
    x = _rand((m, k), 80)
    pad = seg_pad - n_true
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jnp.concatenate([jnp.pad(pack_signs_device(jnp.asarray(w)),
                                  ((0, 0), (0, pad))) for w in ws], -1)
    h = np.concatenate([np.pad(v, (0, pad)) for v in hs])
    want = jpl.bitlinear_packed_fused(
        jnp.asarray(x).astype(jdt), jp, jnp.asarray(gs).astype(jdt),
        jnp.asarray(h), n_true=n_true, interpret=True)
    tp = torch.cat([torch.nn.functional.pad(
        pack_signs_kmajor(torch.from_numpy(w)), (0, pad)) for w in ws], -1)
    tx = torch.from_numpy(x).to(dtype)
    tg = torch.from_numpy(gs).to(dtype)
    got = bc.small_m_emulation(tx, tp, tg, torch.from_numpy(h),
                               n_true=n_true)
    assert got.shape == (ns, m, n_true)
    for j in range(ns):
        _close(got[j], want[j], dtype)


# ---------------------------------------------------------------------------
# B9's chunked arithmetic against JAX
# ---------------------------------------------------------------------------

L, B, NKV, HD = 2, 4, 2, 64


def _kv_inputs(seed, g, t, pool, q_dtype):
    rng = np.random.RandomState(seed)
    q = (2 * rng.randn(B, NKV * g, HD)).astype(np.float32)
    if pool == "int8":
        kv = [rng.randint(-127, 128, (L, B, t, NKV, HD)).astype(np.int8)
              for _ in range(2)]
        ks, vs = (rng.rand(L, B, t, NKV).astype(np.float32) * 0.02 + 0.001
                  for _ in range(2))
        pools = [kv[0], ks, kv[1], vs]
    else:
        pools = [rng.randn(L, B, t, NKV, HD).astype(np.float32), None,
                 rng.randn(L, B, t, NKV, HD).astype(np.float32), None]
    jq = jnp.asarray(q).astype(q_dtype)
    jpools = [None if p is None else jnp.asarray(p) for p in pools]
    if pool == "bf16":
        jpools = [None if p is None else p.astype(jnp.bfloat16)
                  for p in jpools]

    def port(a):
        if a is None:
            return None
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
                torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True))
    return jq, jpools, port(jq), [port(p) for p in jpools]


KINDS = {"int8_bf16q": ("int8", jnp.bfloat16, torch.bfloat16),
         "int8_f32q": ("int8", jnp.float32, torch.float32),
         "bf16": ("bf16", jnp.bfloat16, torch.bfloat16),
         "f32": ("f32", jnp.float32, torch.float32)}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("g", [1, 2])
def test_chunked_mirror_matches_jax(kind, g):
    """T = 640 (three chunks of 256): rows of 640, 257 (one past a chunk)
    from start 0, one from start 100 to 612 (a start inside a chunk) and
    an empty one, layer 1."""
    pool, jdt, tdt = KINDS[kind]
    t = 640
    jq, jpools, q, pools = _kv_inputs(g, g, t, pool, jdt)
    lengths, starts = [640, 257, 612, 0], [0, 0, 100, 0]
    want = jdecode(jq, *jpools, jnp.asarray(lengths, jnp.int32),
                   jnp.int32(1), starts=jnp.asarray(starts, jnp.int32),
                   t_blk=128)
    got = ka.kv_attention_decode_chunked(
        q, *pools, torch.tensor(lengths), 1, starts=torch.tensor(starts))
    assert got.dtype == tdt and got.shape == q.shape
    live = np.array(lengths) > np.array(starts)
    np.testing.assert_allclose(got.float().numpy()[live],
                               _f32(want)[live], rtol=0, atol=KV_TOL[tdt])
    assert (got[~torch.from_numpy(live)] == 0).all()


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("span", [1, 255, 256, 257, 700])
def test_chunked_mirror_matches_plain(kind, span):
    """Rows of C - 1, C, C + 1 positions and many chunks, with starts, at
    GQA g 8, against B9's plain version."""
    pool, jdt, tdt = KINDS[kind]
    _, _, q, pools = _kv_inputs(span, 8, 1024, pool, jdt)
    lengths = torch.tensor([span, span + 9, 1024, span + 300])
    starts = torch.tensor([0, 9, 1024 - span, 300])
    want = ka.kv_attention_decode_torch(q, *pools, lengths, 0, starts=starts)
    got = ka.kv_attention_decode_chunked(q, *pools, lengths, 0,
                                         starts=starts)
    assert (got.float() - want.float()).abs().max() <= KV_TOL[tdt]


@pytest.mark.parametrize("shift", [1, 100, 300])
def test_chunked_mirror_left_pad_gives_the_same_bits(shift):
    """Chunks and tiles count from the row's start: a row shifted right by
    ``shift`` gives the same bits as its unshifted twin."""
    _, _, q, pools = _kv_inputs(5, 2, 1024, "bf16", jnp.bfloat16)
    k, v = pools[0], pools[2]
    span = 600
    k[0, 1, shift:shift + span] = k[0, 0, :span]
    v[0, 1, shift:shift + span] = v[0, 0, :span]
    q[1] = q[0]
    got = ka.kv_attention_decode_chunked(
        q[:2], k[:, :2], None, v[:, :2], None,
        torch.tensor([span, shift + span]), 0,
        starts=torch.tensor([0, shift]))
    assert torch.equal(got[0], got[1])


def test_decode_chunk_constant():
    """The wrapper's chunk is the one the CUDA source states (its
    ``kChunk``; the launch refuses any other)."""
    src = open(kc.build.CSRC / "kv_attention_decode.cu").read()
    assert f"constexpr int kChunk = {kc.DECODE_CHUNK};" in src
