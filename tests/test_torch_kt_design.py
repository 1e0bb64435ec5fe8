"""B5-B8's chunked arithmetic on the CPU: ``kv_attention_kt_chunked`` (the
split-T kernel of ``csrc/kv_attention_kt.cuh``, step by step: chunks of byte
columns from column 0, the warps' tiles of 16 columns, the merges in warp
and chunk order, the append by the chunk that owns the fresh column) held to

* the JAX Pallas kernels ``kv_attention_append_kt``, ``decode_kt``,
  ``append_kt4`` and ``decode_kt4`` in interpret mode, at T 384 (int8) and
  768 (int4), two chunks each, three rows, GQA g 1 and 4: pools equal to
  JAX's after the append (``np.array_equal``), ctx in fp32 to 1e-5 (rtol
  and atol, as tests/test_torch_kv_attention.py: the same fp32 products
  summed in another order) on the rows with something to attend;
* the port's plain versions at the chunk edges: lengths at a chunk's size
  and one either side, int4 rows at T/2 and one either side, a start past
  T/2, the append at a chunk's first and last column, and an inactive row
  whose write lands in a chunk it does not attend; fp32 q to 1e-5 and bf16
  q to 1/32 (both sides round P x v_scale to bf16 at different softmax
  maxima, 2**-9 relative of |v| < 1.8, then ctx to bf16: under 1/64);

and the chunk constants to the CUDA sources. A row with nothing to attend
gets zeros from the mirror (and the kernel); JAX's and the plain version's
uniform average there is never read.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.kernels import kv_attention as jka
from onebit_tpu.model.kv_cache import pack_int4_halfplane
from onebit_tpu_torch.kernels import kv_attention as ka
from onebit_tpu_torch.kernels import kv_attention_cuda as kc

CTX_TOL = dict(rtol=1e-5, atol=1e-5)
EDGE_TOL = {torch.float32: CTX_TOL, torch.bfloat16: dict(rtol=0, atol=1 / 32)}
L, NKV, HD, LAYER = 2, 2, 64, 1
T8, T4 = 384, 768
C8, C4 = kc.KT_CHUNK, kc.KT4_CHUNK


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The mirror runs thousands of tiny torch ops. Beside the other test
    workers, torch's intra-op threads contend for the cores and make them
    some 30 times slower, so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_inputs(seed, b, g, t, int4):
    """q, the new K/V with their scales, and KT (int8) or KT4 (int4, packed
    with the JAX packer) pools, as numpy."""
    rng = np.random.default_rng(seed)
    lo, hi = (-8, 8) if int4 else (-127, 128)
    q = rng.standard_normal((b, NKV * g, HD)).astype(np.float32)
    new = [rng.integers(lo, hi, (b, NKV, HD)).astype(np.int8),
           (rng.random((b, NKV)) * 0.3 + 0.01).astype(np.float32),
           rng.integers(lo, hi, (b, NKV, HD)).astype(np.int8),
           (rng.random((b, NKV)) * 0.3 + 0.01).astype(np.float32)]
    k = rng.integers(lo, hi, (L, b, NKV, HD, t)).astype(np.int8)
    v = rng.integers(lo, hi, (L, b, t, NKV, HD)).astype(np.int8)
    if int4:
        k = np.asarray(pack_int4_halfplane(jnp.asarray(k), axis=4))
        v = np.asarray(pack_int4_halfplane(jnp.asarray(v), axis=2))
    pools = [k, rng.random((L, b, NKV, t)).astype(np.float32),
             v, rng.random((L, b, t, NKV)).astype(np.float32)]
    return q, new, pools


# (pos, lengths, starts) of three rows. int8 (T 384, a chunk of 256 byte
# columns and one of 128): rows one short of, at and one past the chunk; a
# start inside the second chunk; an inactive row whose write lands in the
# first. int4 (T 768, T/2 384: chunks of 256 and 128 byte columns): rows at
# T/2 - 1, T/2, T/2 + 1; starts past T/2; an inactive row written in the
# high plane, and writes at the first chunk's last column and the second's
# first, high plane.
JAX_CASES = {
    False: {"chunk_edges": ([254, 255, 256], [C8 - 1, C8, C8 + 1], None),
            "starts": ([C8, 300, 20], [C8 + 1, 301, 21], [0, C8 + 7, 3]),
            "inactive": ([C8 - 1, 200, 383], [C8, 0, T8], [5, 0, 0])},
    True: {"half_edges": ([382, 383, 384], [383, 384, 385], None),
           "past_half": ([500, 700, 767], [501, 701, T4], [404, 300, 0]),
           "inactive": ([T4 // 2 + C4, 450, C4 - 1], [T4 // 2 + C4 + 1, 0,
                                                     600], [0, 0, 129])},
}


def _jstarts(starts):
    return None if starts is None else jnp.asarray(starts, jnp.int32)


@functools.cache
def _jax_result(int4, case, g, append):
    """JAX's (ctx, pools after the call) for one case, cached for the
    module: the mirror and the plain version are both held to it."""
    pos, lengths, starts = JAX_CASES[int4][case]
    q, new, pools = _jax_inputs(7 + g, 3, g, T4 if int4 else T8, int4)
    args = [jnp.asarray(q)] + ([jnp.asarray(x) for x in new] if append
                               else [])
    args += [jnp.asarray(x) for x in pools]
    args += [jnp.asarray(lengths, jnp.int32), jnp.int32(LAYER)]
    fn = {(False, True): jka.kv_attention_append_kt,
          (False, False): jka.kv_attention_decode_kt,
          (True, True): jka.kv_attention_append_kt4,
          (True, False): jka.kv_attention_decode_kt4}[(int4, append)]
    if append:
        args.append(jnp.asarray(pos, jnp.int32))
    res = fn(*args, starts=_jstarts(starts), t_blk=256 if int4 else 128)
    if append:
        ctx, want_pools = res[0], [np.asarray(x) for x in res[1:]]
    else:
        ctx, want_pools = res, pools
    return (q, new, pools), np.asarray(ctx), want_pools


JAX_IDS = [(int4, case) for int4 in (False, True)
           for case in sorted(JAX_CASES[int4])]


def _run(impl, int4, case, g, append):
    """``impl`` ("mirror" or "plain") on a case's inputs: ctx and pools."""
    (q, new, pools), _, _ = _jax_result(int4, case, g, append)
    pos, lengths, starts = JAX_CASES[int4][case]
    tpools = [_t(p) for p in pools]
    tstarts = None if starts is None else torch.tensor(starts)
    tail = dict(starts=tstarts)
    if impl == "mirror":
        extra = (tuple(map(_t, new)) + (torch.tensor(pos),)) if append \
            else None
        ctx = ka.kv_attention_kt_chunked(
            _t(q), *tpools, torch.tensor(lengths), LAYER, append=extra,
            int4=int4, **tail)
    elif append:
        fn = (ka.kv_attention_append_kt4_torch if int4
              else ka.kv_attention_append_kt_torch)
        ctx = fn(_t(q), *map(_t, new), *tpools, torch.tensor(lengths), LAYER,
                 torch.tensor(pos), **tail)
    else:
        fn = (ka.kv_attention_decode_kt4_torch if int4
              else ka.kv_attention_decode_kt_torch)
        ctx = fn(_t(q), *tpools, torch.tensor(lengths), LAYER, **tail)
    return ctx, tpools


@pytest.mark.parametrize("impl", ["mirror", "plain"])
@pytest.mark.parametrize("append", [True, False], ids=["append", "decode"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("int4,case", JAX_IDS,
                         ids=[f"{'int4' if i else 'int8'}-{c}"
                              for i, c in JAX_IDS])
def test_matches_jax(impl, append, g, int4, case):
    _, want, want_pools = _jax_result(int4, case, g, append)
    _, lengths, starts = JAX_CASES[int4][case]
    got, pools = _run(impl, int4, case, g, append)
    for name, a, b in zip(("k", "k_scale", "v", "v_scale"), pools,
                          want_pools):
        np.testing.assert_array_equal(a.numpy(), b, name)
    live = np.asarray(lengths) > (0 if starts is None else np.asarray(starts))
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[live], want[live], **CTX_TOL)
    if impl == "mirror":
        assert (got[~live] == 0).all()


# ---------------------------------------------------------------------------
# The mirror against the plain versions at the chunk edges
# ---------------------------------------------------------------------------

def _edge_inputs(seed, b, g, t, int4, q_dtype):
    """Scales of 0.5-1.5 units over the integer range (|v| < 1.8) and q of
    std 5: a context of order 1 on every live row."""
    gen = torch.Generator().manual_seed(seed)
    tb = t // 2 if int4 else t
    levels, lo = (7, -128) if int4 else (127, -127)
    nlo, nhi = (-8, 8) if int4 else (-127, 128)

    def ints(*s, lo=lo, hi=128):
        return torch.randint(lo, hi, s, generator=gen, dtype=torch.int8)

    def scales(*s):
        return (torch.rand(s, generator=gen) + 0.5) / levels

    q = (5 * torch.randn(b, NKV * g, HD, generator=gen)).to(q_dtype)
    new = [ints(b, NKV, HD, lo=nlo, hi=nhi), scales(b, NKV),
           ints(b, NKV, HD, lo=nlo, hi=nhi), scales(b, NKV)]
    pools = [ints(L, b, NKV, HD, tb), scales(L, b, NKV, t),
             ints(L, b, tb, NKV, HD), scales(L, b, t, NKV)]
    return q, new, pools


# (length, start, pos) per row at T = 4 chunks: a chunk's size and one
# either side, many chunks, a start inside a chunk and one on a chunk's
# first column; the write at a chunk's first and last column, on warp tiles'
# and ring stages' edges (columns c + 32, 127, c + 127), and an inactive row
# written in a chunk it does not attend. int4 adds rows at T/2 and one
# either side, a start past T/2, writes at the first and last column of the
# high plane's chunks, and a row whose planes leave a gap of columns.
def _edge_rows(int4):
    c = C4 if int4 else C8           # byte columns a chunk
    t = 4 * (2 * C4 if int4 else C8)
    h = t // 2
    rows = [(c - 1, 0, c - 2), (c, 0, c - 1), (c + 1, 0, c), (t, 0, t - 1),
            (2 * c + 17, c + 3, 2 * c + 16), (3 * c, c, 3 * c - 1),
            (0, 0, c + 15), (c + 40, 0, c + 32), (150, 0, 127),
            (c + 200, 5, c + 127)]
    if int4:
        rows += [(h - 1, 0, h - 2), (h, 0, h - 1), (h + 1, 0, h),
                 (h + c + 1, h + 5, h + c), (t - 3, h + 1, h + c - 1),
                 (0, 0, h + 2 * c), (t, 0, h + 3 * c - 1),
                 (h + 60, 200, h + 40)]
    return t, rows


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("with_starts", [True, False],
                         ids=["starts", "no_starts"])
@pytest.mark.parametrize("append", [True, False], ids=["append", "decode"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_chunk_edges_match_plain(q_dtype, with_starts, append, g, int4):
    t, rows = _edge_rows(int4)
    q, new, pools = _edge_inputs(g + 10 * int4, len(rows), g, t, int4,
                                 q_dtype)
    lengths = torch.tensor([r[0] for r in rows])
    starts = torch.tensor([r[1] for r in rows]) if with_starts else None
    pos = torch.tensor([r[2] for r in rows])
    plain_pools = [x.clone() for x in pools]
    if append:
        plain = (ka.kv_attention_append_kt4_torch if int4
                 else ka.kv_attention_append_kt_torch)
        want = plain(q, *new, *plain_pools, lengths, 0, pos, starts=starts)
    else:
        plain = (ka.kv_attention_decode_kt4_torch if int4
                 else ka.kv_attention_decode_kt_torch)
        want = plain(q, *plain_pools, lengths, 0, starts=starts)
    got = ka.kv_attention_kt_chunked(
        q, *pools, lengths, 0, starts=starts, int4=int4,
        append=(*new, pos) if append else None)
    for a, b in zip(pools, plain_pools):
        assert torch.equal(a, b)
    assert got.dtype == q_dtype and got.shape == q.shape
    live = lengths > (starts if starts is not None else 0)
    assert (got[~live] == 0).all()
    np.testing.assert_allclose(got[live].float().numpy(),
                               want[live].float().numpy(),
                               **EDGE_TOL[q_dtype])
    assert want[live].float().abs().amax(dim=(1, 2)).min() >= 8 / 32


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_append_owner_writes_an_inactive_row(int4):
    """A row of length 0 whose write position lies in the last chunk: the
    pools change there, and only there, and its output is zeros."""
    t, _ = _edge_rows(int4)
    q, new, pools = _edge_inputs(3, 2, 2, t, int4, torch.float32)
    before = [x.clone() for x in pools]
    pos = torch.tensor([t - 1, 5])
    got = ka.kv_attention_kt_chunked(q, *pools, torch.tensor([0, 6]), 1,
                                     int4=int4, append=(*new, pos))
    assert (got[0] == 0).all() and got[1].abs().max() > 0
    k, ks, v, vs = (x[1] for x in pools)
    k0, ks0, v0, vs0 = (x[1] for x in before)
    col = t // 2 - 1 if int4 else t - 1
    changed = (k != k0).nonzero()[:, 3].unique().tolist()
    assert set(changed) <= {col, 5} and col in changed
    assert ks[0, :, t - 1].equal(new[1][0]) and vs[0, t - 1].equal(new[3][0])
    assert torch.equal(ks0[0, :, :t - 1], ks[0, :, :t - 1])


@pytest.mark.parametrize("source,chunk", [("kv_attention_int8.cu", C8),
                                          ("kv_attention_int4.cu", C4)])
def test_kt_chunk_constants(source, chunk):
    """The wrapper's chunks and the mirror's tile are the ones the CUDA
    sources state (their ``kChunk``, which the launch checks, and
    ``kTile``)."""
    src = open(kc.build.CSRC / source).read()
    assert f"constexpr int kChunk = {chunk};" in src
    assert f"constexpr int kTile = {kc.KT_TILE};" in src
