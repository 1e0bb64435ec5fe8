"""The arithmetic of B10's and B11 fp32's designs, held against JAX on the CPU
before any run on the card (``onebit_tpu_torch/csrc/paged_attention.cu``,
``onebit_tpu_torch/csrc/flash_attention.cu``).

B10: ``paged_attention_flat_chunked`` (chunks of ``PAGED_CHUNK`` positions
from position 0, warps of interleaved 16-position tiles, P rounded at each
tile's running max, merges in warp and chunk order) against JAX's
``paged_attention_flat`` in interpret mode, as
tests/test_torch_paged_attention.py runs it, with bf16 and int8 pages, page
sizes 8 and 16, GQA groups 1 and 4, and rows of 0, 1, chunk - 1, chunk,
chunk + 1 and mp * ps positions. Tolerances are the card's: 1/32 with bf16
pages, 1/128 with int8 pages (both sides round P to bf16 at different
softmax maxima, 2**-8 of the largest |v|: N(0, 1) pages, or int8 pages of
|v| < 1.5). A row of length 0 is zeros (JAX gives a uniform average there;
no caller reads it). The mirror's bits do not depend on the page ids.

B11 fp32: ``flash_causal_attention_split`` (q, k, v and P in three bf16
parts, six products for S and six for P V, the large one summed apart, a
fresh sum per key tile) against JAX's ``flash_causal_attention`` in interpret
mode, as tests/test_torch_attention.py runs it, to the card's 1e-4, with
q of std 5 (scores up to about 25, as at the eval check); its log-sum-exp
against ``torch.logsumexp`` of the plain scores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from onebit_tpu.engine import paged as jpg
from onebit_tpu.kernels.attention import flash_causal_attention as jflash
from onebit_tpu.kernels.paged_attention import paged_attention_flat as jflat
from onebit_tpu_torch.kernels import attention as ta
from onebit_tpu_torch.kernels import paged_attention as tpa
from onebit_tpu_torch.kernels import paged_attention_cuda as pc

CHUNK = pc.PAGED_CHUNK
PAGED_TOL = {False: 1 / 32, True: 1 / 128}     # by quant
HD = 64


def _pages(rng, shape, quant):
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if not quant:
        return [k, v]
    kq, ks = jpg._quantize_kv_int8(jnp.asarray(k))
    vq, vs = jpg._quantize_kv_int8(jnp.asarray(v))
    return [np.asarray(x) for x in (kq, ks, vq, vs)]


def _paged_case(ps, g, quant, seed=0):
    """Rows of 0, 1, CHUNK - 1, CHUNK, CHUNK + 1 and mp * ps positions over
    tables of distinct random pages; layer 1 of 2."""
    rng = np.random.default_rng(seed)
    nkv = 2
    mp = -(-(CHUNK + 40) // ps)
    lengths = np.array([0, 1, CHUNK - 1, CHUNK, CHUNK + 1, mp * ps],
                       np.int32)
    n_pages = len(lengths) * mp + 1
    pool = _pages(rng, (2, n_pages, nkv, ps, HD), quant)
    tables = rng.permutation(np.arange(1, n_pages))[:len(lengths) * mp]
    tables = tables.reshape(len(lengths), mp).astype(np.int32)
    q = (2 * rng.standard_normal((len(lengths), nkv * g, HD))
         ).astype(np.float32)
    return q, pool, lengths, tables


def _torch_pool(pool, quant):
    ts = [torch.from_numpy(np.array(x)) for x in pool]
    return ts if quant else [x.to(torch.bfloat16) for x in ts]


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_chunked_matches_jax(quant, ps, g):
    q, pool, lengths, tables = _paged_case(ps, g, quant, seed=ps + g)
    jq = jnp.asarray(q, jnp.bfloat16)
    jpool = [jnp.asarray(x) if quant else jnp.asarray(x, jnp.bfloat16)
             for x in pool]
    want = np.asarray(jflat(jq, *jpool, lengths=jnp.asarray(lengths),
                            page_indices=jnp.asarray(tables),
                            layer=jnp.int32(1), quant=quant,
                            interpret=True), np.float32)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tpool = _torch_pool(pool, quant)
    kw = dict(lengths=torch.from_numpy(lengths),
              page_indices=torch.from_numpy(tables), layer=1, quant=quant)
    got = tpa.paged_attention_flat_chunked(tq, *tpool, **kw)
    plain = tpa.paged_attention_flat_torch(tq, *tpool, **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    live = lengths > 0
    tol = PAGED_TOL[quant]
    err = np.abs(got.numpy()[live] - want[live]).max()
    assert err <= tol, err
    assert (got[~torch.from_numpy(live)] == 0).all()
    assert (got - plain)[torch.from_numpy(live)].abs().max() <= tol
    # each live row's context is of order 1: zeros would fail
    assert np.abs(want[live]).max(axis=(1, 2)).min() >= 8 * tol


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_chunked_bits_follow_positions_not_pages(quant):
    """The same positions through another page order give the same bits:
    the chunks and tiles count positions, never page ids."""
    q, pool, lengths, tables = _paged_case(16, 4, quant, seed=7)
    rng = np.random.default_rng(8)
    n_pages = pool[0].shape[1]
    perm = np.concatenate([[0], rng.permutation(np.arange(1, n_pages))])
    moved = []
    for x in pool:
        y = np.empty_like(x)
        y[:, perm] = x                 # page p's contents now at perm[p]
        moved.append(y)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    kw = dict(lengths=torch.from_numpy(lengths), layer=1, quant=quant)
    a = tpa.paged_attention_flat_chunked(
        tq, *_torch_pool(pool, quant),
        page_indices=torch.from_numpy(tables), **kw)
    b = tpa.paged_attention_flat_chunked(
        tq, *_torch_pool(moved, quant),
        page_indices=torch.from_numpy(perm[tables].astype(np.int32)), **kw)
    assert torch.equal(a, b)


def _flash_inputs(b, s, nkv, g, seed):
    rng = np.random.default_rng(seed)
    q = 5 * rng.standard_normal((b, s, nkv * g, HD)).astype(np.float32)
    k = rng.standard_normal((b, s, nkv, HD)).astype(np.float32)
    v = rng.standard_normal((b, s, nkv, HD)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("s", [128, 256])
def test_flash_split_matches_jax(s, g):
    q, k, v = _flash_inputs(2, s, 2, g, seed=s + g)
    got, _ = ta.flash_causal_attention_split(
        *(torch.from_numpy(a) for a in (q, k, v)), num_kv_groups=g)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), num_kv_groups=g))
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4
    assert np.abs(want).max(axis=(1, 3)).min() >= 8e-4


@pytest.mark.parametrize("s", [1, 63, 65, 130])
def test_flash_split_matches_plain_and_lse(s):
    """Tile edges against the plain fp32 version, and the log-sum-exp the
    backward kernels recompute P from."""
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(2, s, 2, 2, s))
    got, lse = ta.flash_causal_attention_split(q, k, v, num_kv_groups=2)
    want = ta.flash_causal_attention_torch(q, k, v, num_kv_groups=2)
    assert (got - want).abs().max() <= 1e-4
    kk = k.repeat_interleave(2, 2)
    sc = torch.einsum("bshd,bthd->bhst", q.double(), kk.double()) * HD ** -0.5
    sc = sc.masked_fill(~ta._causal_mask(s, s, 0)[0], float("-inf"))
    assert lse.shape == (2, 4, s)
    assert (lse.double() - torch.logsumexp(sc, -1)).abs().max() <= 1e-5


@pytest.mark.parametrize("g", [1, 4])
def test_flash_split_single_key_gives_v(g):
    """At S = 1 the row's one P is 1 and its output is v to the bit: P V's
    six products carry v's three parts (three products would drop v's low
    part, and the backward's di = Σ o·do would carry that error into
    gradients that are zero)."""
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(3, 1, 2, g, g))
    got, lse = ta.flash_causal_attention_split(q, k, v, num_kv_groups=g)
    assert torch.equal(got, v.repeat_interleave(g, 2))
    want = torch.einsum("bshd,bshd->bhs", q, k.repeat_interleave(g, 2))
    assert (lse - want * HD ** -0.5).abs().max() <= 1e-5
