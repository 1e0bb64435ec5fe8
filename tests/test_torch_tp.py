"""Tensor-parallel serving of the port against the JAX package's, at the
tiny config in fp32 on the CPU.

The port's ranks are processes: one spawn of two ranks over ``gloo``
(``parallel/mesh.py`` ``spawn_tp``, meeting at a file store) runs every
scenario of this module once, in a module fixture, and each test asserts
on its part of the result. The JAX side runs ``shard_map`` programs on
``create_mesh((1, 2))`` over the virtual CPU devices of ``conftest.py``.
This module imports only torch, numpy and the port at its top, so the
ranks, which import it to find their function, never load JAX; the JAX
package is imported inside the tests and fixtures.

Tolerances: B4's plain version against JAX's B4 in interpret mode to 1e-5
relative to each row's largest |z| in fp32 (sums of 256 signed terms in
another order), and in bf16 to one bf16 ulp of that largest |z| (a z near a
rounding boundary rounds the other way). LayerNorm outputs of order 1 to
1e-5 in fp32. Logits to 2e-4, as tests/test_torch_model.py holds the dense
path; greedy tokens exactly.
"""

import numpy as np
import pytest
import torch

from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                              SamplingConfig, fuse_for_decode, params_from_jax)
from onebit_tpu_torch.core.packing import (pack_signs_kmajor,
                                           unpack_signs_kmajor)
from onebit_tpu_torch.kernels import bitlinear as tbl
from onebit_tpu_torch.model import tp_decode as ttd
from onebit_tpu_torch.model.bitllama import init_kv_cache
from onebit_tpu_torch.parallel.mesh import TPGroup, spawn_tp

MP = 2
SPAWN_TIMEOUT = 240        # seconds, well under the conftest's 600 a test
TOL = dict(rtol=2e-4, atol=2e-4)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [3, 1, 4, 1, 5]]
SHARED = [7, 7, 7, 7, 7, 7, 7, 7, 2]          # two full pages of 4
PREFIX_PROMPTS = [SHARED + [i] for i in range(3)]
NEW_TOKENS = 6
ENGINES = {
    "dense": dict(),
    "int8_kt": dict(quantized_kv=True),
    "int4_kt": dict(quantized_kv="int4"),
    "paged": dict(paged=True, page_size=8),
    "paged_int8_prefix": dict(paged=True, page_size=4, quantized_kv=True,
                              prefix_cache=True),
}
DECODE_B, DECODE_S, DECODE_T = 2, 6, 16
CPU = torch.device("cpu")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _prompts(name):
    return PREFIX_PROMPTS if name.endswith("prefix") else PROMPTS


def _run_engine(eng, prompts):
    uids = [eng.add_request(list(p), max_new_tokens=NEW_TOKENS)
            for p in prompts]
    out = eng.run()
    return [out[u] for u in uids]


def _engine(params, config, **opts):
    return ContinuousBatchingEngine(params, config, max_batch=2, max_len=64,
                                    compute_dtype=torch.float32, **opts)


# ---------------------------------------------------------------------------
# What each rank runs (module level: the spawned ranks import it)
# ---------------------------------------------------------------------------

def _rank_bitlinear(group, case):
    """Column- and row-parallel BitLinear on layer 1 of stacked weights:
    the rank's output shard (column) and the full output (row)."""
    x, w, g, h = (torch.from_numpy(a) for a in case)
    mp, r = group.size, group.rank
    n, k = w.shape[1:]
    packed = torch.stack([pack_signs_kmajor(wl) for wl in w])
    cols, ks = slice(r * n // mp, (r + 1) * n // mp), \
        slice(r * k // mp, (r + 1) * k // mp)
    col = tbl.BitLinearWeights(weight_scale=h[:, cols].contiguous(),
                               input_factor=g,
                               packed=packed[..., cols].contiguous())
    words = slice(r * k // mp // 32, (r + 1) * k // mp // 32)
    row = tbl.BitLinearWeights(weight_scale=h,
                               input_factor=g[:, ks].contiguous(),
                               packed=packed[:, words].contiguous())
    x_loc = x[:, ks].contiguous()
    unstacked = lambda wt: tbl.BitLinearWeights(  # noqa: E731
        *(None if a is None else a[1] for a in wt))
    return {
        "col_flat": ttd._col_parallel_flat(x, {"p": col}, ("p",), 1, "auto",
                                           group)[0].numpy(),
        "col": ttd._column_parallel(x, unstacked(col), "auto",
                                    group).numpy(),
        "row_flat": ttd._row_parallel_flat(x_loc, {"p": row}, "p", 1, "auto",
                                           group).numpy(),
        "row": ttd._row_parallel(x_loc, unstacked(row), "auto",
                                 group).numpy(),
    }


def _rank_decode(group, params, config, ids, tie_params):
    """tp_decode_step (a prefill of DECODE_S tokens, then one token), a
    three-step tp_greedy_step rollout, and one greedy step on params with a
    planted tie."""
    nkv = config.num_key_value_heads // group.size

    def cache():
        return init_kv_cache(config, DECODE_B, DECODE_T, dtype=torch.float32,
                             device=CPU, num_kv_heads=nkv)

    kw = dict(compute_dtype=torch.float32)
    c = cache()
    ids = torch.from_numpy(ids)
    first, c = ttd.tp_decode_step(params, c, ids, 0, config, group, **kw)
    nxt = first[:, -1].argmax(-1)[:, None]
    second, c = ttd.tp_decode_step(params, c, nxt, DECODE_S, config, group,
                                   **kw)
    c, step_ids, idx, tokens = cache(), ids, 0, []
    for _ in range(3):
        tok, c = ttd.tp_greedy_step(params, c, step_ids, idx, config, group,
                                    **kw)
        tokens.append(tok.tolist())
        idx += step_ids.shape[1]
        step_ids = tok[:, None]
    tie, _ = ttd.tp_greedy_step(tie_params, cache(), ids, 0, config, group,
                                **kw)
    return {"logits": [first.numpy(), second.numpy()], "greedy": tokens,
            "tie": tie.tolist()}


def _rank_main(group, tree, bitlinear_case, decode_ids, tie_tree):
    torch.set_num_threads(1)
    config = BitLlamaConfig.named("tiny")
    params = params_from_jax(tree, config, device=CPU)
    tie_params = ttd.shard_tp_params(params_from_jax(tie_tree, config,
                                                     device=CPU), group)
    out = {"bitlinear": _rank_bitlinear(group, bitlinear_case),
           "decode": _rank_decode(group, ttd.shard_tp_params(params, group),
                                  config, decode_ids, tie_params),
           "engine": {}}
    for name, opts in ENGINES.items():
        eng = _engine(params, config, tp_group=group, **opts)
        out["engine"][name] = _run_engine(eng, _prompts(name))
        if eng.paged:
            out["engine"][name + "_hits"] = eng.prefix_hits
    sampled = _engine(params, config, tp_group=group, seed=3,
                      sampling=SamplingConfig(temperature=0.9, top_k=50))
    out["sampled"] = _run_engine(sampled, PROMPTS)
    return out


# ---------------------------------------------------------------------------
# Fixtures: the JAX model and its TP programs, the two ranks' results
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tiny single-device runs here take one intra-op thread, as
    the ranks do: under the suite's parallel workers, torch's default of one
    thread per core made each run 50x slower. Restored for later modules."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _portable(tree):
    """A JAX numpy params tree with the port's ``BitLinearWeights`` (same
    fields) in place of the JAX class: the ranks unpickle it without the
    JAX package."""
    layers = {name: tbl.BitLinearWeights(*w) if isinstance(w, tuple) else w
              for name, w in tree["layers"].items()}
    return dict(tree, layers=layers)


@pytest.fixture(scope="module")
def jax_tiny():
    """(JAX config, JAX packed params, the same params as a portable numpy
    tree)."""
    import jax

    from onebit_tpu.model import bitllama as jb
    from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
    jc = JaxConfig.named("tiny")
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(0)))
    return jc, jp, _portable(jax.tree.map(np.array, jp))


def _bitlinear_case():
    layers, m, n, k = 2, 4, 256, 128
    return (_rand((m, k), 10), _rand((layers, n, k), 11),
            _rand((layers, k), 12), _rand((layers, n), 13))


def _decode_ids():
    return np.random.default_rng(4).integers(
        0, 512, (DECODE_B, DECODE_S)).astype(np.int64)


@pytest.fixture(scope="module")
def jax_decode(jax_tiny):
    """JAX's make_tp_decode_step and make_tp_greedy_step on the inputs the
    ranks get, and the planted tie: rows j and V/2 + j of the lm_head set
    to 4x the row of row 0's first greedy token, so that both vocab halves
    hold its largest logit, at the same local index."""
    import jax
    import jax.numpy as jnp

    from onebit_tpu.model.bitllama import init_kv_cache as jax_cache
    from onebit_tpu.model.tp_decode import (make_tp_decode_step,
                                            make_tp_greedy_step,
                                            shard_tp_params)
    from onebit_tpu.parallel.mesh import create_mesh
    jc, jp, tree = jax_tiny
    mesh = create_mesh((1, MP))
    kw = dict(compute_dtype=jnp.float32, impl="xla")
    step = make_tp_decode_step(mesh, jc, jp, **kw)
    greedy = make_tp_greedy_step(mesh, jc, jp, **kw)
    sp, _ = shard_tp_params(jp, mesh)

    def cache():
        return jax_cache(jc, DECODE_B, DECODE_T, dtype=jnp.float32)

    ids = jnp.asarray(_decode_ids(), jnp.int32)
    first, c = step(sp, cache(), ids, jnp.int32(0))
    nxt = jnp.argmax(first[:, -1:], -1).astype(jnp.int32)
    second, _ = step(sp, c, nxt, jnp.int32(DECODE_S))
    c, step_ids, idx, tokens = cache(), ids, 0, []
    for _ in range(3):
        tok, c = greedy(sp, c, step_ids, jnp.int32(idx))
        tokens.append(np.asarray(tok).tolist())
        idx += step_ids.shape[1]
        step_ids = tok[:, None]
    top, half = tokens[0][0], jc.vocab_size // 2
    j = next(i for i in range(half) if top not in (i, i + half))
    head = tree["lm_head"].copy()
    head[j] = head[j + half] = 4 * head[top]
    tie_sp, _ = shard_tp_params(dict(jp, lm_head=jnp.asarray(head)), mesh)
    tie, _ = greedy(tie_sp, cache(), ids, jnp.int32(0))
    return {"logits": [np.asarray(first), np.asarray(second)],
            "greedy": tokens, "tie": np.asarray(tie).tolist(), "j": j,
            "tie_tree": dict(tree, lm_head=head)}


@pytest.fixture(scope="module")
def ranks(jax_tiny, jax_decode):
    """Both ranks' results of every scenario, from one spawn."""
    return spawn_tp(_rank_main, MP, backend="gloo", device="cpu",
                    timeout=SPAWN_TIMEOUT,
                    args=(jax_tiny[2], _bitlinear_case(), _decode_ids(),
                          jax_decode["tie_tree"]))


# ---------------------------------------------------------------------------
# B4: the plain version against JAX's kernel in interpret mode
# ---------------------------------------------------------------------------

def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(v, 1e-30))) - 7)


@pytest.mark.parametrize("stacked", [True, False],
                         ids=["raw_stacked", "raw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [4, 160])
def test_b4_plain_matches_jax_interpret(m, dtype, stacked):
    import jax.numpy as jnp

    from onebit_tpu.core.packing import pack_signs_device
    from onebit_tpu.kernels import bitlinear_pallas as bp
    layers, k, n = 2, 256, 256
    x, w = _rand((m, k), 20), _rand((layers, n, k), 21)
    g, h = 1 + 0.5 * _rand((layers, k), 22), 0.5 + np.abs(
        _rand((layers, n), 23))
    jdt = jnp.dtype(dtype)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    jpacked = pack_signs_device(jnp.asarray(w))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    packed = torch.stack([pack_signs_kmajor(torch.from_numpy(wl))
                          for wl in w])
    if stacked:
        want = bp.bitlinear_packed_raw_stacked(jx, jpacked, jg,
                                               jnp.asarray(h), 1)
        got = tbl.bitlinear_apply_stacked_raw(
            tx, tbl.BitLinearWeights(weight_scale=torch.from_numpy(h),
                                     input_factor=torch.from_numpy(g).to(tdt),
                                     packed=packed), 1)
    else:
        want = bp.bitlinear_packed_raw(jx, jpacked[1], jg[1],
                                       jnp.asarray(h[1]))
        got = tbl.bitlinear_packed_raw(tx, packed[1],
                                       torch.from_numpy(g[1]).to(tdt),
                                       torch.from_numpy(h[1]))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == (torch.float32 if stacked or m <= 128 else tdt)
    got = got.float().numpy()
    row_max = np.abs(want).max(-1, keepdims=True)
    err = np.abs(got - want)
    if dtype == "float32":
        assert (err <= 1e-5 * row_max).all(), (err / row_max).max()
    else:
        assert (err <= _bf16_ulp(row_max)).all(), (err / row_max).max()


# ---------------------------------------------------------------------------
# The sharding
# ---------------------------------------------------------------------------

def _shards(tree, mp):
    c = BitLlamaConfig.named("tiny")
    params = params_from_jax(tree, c, device=CPU)
    return params, [ttd.shard_tp_params(params, TPGroup(None, r, mp, CPU))
                    for r in range(mp)]


@pytest.mark.parametrize("mp", [2, 4])
def test_shards_rebuild_the_params(jax_tiny, mp):
    params, shards = _shards(jax_tiny[2], mp)
    cat = lambda key, axis: torch.cat([s[key] for s in shards], axis)  # noqa
    assert torch.equal(cat("embed_tokens", 0), params["embed_tokens"])
    assert torch.equal(cat("lm_head", 0), params["lm_head"])
    for name in ttd.COLUMN_PARALLEL + ttd.ROW_PARALLEL:
        w = params["layers"][name]
        parts = [s["layers"][name] for s in shards]
        col = name in ttd.COLUMN_PARALLEL
        assert all(p.packed.is_contiguous() for p in parts)
        assert torch.equal(torch.cat([p.packed for p in parts],
                                     -1 if col else -2), w.packed)
        split, whole = ("weight_scale", "input_factor") if col else \
            ("input_factor", "weight_scale")
        assert torch.equal(torch.cat([getattr(p, split) for p in parts], -1),
                           getattr(w, split))
        assert all(torch.equal(getattr(p, whole), getattr(w, whole))
                   for p in parts)


@pytest.mark.parametrize("mp", [2, 4])
def test_row_shards_unpack_like_jax_repack(jax_tiny, mp):
    """A row-parallel shard of the port (a block of word rows) holds the
    same signs as the JAX shard of ``repack_row_parallel``."""
    import jax.numpy as jnp

    from onebit_tpu.core.packing import unpack_signs_device
    from onebit_tpu.model.tp_decode import repack_row_parallel
    _, shards = _shards(jax_tiny[2], mp)
    for name in ttd.ROW_PARALLEL:
        repacked = repack_row_parallel(
            jnp.asarray(jax_tiny[2]["layers"][name].packed[0]), mp)
        words = repacked.shape[0] // mp
        for r, s in enumerate(shards):
            want = unpack_signs_device(repacked[r * words:(r + 1) * words],
                                       dtype=jnp.float32)
            got = unpack_signs_kmajor(s["layers"][name].packed[0],
                                      dtype=torch.float32)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Column- and row-parallel BitLinear over two gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bitlinear_refs():
    """JAX's shard_map programs on create_mesh((1, 2)) and the port's
    single-device bitlinear_apply, on layer 1 of the case."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from onebit_tpu.core.packing import pack_signs_device
    from onebit_tpu.kernels.bitlinear import BitLinearWeights as JaxWeights
    from onebit_tpu.kernels.bitlinear_sharded import make_tp_bitlinear
    from onebit_tpu.model.tp_decode import (_col_parallel_flat,
                                            _row_parallel_flat,
                                            repack_row_parallel)
    from onebit_tpu.parallel.mesh import MODEL_AXIS, create_mesh
    x, w, g, h = _bitlinear_case()
    mesh = create_mesh((1, MP))
    jx = jnp.asarray(x)
    jw = JaxWeights(weight_scale=jnp.asarray(h), input_factor=jnp.asarray(g),
                    packed=pack_signs_device(jnp.asarray(w)))
    col_spec = JaxWeights(weight_scale=P(None, MODEL_AXIS),
                          input_factor=P(None, None),
                          packed=P(None, None, MODEL_AXIS))
    row_spec = JaxWeights(weight_scale=P(None, None),
                          input_factor=P(None, MODEL_AXIS),
                          packed=P(None, MODEL_AXIS, None))
    col = jax.jit(jax.shard_map(
        lambda xx, ww: _col_parallel_flat(xx, {"p": ww}, "p", jnp.int32(1),
                                          "xla"),
        mesh=mesh, in_specs=(P(), col_spec), out_specs=P(None, MODEL_AXIS),
        check_vma=False))
    row = jax.jit(jax.shard_map(
        lambda xx, ww: _row_parallel_flat(xx, {"p": ww}, "p", jnp.int32(1),
                                          "xla"),
        mesh=mesh, in_specs=(P(None, MODEL_AXIS), row_spec), out_specs=P(),
        check_vma=False))
    jw_row = jw._replace(packed=repack_row_parallel(jw.packed, MP))
    single = tbl.bitlinear_apply(
        torch.from_numpy(x),
        tbl.BitLinearWeights(weight_scale=torch.from_numpy(h[1]),
                             input_factor=torch.from_numpy(g[1]),
                             packed=pack_signs_kmajor(torch.from_numpy(w[1]))))
    return {
        "col_flat": np.asarray(col(jx, jw)),
        "col": np.asarray(jax.jit(make_tp_bitlinear(mesh, impl="xla"))(
            jx, jw.packed[1], jw.input_factor[1], jw.weight_scale[1])),
        "row_flat": np.asarray(row(jx, jw_row)),
        "single": single.numpy(),
    }


@pytest.mark.parametrize("name", ["col_flat", "col", "row_flat", "row"])
def test_parallel_bitlinear_matches_jax_and_single_device(ranks,
                                                          bitlinear_refs,
                                                          name):
    outs = [r["bitlinear"][name] for r in ranks]
    got = np.concatenate(outs, -1) if name.startswith("col") else outs[0]
    if not name.startswith("col"):
        np.testing.assert_array_equal(outs[1], outs[0])
    want = bitlinear_refs.get(name, bitlinear_refs["row_flat"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, bitlinear_refs["single"], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# tp_decode_step, tp_greedy_step
# ---------------------------------------------------------------------------

def test_tp_decode_step_logits_match_jax(ranks, jax_decode):
    for got, want in zip(ranks[0]["decode"]["logits"],
                         jax_decode["logits"]):
        np.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(ranks[0]["decode"]["logits"],
                    ranks[1]["decode"]["logits"]):
        np.testing.assert_array_equal(a, b)


def test_tp_greedy_step_tokens_match_jax(ranks, jax_decode):
    assert ranks[0]["decode"]["greedy"] == jax_decode["greedy"]
    assert ranks[1]["decode"]["greedy"] == jax_decode["greedy"]


def test_tp_greedy_tie_goes_to_the_lower_index(ranks, jax_decode):
    j = jax_decode["j"]
    assert jax_decode["tie"][0] == j
    assert ranks[0]["decode"]["tie"] == ranks[1]["decode"]["tie"] == \
        jax_decode["tie"]


# ---------------------------------------------------------------------------
# The TP engine, mp = 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engines(jax_tiny):
    """For each cache, the JAX TP engine's greedy tokens
    (tp_mesh=create_mesh((1, 2))) and prefix hits."""
    import jax.numpy as jnp

    from onebit_tpu.engine.batching import ContinuousBatchingEngine as JaxEng
    from onebit_tpu.parallel.mesh import create_mesh
    jc, jp, _ = jax_tiny
    out = {}
    for name, opts in ENGINES.items():
        eng = JaxEng(jp, jc, max_batch=2, max_len=64,
                     compute_dtype=jnp.float32, tp_mesh=create_mesh((1, MP)),
                     **opts)
        out[name] = _run_engine(eng, _prompts(name))
        out[name + "_hits"] = getattr(eng, "prefix_hits", None)
    return out


def _single_device_run(params, config, name, monkeypatch):
    """The port's single-device engine: its greedy tokens, and for each the
    gap between the two largest logits it was chosen from, per request (a
    row of each sample is emitted in the order of the sample's rows at
    admission, and at the slot's row in a decode step)."""
    from onebit_tpu_torch.engine import batching
    eng = _engine(params, config, device="cpu", **ENGINES[name])
    gaps, state = {}, {"decoding": False, "gaps": None, "next": 0}
    sample, emit, decode = batching.sample_token, eng._emit, eng._decode

    def sample_token(logits, *args):
        top2 = logits.float().topk(2, dim=-1).values
        state["gaps"], state["next"] = (top2[:, 0] - top2[:, 1]).tolist(), 0
        return sample(logits, *args)

    def _emit(slot, tok):
        row = slot if state["decoding"] else state["next"]
        state["next"] += 1
        gaps.setdefault(eng.slots[slot].uid, []).append(state["gaps"][row])
        emit(slot, tok)

    def _decode():
        state["decoding"] = True
        try:
            decode()
        finally:
            state["decoding"] = False

    monkeypatch.setattr(batching, "sample_token", sample_token)
    eng._emit, eng._decode = _emit, _decode
    tokens = _run_engine(eng, _prompts(name))
    return tokens, [gaps[u] for u in sorted(gaps)]


def _equal_off_near_ties(got, want, gaps, tie):
    """Each request's tokens equal, or equal up to a first difference where
    the two largest logits lie within ``tie``."""
    for g, w, gap in zip(got, want, gaps):
        first = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                     None)
        assert g == w or (first is not None and gap[first] < tie), \
            (first, g, w)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_tp_engine_matches_jax_and_single_device(ranks, jax_engines,
                                                 jax_tiny, name,
                                                 monkeypatch):
    """Greedy tokens of both ranks equal the JAX TP engine's and the port's
    single-device engine's, off near-ties of the single-device engine's
    logits: twice the logits' tolerance, 2e-4 on float caches, 1e-2 on
    quantized ones, whose values may differ by one step where two sides'
    K/V straddle a rounding boundary (tests/test_torch_paged.py)."""
    c = BitLlamaConfig.named("tiny")
    params = params_from_jax(jax_tiny[2], c, device=CPU)
    single, gaps = _single_device_run(params, c, name, monkeypatch)
    tie = 2 * (1e-2 if ENGINES[name].get("quantized_kv") else 2e-4)
    got = ranks[0]["engine"][name]
    assert got == ranks[1]["engine"][name]
    for want in (jax_engines[name], single):
        _equal_off_near_ties(got, want, gaps, tie)
    if name.endswith("prefix"):
        # the shared pages were reused, on both ranks as in JAX
        hits = [r["engine"][name + "_hits"] for r in ranks]
        assert hits[0] == hits[1] == jax_engines[name + "_hits"] > 0


def test_tp_engine_sampled_ranks_agree(ranks):
    got = [r["sampled"] for r in ranks]
    assert got[0] == got[1]
    assert [len(t) for t in got[0]] == [NEW_TOKENS] * len(PROMPTS)


# ---------------------------------------------------------------------------
# Refusals and the launcher
# ---------------------------------------------------------------------------

def test_indivisible_heads_raise_as_in_jax(jax_tiny):
    """tiny has 2 kv heads: four ranks cannot split them (JAX's words)."""
    from onebit_tpu.engine.batching import ContinuousBatchingEngine as JaxEng
    from onebit_tpu.parallel.mesh import create_mesh
    jc, jp, tree = jax_tiny
    c = BitLlamaConfig.named("tiny")
    with pytest.raises(ValueError) as want:
        JaxEng(jp, jc, tp_mesh=create_mesh((1, 4)))
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(params_from_jax(tree, c, device=CPU), c,
                                 tp_group=TPGroup(None, 0, 4, CPU))
    assert str(got.value) == str(want.value)


def test_fused_params_refused_under_tp(jax_tiny):
    """Tensor parallelism shards each projection; fused q/k/v and gate/up
    are refused, as the JAX command line refuses --fuse-decode with --tp."""
    c = BitLlamaConfig.named("tiny")
    fused = fuse_for_decode(params_from_jax(jax_tiny[2], c, device=CPU), c)
    with pytest.raises(ValueError, match="fuse_for_decode"):
        ContinuousBatchingEngine(fused, c, tp_group=TPGroup(None, 0, 2, CPU))


@pytest.mark.parametrize("kwargs", [
    dict(block_steps=4), dict(prefill_chunk_size=16),
    dict(paged=True, block_steps=2), dict(draft_params={}),
    dict(block_steps=4, pipeline_blocks=True),
    dict(paged=True, quantized_kv="fp8")],
    ids=["block_steps", "dense_chunked_prefill", "paged_block_steps",
         "speculative", "pipeline_blocks", "fp8_pages"])
def test_unported_options_raise_under_tp(jax_tiny, kwargs):
    """Options not ported yet raise NotImplementedError naming ROADMAP §1
    item 5. Decode blocks are ported: a rank's engine builds with its
    eager blocks (tests/test_torch_blocks.py serves through them over two
    ranks)."""
    c = BitLlamaConfig.named("tiny")
    group = TPGroup(None, 0, 2, CPU)
    if "block_steps" not in kwargs:
        with pytest.raises(NotImplementedError, match="item 5"):
            ContinuousBatchingEngine({}, c, tp_group=group, **kwargs)
        return
    eng = ContinuousBatchingEngine(params_from_jax(jax_tiny[2], c,
                                                   device=CPU), c,
                                   tp_group=group, **kwargs)
    assert eng._tp.block_steps == eng.block_steps == kwargs["block_steps"]
    assert eng._graph is None and eng.pipeline_blocks == kwargs.get(
        "pipeline_blocks", False)


def _fail_on_rank_0(group):
    if group.rank == 0:
        raise ArithmeticError("planted failure on rank 0")
    # rank 1 waits in a collective that rank 0 never joins
    return group.all_reduce(torch.ones(1)).item()


def test_spawn_tp_reraises_a_failed_rank():
    """A failed rank fails the launch with its traceback, and the rank left
    waiting in a collective is stopped."""
    with pytest.raises(RuntimeError, match="planted failure on rank 0"):
        spawn_tp(_fail_on_rank_0, MP, backend="gloo", device="cpu",
                 timeout=60)


def test_spawn_tp_takes_the_callers_backend_and_device():
    with pytest.raises(ValueError, match="backend"):
        spawn_tp(_fail_on_rank_0, MP, backend="mpi", device="cpu",
                 timeout=10)
    with pytest.raises(ValueError, match="device"):
        spawn_tp(_fail_on_rank_0, MP, backend="gloo", device="tpu",
                 timeout=10)
