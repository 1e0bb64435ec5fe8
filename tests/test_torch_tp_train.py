"""Tensor-parallel KD training of the port on ``(data, model)`` meshes,
against the JAX package's sharded step on the CPU.

One spawn of four gloo ranks (``parallel/mesh.py`` ``spawn_tp``) runs every
scenario that needs a group, in a module fixture, and each test asserts on
its part of the result: three fp32 steps on ``(1, 2)`` (each rank pair's
model group alone), ``(2, 2)`` and ``(1, 4)`` (tiny's two KV heads do not
divide by four, so k and v stay whole on every rank), three steps on
``(1, 4)`` of a config whose MLP width four ranks do not divide, the
gradients with an autograd all-reduce on the row-parallel edge and with
the LayerNorm statistics' backward left without its all-reduce,
``run_kd`` on ``(2, 2)`` resumed from ``train_state.pt`` and from DCP
files, a DCP state read onto another mesh, and the in-process twin of the
command line's run. One launch of ``python -m onebit_tpu_torch train
--batch-size 1`` as two OS processes (the mesh ``(1, 2)``) is the
module's other launch. JAX's three sharded steps compute on threads while
the ranks run. This module imports only torch, numpy and the port at its
top, so the ranks never load JAX.

Tolerances: the losses, metrics and params against JAX's sharded step to
1e-5 relative (``tests/test_torch_parallel.py``'s TOL: the latent planes in
norm, g and h element by element); gradients against the one-device
step's (held to JAX in tests/test_torch_train.py) to 1e-5 of each leaf's
largest; the ranks' own reruns (resumes, the command line against the
in-process run) bit for bit.
"""

import concurrent.futures
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from onebit_tpu_torch.ckpt.native import load_native
from onebit_tpu_torch.kernels import bitlinear_sharded as bs
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.parallel.mesh import (DataGroup, Mesh2D, create_mesh,
                                            spawn_tp)
from onebit_tpu_torch.parallel.sharding import (gather_full, gather_params,
                                                kv_heads, mesh_layout,
                                                named_leaves, shard_params,
                                                unflatten)
from onebit_tpu_torch.train import run_kd as trun
from onebit_tpu_torch.train import trainer as tt
from onebit_tpu_torch.train.losses import IGNORE_INDEX, KDConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESHES = [(1, 2), (2, 2), (1, 4)]
TOL = 1e-5
SPAWN_TIMEOUT = 240
# every loss term on: the KL, the CE, the hidden states, the attention maps
KD = dict(kd_alpha=0.5, kd_beta=1.0, kd_gamma=0.5, kd_loss_scale=0.01)
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=5,
             grad_accum_steps=2, max_grad_norm=0.05)
STEPS = 3
BATCH, SEQ = 8, 16
RESUME_RUN = dict(batch_size=4, max_steps=4, save_steps=2, plot=False,
                  compute_dtype=torch.float32, mesh_shape=(2, 2))
# the command line's run, and the ranks' in-process run of the same
CLI_FLAGS = ["--batch-size", "1", "--max-steps", "2", "--save-steps", "1",
             "--warmup-steps", "1", "--kd-beta", "1.0", "--kd-loss-scale",
             "0.01"]
CLI_RUN = dict(batch_size=1, max_steps=2, save_steps=1, num_epochs=50,
               plot=False)
CLI_TRAIN = dict(warmup_steps=1)
# what a log line holds besides the clock
LOG_TIMES = ("elapsed_time", "remaining_time")
# an MLP width that four model ranks do not divide: gate, up and down stay
# whole on (1, 4)
ODD_MLP = dict(intermediate_size=762)


def _batches():
    """Three global batches whose labels hold ignored tokens unevenly
    across the data ranks' rows."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, 256, (BATCH, SEQ)).astype(np.int64)
        labels = ids.copy()
        labels[2:4, 3:] = IGNORE_INDEX
        labels[4:, :] = np.where(rng.random((BATCH - 4, SEQ)) < 0.3,
                                 IGNORE_INDEX, labels[4:, :])
        out.append({"input_ids": ids, "labels": labels})
    return out


def _np_tree(params):
    return {k: v.detach().cpu().numpy() for k, v in named_leaves(params)}


# ---------------------------------------------------------------------------
# What each rank runs (module level: the spawned ranks import it)
# ---------------------------------------------------------------------------

def _steps(cfg, student, teacher, mesh):
    """Three steps on ``mesh``: the metrics, the eval step's after them,
    the gathered params, the layout and the moments' shapes."""
    layout = mesh_layout(student, cfg, mesh.shape)
    t_layout = mesh_layout(teacher, cfg, mesh.shape)
    tcfg = tt.TrainConfig(**TRAIN)
    state = tt.init_train_state(shard_params(student, mesh, layout), tcfg)
    t_local = shard_params(teacher, mesh, t_layout)
    step = tt.make_sharded_train_step(cfg, KDConfig(**KD), tcfg, mesh,
                                      layout, t_layout,
                                      compute_dtype=torch.float32)
    metrics = []
    for batch in _batches():
        state, m = step(state, t_local, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "eval": {k: float(v) for k, v in step.eval_step(
                state.params, t_local, _batches()[0]).items()},
            "params": _np_tree(gather_params(state.params, layout, mesh)),
            "layout": layout._asdict(),
            "moment_shapes": [tuple(m.shape) for m in state.opt_state.mu]}


def _full_grads(cfg, student, teacher, mesh):
    """The first batch's gradients on ``mesh``, each leaf gathered whole,
    by native key."""
    layout = mesh_layout(student, cfg, mesh.shape)
    t_layout = mesh_layout(teacher, cfg, mesh.shape)
    tcfg = tt.TrainConfig(**TRAIN)
    state = tt.init_train_state(shard_params(student, mesh, layout), tcfg)
    step = tt.make_sharded_train_step(
        cfg, KDConfig(**KD), tcfg, mesh, layout, t_layout,
        compute_dtype=torch.float32)
    grads, _ = step.grads(state, shard_params(teacher, mesh, t_layout),
                          _batches()[0])
    out = {}
    for (key, _), g in zip(tt.named_trainable(state.params), grads):
        g = torch.stack(g) if isinstance(g, list) else g
        out[key] = gather_full(g, key, layout, mesh).numpy()
    return out


def _autograd_all_reduce(t, group):
    """The row-parallel edge's sum through torch's autograd all-reduce,
    whose backward sums the gradient over the ranks too."""
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, group=group.group)


def _model_mesh(mesh):
    """The mesh ``(1, m)`` of a rank's model group alone."""
    solo = DataGroup(None, 0, 1, mesh.device)
    return Mesh2D((1, mesh.model.size), mesh.model.rank, solo, mesh.model,
                  mesh.device)


def _odd_mlp():
    """tiny with the MLP width ODD_MLP, a plain teacher (seed 5) and its
    SVID start: ``(config, student, teacher)``, the same in every
    process."""
    from onebit_tpu_torch.core.build_start import build_start_params
    from onebit_tpu_torch.model.bitllama import init_params
    cfg = BitLlamaConfig.named("tiny", **ODD_MLP)
    teacher = init_params(cfg, torch.Generator().manual_seed(5),
                          mode="linear", device="cpu")
    return cfg, build_start_params(teacher), teacher


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(named_leaves(a), named_leaves(b)))


def _rank_main(tp_group, work):
    """Every scenario on one rank of four; returns numpy results."""
    torch.set_num_threads(1)
    cfg = BitLlamaConfig.named("tiny")
    student = load_native(work["student"], device="cpu")["params"]
    teacher = load_native(work["teacher"], device="cpu")["params"]
    mesh22 = create_mesh((2, 2), "cpu")
    meshes = {(1, 2): _model_mesh(mesh22), (2, 2): mesh22,
              (1, 4): create_mesh((1, 4), "cpu")}
    out = {shape: _steps(cfg, student, teacher, mesh)
           for shape, mesh in meshes.items()}
    out["odd_mlp"] = _steps(*_odd_mlp(), meshes[(1, 4)])

    # the row-parallel edge through an autograd all-reduce: mp x the
    # gradient upstream of it
    pair = meshes[(1, 2)]
    out["grads"] = _full_grads(cfg, student, teacher, pair)
    keep = bs.reduce_from_model
    bs.reduce_from_model = _autograd_all_reduce
    try:
        out["trap_grads"] = _full_grads(cfg, student, teacher, pair)
    finally:
        bs.reduce_from_model = keep
    # the LayerNorm statistics without their all-reduce in the backward:
    # each rank keeps its own share of their gradient
    keep = bs._SumStats.backward
    bs._SumStats.backward = staticmethod(lambda ctx, d: (d, None))
    try:
        out["local_stats_grads"] = _full_grads(cfg, student, teacher, pair)
    finally:
        bs._SumStats.backward = keep

    # run_kd on (2, 2): unbroken, and resumed from its step-2 state, as
    # train_state.pt and as DCP files
    blocks = np.load(work["blocks"])
    finals = {}
    for fmt in ("pt", "dcp"):
        kw = dict(RESUME_RUN, sharded_ckpt=fmt == "dcp")
        full = trun.run_kd(cfg, student, teacher, blocks,
                           kd_cfg=KDConfig(**KD),
                           run_cfg=trun.KDRunConfig(
                               output_dir=work[f"full_{fmt}"], **kw))
        resumed = trun.run_kd(
            cfg, student, teacher, blocks, kd_cfg=KDConfig(**KD),
            run_cfg=trun.KDRunConfig(
                output_dir=work[f"resumed_{fmt}"],
                resume_from=os.path.join(work[f"full_{fmt}"],
                                         "checkpoint-2"), **kw))
        out[f"resumed_step_{fmt}"] = resumed.step
        out[f"resume_same_{fmt}"] = _same_bits(full.params, resumed.params)
        finals[fmt] = full.params
    out["pt_dcp_same"] = _same_bits(finals["pt"], finals["dcp"])

    # the DCP state of (2, 2) read onto (1, 4): each rank its blocks there
    mesh14 = meshes[(1, 4)]
    layout14 = mesh_layout(student, cfg, (1, 4))
    template = tt.init_train_state(shard_params(student, mesh14, layout14),
                                   tt.TrainConfig())
    state = trun.load_train_state(
        os.path.join(work["full_dcp"], "checkpoint-2"), template,
        mesh=mesh14, layout=layout14)
    split = trun.state_split(state, layout14)
    out["dcp_on_1x4"] = {k: gather_full(v, k, split, mesh14).numpy()
                         for k, v in tt.state_tensors(state).items()}

    # the in-process twin of the command line's run: each rank pair a
    # mesh (1, 2), the pair of data index i writing in_process_i
    trun.run_kd(cfg, student, teacher, blocks,
                kd_cfg=KDConfig(kd_beta=1.0, kd_loss_scale=0.01),
                train_cfg=tt.TrainConfig(**CLI_TRAIN),
                run_cfg=trun.KDRunConfig(
                    output_dir=f"{work['in_process']}_{mesh22.data.rank}",
                    **CLI_RUN), mesh=pair)
    return out


def run_kd_rank(tp_group, student_dir, teacher_dir, blocks_path, kd, run):
    """One rank of a ``run_kd`` from native checkpoints on the spawn's
    process group (``tests/test_torch_train_cli.py`` runs a mesh
    ``(1, 2)`` with it); rank 0 writes ``final/``."""
    torch.set_num_threads(1)
    student = load_native(student_dir, device="cpu")
    teacher = load_native(teacher_dir, device="cpu")["params"]
    state = trun.run_kd(student["config"], student["params"], teacher,
                        np.load(blocks_path), kd_cfg=KDConfig(**kd),
                        run_cfg=trun.KDRunConfig(**run))
    return state.step


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the ranks take: the parallel workers of the
    suite would otherwise oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A tiny plain teacher (``init_params``, seed 4) and its SVID start as
    native checkpoints, which both packages read; the token blocks; the
    ranks' output directories."""
    from onebit_tpu_torch.ckpt.native import save_native
    from onebit_tpu_torch.core.build_start import build_start_params
    from onebit_tpu_torch.model.bitllama import init_params
    d = tmp_path_factory.mktemp("tp_train")
    config = BitLlamaConfig.named("tiny")
    teacher = init_params(config, torch.Generator().manual_seed(4),
                          mode="linear", device="cpu")
    save_native(str(d / "teacher"), config, teacher)
    save_native(str(d / "student"), config, build_start_params(teacher))
    blocks = np.random.default_rng(1).integers(0, config.vocab_size,
                                               (12, 32))
    np.save(d / "blocks.npy", blocks.astype(np.int32))
    paths = {k: str(d / k) for k in ("student", "teacher", "full_pt",
                                     "full_dcp", "resumed_pt",
                                     "resumed_dcp", "in_process", "cli")}
    paths["blocks"] = str(d / "blocks.npy")
    return paths


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def _launched(work):
    """The spawn of the four ranks on a thread and the command line's two
    processes, started together so that JAX's side (:func:`jax_steps`)
    computes while they run."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", "onebit_tpu_torch", "train", "--student",
           work["student"], "--teacher", work["teacher"], "--tokens",
           work["blocks"], "--output-dir", work["cli"], *CLI_FLAGS,
           "--device", "cpu", "--coordinator", f"127.0.0.1:{_free_port()}",
           "--num-processes", "2"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            yield pool.submit(spawn_tp, _rank_main, WORLD, backend="gloo",
                              device="cpu", timeout=SPAWN_TIMEOUT,
                              args=(work,)), procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(_launched):
    """The four ranks' results of every scenario, from one spawn."""
    return _launched[0].result()


@pytest.fixture(scope="module")
def jax_steps(work):
    """JAX's make_train_step on ``shard_params(..., create_mesh(shape))``
    for each of MESHES, on threads: the metrics of each step and the
    final latent, g and h."""
    import jax
    import jax.numpy as jnp

    from onebit_tpu.ckpt.writer import load_native as jload
    from onebit_tpu.parallel.mesh import create_mesh as jmesh
    from onebit_tpu.parallel.sharding import shard_params as jshard
    from onebit_tpu.train import trainer as jt
    from onebit_tpu.train.losses import KDConfig as JKD

    def run(shape):
        mesh = jmesh(shape)
        loaded = jload(work["student"])
        student = jshard(loaded["params"], mesh)
        teacher = jshard(jload(work["teacher"])["params"], mesh)
        tcfg = jt.TrainConfig(**TRAIN)
        state = jt.init_train_state(student, tcfg)
        step = jt.make_train_step(loaded["config"], JKD(**KD), tcfg,
                                  compute_dtype=jnp.float32, donate=False)
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("data"))
        metrics = []
        for batch in _batches():
            batch = {k: jax.device_put(jnp.asarray(v, jnp.int32), sharding)
                     for k, v in batch.items()}
            state, m = step(state, teacher, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        layers = state.params["layers"]
        params = {f"layers.{n}.{f}": np.asarray(getattr(layers[n], f))
                  for n in layers if hasattr(layers[n], "_fields")
                  for f in ("latent", "weight_scale", "input_factor")}
        return metrics, params

    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        return dict(zip(MESHES, pool.map(run, MESHES)))


@pytest.fixture(scope="module")
def one_device(work):
    """The one-device step's gradients of the first batch, by key."""
    cfg = BitLlamaConfig.named("tiny")
    student = load_native(work["student"], device="cpu")["params"]
    teacher = load_native(work["teacher"], device="cpu")["params"]
    tcfg = tt.TrainConfig(**TRAIN)
    state = tt.init_train_state(student, tcfg)
    step = tt.make_train_step(cfg, KDConfig(**KD), tcfg,
                              compute_dtype=torch.float32)
    grads, _ = step.grads(state, teacher, _batches()[0])
    return {k: g.numpy() for (k, _), g in
            zip(tt.named_trainable(state.params), grads)}


# ---------------------------------------------------------------------------
# The tensor-parallel step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2", "1x4"])
def test_tp_step_matches_jax(_launched, jax_steps, ranks, shape):
    """Three steps of AdamW with clipping (every step's global norm is past
    0.05) and two micro-batches, every KD term on: each step's global
    metrics (the same on every rank) and the final params equal JAX's
    sharded step's on the same mesh within 1e-5."""
    want_metrics, want = jax_steps[shape]
    got = ranks[0][shape]
    for r in ranks[1:]:
        assert r[shape]["metrics"] == got["metrics"]
    for step, (m, exp) in enumerate(zip(got["metrics"], want_metrics)):
        assert sorted(m) == sorted(exp)
        for k, v in exp.items():
            np.testing.assert_allclose(m[k], v, rtol=TOL,
                                       err_msg=f"step {step} {k}")
    assert all(m["grad_norm"] > TRAIN["max_grad_norm"]
               for m in want_metrics)
    for key, w in want.items():
        a = got["params"][key]
        if key.endswith("latent"):
            assert np.linalg.norm(a - w) <= TOL * np.linalg.norm(w), key
        else:
            assert np.abs(a - w).max() <= TOL * np.abs(w).max(), key
    for r in ranks[1:]:
        for key, arr in r[shape]["params"].items():
            assert arr.tobytes() == got["params"][key].tobytes(), key


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2", "1x4"])
def test_tp_eval_step(ranks, work, shape):
    """The eval step's global metrics of a whole batch after the three
    steps equal the one-device ``make_eval_step``'s on the gathered params
    within 1e-5."""
    got = ranks[0][shape]
    params = unflatten({k: torch.from_numpy(v)
                        for k, v in got["params"].items()})
    teacher = load_native(work["teacher"], device="cpu")["params"]
    evaluate = tt.make_eval_step(BitLlamaConfig.named("tiny"),
                                 KDConfig(**KD), tt.TrainConfig(**TRAIN),
                                 compute_dtype=torch.float32)
    want = evaluate(params, teacher, _batches()[0])
    assert sorted(got["eval"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["eval"][k], float(v), rtol=TOL,
                                   err_msg=k)


def test_tp_layout(ranks):
    """Column-parallel leaves split their out-features over the model
    ranks (g whole), row-parallel ones their in-features (h whole), the
    vocabulary is split, the norms are whole; on (2, 2) the data ranks
    split each model shard again; on (1, 4) the two KV heads do not divide,
    so k and v stay whole; each rank's moments have its shards' shapes."""
    cfg = BitLlamaConfig.named("tiny")
    L, d, inter = (cfg.num_hidden_layers, cfg.hidden_size,
                   cfg.intermediate_size)
    model = ranks[0][(2, 2)]["layout"]["model"]
    data = ranks[0][(2, 2)]["layout"]["data"]
    assert model["embed_tokens"] == model["lm_head"] == 0
    for name in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
        assert model[f"layers.{name}.latent"] == 1
        assert model[f"layers.{name}.weight_scale"] == 1
        assert f"layers.{name}.input_factor" not in model
    for name in ("o_proj", "down_proj"):
        assert model[f"layers.{name}.latent"] == 2
        assert model[f"layers.{name}.input_factor"] == 1
        assert f"layers.{name}.weight_scale" not in model
    assert not any("layernorm" in k or k == "final_norm" for k in model)
    assert data["layers.q_proj.latent"] == data["layers.down_proj.latent"] == 1
    shapes = ranks[0][(2, 2)]["moment_shapes"]
    assert (L, d // 4, d) in shapes and (L, d // 2, inter // 2) in shapes
    wide = ranks[0][(1, 4)]["layout"]["model"]
    assert "layers.k_proj.latent" not in wide
    assert wide["layers.q_proj.latent"] == 1


@pytest.mark.parametrize("shape, rank, want", [
    ((4, 2, 4), 0, [0]), ((4, 2, 4), 3, [1]), ((4, 2, 2), 1, [1]),
    ((8, 2, 4), 1, [0]), ((6, 3, 2), 0, [0, 0, 1]),
    ((6, 3, 2), 1, [1, 2, 2])], ids=str)
def test_kv_heads(shape, rank, want):
    """The KV heads a model rank's query heads attend where k and v stay
    whole: each once when the rank's query heads are whole groups, else one
    a query head."""
    nh, nkv, m = shape
    cfg = BitLlamaConfig(hidden_size=64 * nh, num_attention_heads=nh,
                         num_key_value_heads=nkv)
    assert kv_heads(cfg, m, rank) == want


def test_tp_step_whole_mlp(ranks):
    """Where the MLP's width does not divide by the model axis (762 over
    (1, 4)), gate, up and down stay whole and every rank runs the whole
    MLP (JAX's ``_shardable`` replicates them): three steps' metrics and
    params equal the one-device step's within 1e-5 (that step is held to
    JAX's in tests/test_torch_train.py)."""
    got = ranks[0]["odd_mlp"]
    model = got["layout"]["model"]
    assert not any(f"layers.{n}." in k for k in model
                   for n in ("gate_proj", "up_proj", "down_proj"))
    assert model["layers.q_proj.latent"] == 1
    cfg, student, teacher = _odd_mlp()
    tcfg = tt.TrainConfig(**TRAIN)
    state = tt.init_train_state(student, tcfg)
    step = tt.make_train_step(cfg, KDConfig(**KD), tcfg,
                              compute_dtype=torch.float32)
    for i, batch in enumerate(_batches()):
        state, m = step(state, teacher, batch)
        for k, v in m.items():
            np.testing.assert_allclose(got["metrics"][i][k], float(v),
                                       rtol=TOL, err_msg=f"step {i} {k}")
    for key, w in _np_tree(state.params).items():
        a = got["params"][key]
        if key.endswith("latent"):
            assert np.linalg.norm(a - w) <= TOL * np.linalg.norm(w), key
        else:
            assert np.abs(a - w).max() <= TOL * np.abs(w).max(), key
    for r in ranks[1:]:
        assert r["odd_mlp"]["metrics"] == got["metrics"]


def _worst(grads, one_device) -> float:
    """The largest error of any leaf's gradient, relative to the leaf's
    largest one-device gradient."""
    assert sorted(grads) == sorted(one_device)
    return max(np.abs(grads[k] - w).max() / np.abs(w).max()
               for k, w in one_device.items())


def test_tp_grads_match_one_device(ranks, one_device):
    """On (1, 2) the gradients equal the one-device step's within 1e-5 of
    each leaf's largest."""
    assert _worst(ranks[0]["grads"], one_device) <= TOL


@pytest.mark.parametrize("fault, floor", [
    ("trap_grads", 0.5), ("local_stats_grads", 1000 * TOL)],
    ids=["row_edge_autograd_all_reduce", "stats_without_all_reduce"])
def test_collective_backward_faults(ranks, one_device, fault, floor):
    """On (1, 2) a wrong backward of a collective takes the gradients out
    of the 1e-5 tolerance: torch's autograd all-reduce on the row-parallel
    edge (whose backward sums what every rank already holds whole, giving
    twice the gradient upstream of it), and the column-parallel LayerNorm
    statistics' backward without its all-reduce (each rank's share of
    their gradient kept to itself; the card's bf16 limit sees that one
    only narrowly)."""
    assert _worst(ranks[0][fault], one_device) > floor


@pytest.mark.parametrize("fmt", ["pt", "dcp"])
def test_tp_resume_is_exact(ranks, work, fmt):
    """run_kd on (2, 2): a run resumed from its step-2 state ends where the
    unbroken run ends, bit for bit, from ``train_state.pt`` (gathered over
    both axes: the full shapes a one-device run writes) and from DCP
    files; both unbroken runs end on the same bits."""
    for out in ranks:
        assert out[f"resumed_step_{fmt}"] == 4
        assert out[f"resume_same_{fmt}"] and out["pt_dcp_same"]
    ck = os.path.join(work[f"full_{fmt}"], "checkpoint-2")
    assert os.listdir(ck) == [trun.STATE_FILE if fmt == "pt"
                              else trun.STATE_DIR]
    if fmt == "pt":
        saved = torch.load(os.path.join(ck, trun.STATE_FILE),
                           weights_only=True)
        student = load_native(work["student"], device="cpu")["params"]
        for key, leaf in named_leaves(student):
            assert saved[f"params.{key}"].shape == leaf.shape, key
        trainable = [leaf for _, leaf in tt.named_trainable(student)]
        assert [saved[f"mu.{i}"].shape for i in range(len(trainable))] == \
            [leaf.shape for leaf in trainable]


def test_dcp_state_onto_another_mesh(ranks, work):
    """The DCP state that (2, 2) wrote reads onto (1, 4), whose layout
    differs (k and v whole): the blocks each rank reads, gathered, are the
    state that the same run wrote as ``train_state.pt``, bit for bit."""
    saved = torch.load(os.path.join(work["full_pt"], "checkpoint-2",
                                    trun.STATE_FILE), weights_only=True)
    got = ranks[0]["dcp_on_1x4"]
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert got[k].tobytes() == v.numpy().tobytes(), k


@pytest.mark.timeout(240)
def test_two_process_cli_train_on_model_axis(_launched, ranks, work):
    """``train --batch-size 1`` as two OS processes (``--coordinator``)
    picks JAX's mesh ``(gcd(2, 1), 2) = (1, 2)``: tensor-parallel
    training. Rank 0 alone writes the log, whose lines equal the
    in-process run's on the same mesh but for the clock, and ``final/``,
    whose params equal that run's bit for bit."""
    procs = _launched[1]
    for p in procs:
        _, err = p.communicate(timeout=200)
        assert p.returncode == 0, err[-3000:]

    def log(path):
        with open(os.path.join(path, "trainer_log.jsonl")) as f:
            return [{k: v for k, v in json.loads(line).items()
                     if k not in LOG_TIMES} for line in f]
    want = os.path.join(f"{work['in_process']}_0")
    assert log(work["cli"]) == log(want)
    assert [e["current_steps"] for e in log(work["cli"])] == [2]
    with np.load(os.path.join(work["cli"], "final", "params.npz")) as a, \
            np.load(os.path.join(want, "final", "params.npz")) as b:
        assert a.files == b.files
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)
