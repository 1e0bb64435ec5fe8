"""Fully sharded data-parallel KD training, sharded checkpoints and the
multi-host ``train`` of the port, against the JAX package on the CPU.

One spawn of two gloo ranks (``parallel/mesh.py`` ``spawn_tp``) runs every
scenario that needs a group, in a module fixture, and each test asserts on
its part of the result; one launch of ``python -m onebit_tpu_torch train``
as two OS processes is the module's other launch. This module imports only
torch, numpy and the port at its top, so the ranks never load JAX; the JAX
package is imported inside fixtures and tests.

Tolerances: the sharded step's losses and params against JAX's sharded
step to 1e-5 relative (``tests/test_torch_train_cli.py``'s TOL: the
latent planes in norm, g and h element by element); the ranks' own
reruns (resume, the command line against the in-process run, checkpoint
reads) bit for bit.
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

from onebit_tpu_torch.ckpt import sharded as tsh
from onebit_tpu_torch.ckpt.native import load_native
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.parallel.mesh import create_mesh, spawn_tp
from onebit_tpu_torch.parallel.sharding import (block, gather_params,
                                                mesh_layout, named_leaves,
                                                shard_params, unflatten)
from onebit_tpu_torch.train import run_kd as trun
from onebit_tpu_torch.train import trainer as tt
from onebit_tpu_torch.train.losses import IGNORE_INDEX, KDConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2
TOL = 1e-5
SPAWN_TIMEOUT = 240
KD = dict(kd_beta=1.0, kd_loss_scale=0.01)
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=5,
             grad_accum_steps=2, max_grad_norm=0.05)
STEPS = 3
BATCH, SEQ = 8, 16
# the command line's run, and the ranks' in-process run of the same
CLI_FLAGS = ["--batch-size", "4", "--max-steps", "2", "--save-steps", "1",
             "--warmup-steps", "1", "--kd-beta", "1.0", "--kd-loss-scale",
             "0.01"]
CLI_RUN = dict(batch_size=4, max_steps=2, save_steps=1, num_epochs=50,
               plot=False)
CLI_TRAIN = dict(warmup_steps=1)


def _batches():
    """Three global batches whose labels hold ignored tokens unevenly
    across the two ranks' rows (rank 1's rows of micro-batch 0 mostly
    ignored, rank 0's none)."""
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

def _rank_main(tp_group, work):
    """Every scenario on one rank; returns numpy results."""
    torch.set_num_threads(1)
    mesh = create_mesh((N, 1), "cpu")
    out = {}
    cfg = BitLlamaConfig.named("tiny")
    student = load_native(work["student"], device="cpu")["params"]
    teacher = load_native(work["teacher"], device="cpu")["params"]

    # the sharded step: 3 steps of AdamW with clipping and accumulation
    layout = mesh_layout(student, cfg, mesh.shape)
    t_layout = mesh_layout(teacher, cfg, mesh.shape)
    state = tt.init_train_state(shard_params(student, mesh, layout),
                                tt.TrainConfig(**TRAIN))
    step = tt.make_sharded_train_step(
        cfg, KDConfig(**KD), tt.TrainConfig(**TRAIN), mesh, layout,
        t_layout, compute_dtype=torch.float32)
    t_local = shard_params(teacher, mesh, t_layout)
    metrics = []
    for batch in _batches():
        state, m = step(state, t_local, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    out["metrics"] = metrics
    out["eval"] = {k: float(v) for k, v in step.eval_step(
        state.params, t_local, _batches()[0]).items()}
    out["params"] = _np_tree(gather_params(state.params, layout, mesh))
    out["moment_shapes"] = [tuple(m.shape) for m in state.opt_state.mu]
    out["layout"] = layout.data
    out["model_layout"] = layout.model

    # a sharded checkpoint written from the ranks' shards, and one written
    # on the host read into the ranks' shards
    tsh.save_sharded(work["from_ranks"], cfg, state.params, mesh=mesh,
                     layout=layout)
    back = tsh.load_sharded(work["from_ranks"], mesh=mesh)
    out["reread_same"] = all(
        torch.equal(a, b) for (_, a), (_, b) in
        zip(named_leaves(back["params"]), named_leaves(state.params)))
    host = tsh.load_sharded(work["from_host"], mesh=mesh)
    out["host_blocks"] = _np_tree(host["params"])
    out["host_layout"] = host["layout"].data

    # run_kd: unbroken, resumed from its sharded step-2 state, and the
    # command line's run in process
    kw = dict(batch_size=4, max_steps=4, save_steps=2, plot=False,
              compute_dtype=torch.float32, sharded_ckpt=True)
    blocks = np.load(work["blocks"])
    full = trun.run_kd(cfg, student, teacher, blocks, kd_cfg=KDConfig(**KD),
                       run_cfg=trun.KDRunConfig(output_dir=work["full"],
                                                **kw))
    resumed = trun.run_kd(
        cfg, student, teacher, blocks, kd_cfg=KDConfig(**KD),
        run_cfg=trun.KDRunConfig(
            output_dir=work["resumed"],
            resume_from=os.path.join(work["full"], "checkpoint-2"), **kw))
    out["resumed_step"] = resumed.step
    out["resume_same"] = all(
        torch.equal(a, b) for (_, a), (_, b) in
        zip(named_leaves(full.params), named_leaves(resumed.params)))
    trun.run_kd(cfg, student, teacher, blocks,
                kd_cfg=KDConfig(kd_beta=1.0, kd_loss_scale=0.01),
                train_cfg=tt.TrainConfig(**CLI_TRAIN),
                run_cfg=trun.KDRunConfig(output_dir=work["in_process"],
                                         **CLI_RUN))
    return out


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
    native checkpoints, which both packages read; the token blocks; a
    host-written sharded checkpoint of the start; the ranks' output
    directories."""
    from onebit_tpu_torch.ckpt.native import save_native
    from onebit_tpu_torch.core.build_start import build_start_params
    from onebit_tpu_torch.model.bitllama import init_params
    d = tmp_path_factory.mktemp("parallel")
    config = BitLlamaConfig.named("tiny")
    teacher = init_params(config, torch.Generator().manual_seed(4),
                          mode="linear", device="cpu")
    student = build_start_params(teacher)
    save_native(str(d / "teacher"), config, teacher)
    save_native(str(d / "student"), config, student)
    blocks = np.random.default_rng(1).integers(0, config.vocab_size,
                                               (12, 32))
    np.save(d / "blocks.npy", blocks.astype(np.int32))
    tsh.save_sharded(str(d / "from_host"), config,
                     load_native(str(d / "student"), device="cpu")["params"])
    paths = {k: str(d / k) for k in ("student", "teacher", "from_host",
                                     "from_ranks", "full", "resumed",
                                     "in_process", "cli")}
    paths["blocks"] = str(d / "blocks.npy")
    return paths


@pytest.fixture(scope="module")
def _spawned(work):
    """The spawn of the two ranks, started on a thread so that JAX's side
    (:func:`jax_sharded`) computes while the ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn_tp, _rank_main, N, backend="gloo",
                          device="cpu", timeout=SPAWN_TIMEOUT, args=(work,))


@pytest.fixture(scope="module")
def ranks(_spawned):
    """Both ranks' results of every scenario, from one spawn."""
    return _spawned.result()


@pytest.fixture(scope="module")
def jax_sharded(work):
    """JAX's make_train_step on ``shard_params(..., create_mesh((2, 1)))``:
    the metrics of each step and the final params."""
    import jax
    import jax.numpy as jnp

    from onebit_tpu.ckpt.writer import load_native as jload
    from onebit_tpu.parallel.mesh import create_mesh
    from onebit_tpu.parallel.sharding import shard_params as jshard
    from onebit_tpu.train import trainer as jt
    from onebit_tpu.train.losses import KDConfig as JKD
    mesh = create_mesh((N, 1))
    student = jshard(jload(work["student"])["params"], mesh)
    teacher = jshard(jload(work["teacher"])["params"], mesh)
    tcfg = jt.TrainConfig(**TRAIN)
    state = jt.init_train_state(student, tcfg)
    step = jt.make_train_step(jload(work["student"])["config"], JKD(**KD),
                              tcfg, compute_dtype=jnp.float32, donate=False)
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


# ---------------------------------------------------------------------------
# The sharded step against JAX's
# ---------------------------------------------------------------------------

def test_sharded_step_matches_jax(_spawned, jax_sharded, ranks):
    """Two ranks, three steps of AdamW with clipping (every step's global
    norm is past 0.05) and two micro-batches, labels ignored unevenly
    across the ranks: each step's global metrics (the same on both ranks)
    and the final params equal JAX's sharded step's within 1e-5."""
    want_metrics, want = jax_sharded
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for got, exp in zip(ranks[0]["metrics"], want_metrics):
        assert sorted(got) == sorted(exp)
        for k, v in exp.items():
            np.testing.assert_allclose(got[k], v, rtol=TOL, err_msg=k)
    assert all(m["grad_norm"] > TRAIN["max_grad_norm"]
               for m in want_metrics[1:])
    params = ranks[0]["params"]
    for key, w in want.items():
        a = params[key]
        if key.endswith("latent"):
            assert np.linalg.norm(a - w) <= TOL * np.linalg.norm(w), key
        else:
            assert np.abs(a - w).max() <= TOL * np.abs(w).max(), key
    for key, arr in ranks[1]["params"].items():
        assert arr.tobytes() == params[key].tobytes()


def test_sharded_eval_step(ranks, work):
    """The sharded eval step's global metrics of a whole batch (after the
    three steps) equal the one-device ``make_eval_step``'s on the gathered
    params within 1e-5 (that step is held to JAX's in
    tests/test_torch_train.py)."""
    params = unflatten({k: torch.from_numpy(v)
                        for k, v in ranks[0]["params"].items()})
    teacher = load_native(work["teacher"], device="cpu")["params"]
    evaluate = tt.make_eval_step(BitLlamaConfig.named("tiny"),
                                 KDConfig(**KD), tt.TrainConfig(**TRAIN),
                                 compute_dtype=torch.float32)
    want = evaluate(params, teacher, _batches()[0])
    assert ranks[0]["eval"] == ranks[1]["eval"]
    assert sorted(ranks[0]["eval"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0]["eval"][k], float(v), rtol=TOL,
                                   err_msg=k)


def test_layout_and_sharded_moments(ranks):
    """Every latent plane, the embedding and the lm_head are split over the
    two ranks (the vectors stay whole), and each rank's moments have its
    shards' shapes: the moments are sharded as the params are."""
    layout = ranks[0]["layout"]
    assert not ranks[0]["model_layout"]
    assert layout["embed_tokens"] == layout["lm_head"] == 0
    assert all(layout[f"layers.{n}.latent"] == 1 for n in
               ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj"))
    assert not any(k.endswith(("weight_scale", "input_factor",
                               "layernorm")) for k in layout)
    cfg = BitLlamaConfig.named("tiny")
    d = cfg.hidden_size
    assert (cfg.num_hidden_layers, d // N, d) in ranks[0]["moment_shapes"]


# ---------------------------------------------------------------------------
# Sharded checkpoints
# ---------------------------------------------------------------------------

def test_sharded_ckpt_round_trips(work, ranks):
    """On the host: what ``save_sharded`` wrote loads back bit for bit,
    with ``dtype_override`` as bf16 floats (int words untouched); into two
    ranks' shards: each rank reads its blocks of a host-written checkpoint
    and re-reads what the ranks wrote, bit for bit."""
    want = load_native(work["student"], device="cpu")
    assert tsh.is_sharded_ckpt(work["from_host"])
    got = tsh.load_sharded(work["from_host"], device="cpu")
    assert got["config"] == want["config"]
    for (k, a), (_, b) in zip(named_leaves(got["params"]),
                              named_leaves(want["params"])):
        assert torch.equal(a, b), k
    low = tsh.load_sharded(work["from_host"], device="cpu",
                           dtype_override=torch.bfloat16)
    assert low["params"]["embed_tokens"].dtype == torch.bfloat16
    assert low["params"]["layers"]["q_proj"].latent.dtype == torch.bfloat16
    full = _np_tree(want["params"])
    for r, out in enumerate(ranks):
        assert out["reread_same"]
        layout = out["host_layout"]
        for key, arr in out["host_blocks"].items():
            exp = full[key] if key not in layout else block(
                torch.from_numpy(full[key]), layout[key], N, r,
                "cpu").numpy()
            assert arr.tobytes() == exp.tobytes(), key
    # what the ranks wrote reads on the host as the gathered params
    host = _np_tree(tsh.load_sharded(work["from_ranks"],
                                     device="cpu")["params"])
    for key, arr in ranks[0]["params"].items():
        assert host[key].tobytes() == arr.tobytes(), key


def test_sharded_resume_is_exact(ranks, work):
    """run_kd on two ranks with ``sharded_ckpt``: a run resumed from its
    step-2 state (DCP files, each rank's blocks) ends where the unbroken run
    ends, bit for bit; the state directory holds no ``train_state.pt``."""
    for out in ranks:
        assert out["resumed_step"] == 4 and out["resume_same"]
    ck = os.path.join(work["full"], "checkpoint-2")
    assert os.listdir(ck) == [trun.STATE_DIR]


def test_convert_sharded_then_generate(work, tmp_path, capsys):
    """``convert --format sharded`` packs a checkpoint as the native format
    does, and ``generate`` from it gives the native checkpoint's tokens."""
    from onebit_tpu_torch import cli
    args = ["--device", "cpu"]
    cli.main(["convert", work["student"], str(tmp_path / "sharded"),
              "--format", "sharded", *args])
    cli.main(["convert", work["student"], str(tmp_path / "native"), *args])
    capsys.readouterr()
    gen = ["--prompt", "1,2,3", "--greedy", "--max-new-tokens", "6", *args]
    cli.main(["generate", "--ckpt", str(tmp_path / "sharded"), *gen])
    got = capsys.readouterr().out
    cli.main(["generate", "--ckpt", str(tmp_path / "native"), *gen])
    assert got == capsys.readouterr().out
    assert len(got.strip().split(",")) == 6


# ---------------------------------------------------------------------------
# Multi-host train: two OS processes
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(240)
def test_two_process_cli_train(work, ranks):
    """``train --coordinator HOST:PORT --num-processes 2 --process-id i``
    as two OS processes: rank 0 alone writes the log (one line for the
    one logged step, where two writers would leave two), the checkpoints
    and ``final/``, whose params equal the ranks' in-process run's, bit
    for bit."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    coord = f"127.0.0.1:{_free_port()}"
    cmd = [sys.executable, "-m", "onebit_tpu_torch", "train", "--student",
           work["student"], "--teacher", work["teacher"], "--tokens",
           work["blocks"], "--output-dir", work["cli"], *CLI_FLAGS,
           "--device", "cpu", "--coordinator", coord, "--num-processes",
           "2"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=200))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    with open(os.path.join(work["cli"], "trainer_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [e["current_steps"] for e in log] == [2]
    assert sorted(n for n in os.listdir(work["cli"])
                  if n.startswith("checkpoint-")) == ["checkpoint-1",
                                                      "checkpoint-2"]
    with np.load(os.path.join(work["cli"], "final", "params.npz")) as a, \
            np.load(os.path.join(work["in_process"], "final",
                                 "params.npz")) as b:
        assert a.files == b.files
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)
