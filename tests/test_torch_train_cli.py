"""The port's training driver and command line against the JAX package on
the CPU: ``run_kd`` against the JAX ``run_kd`` on the same token blocks and
seed (final params, the log, checkpoint rotation, held-out evaluation),
resume, and ``python -m onebit_tpu_torch build-start-ckpt | train |
convert --device cpu`` on native checkpoints the JAX writer made.

Tolerances as in tests/test_torch_train.py: metrics to 1e-5 relative,
trainable leaves to 1e-5 in norm (g and h element by element), frozen
leaves bit-equal.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.ckpt.writer import load_native as jload
from onebit_tpu.ckpt.writer import save_native as jsave
from onebit_tpu.cli import main as jmain
from onebit_tpu.core.build_start import build_start_params as jbuild
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu.train import run_kd as jrun
from onebit_tpu.train.losses import KDConfig as JKD
from onebit_tpu.train.trainer import TrainConfig as JTC
from onebit_tpu_torch import load_native, save_native
from onebit_tpu_torch.convert import params_from_jax, params_to_numpy
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.train import run_kd as trun
from onebit_tpu_torch.train.losses import KDConfig
from onebit_tpu_torch.train.trainer import TrainConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
KD = dict(kd_beta=1.0, kd_loss_scale=0.01)


@pytest.fixture(scope="module")
def models():
    jc = JaxConfig.named("tiny")
    teacher = jb.init_params(jc, jax.random.PRNGKey(4), mode="linear")
    student = jbuild(teacher)
    blocks = np.random.default_rng(1).integers(0, jc.vocab_size, (12, 32)
                                               ).astype(np.int32)
    return jc, teacher, student, BitLlamaConfig.named("tiny"), blocks


def _port(tree, c):
    return params_from_jax(jax.tree.map(np.asarray, tree), c, device="cpu")


def _log(path):
    with open(os.path.join(path, "trainer_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ckpts(path):
    return sorted(n for n in os.listdir(path) if n.startswith("checkpoint-"))


def _same_params(got, want, start):
    """got, want, start: JAX-shaped trees of numpy arrays."""
    for name in jb.PROJ_NAMES:
        for field in ("latent", "weight_scale", "input_factor"):
            a, w = got["layers"][name][field], want["layers"][name][field]
            assert np.linalg.norm(a - w) <= TOL * np.linalg.norm(w), field
            if field != "latent":
                top = np.abs(w).max()
                assert np.abs(a - w).max() <= TOL * top, field
    for key in ("embed_tokens", "lm_head", "final_norm"):
        assert got[key].tobytes() == start[key].tobytes()


def _tree(jtree):
    """A JAX params tree as {..., "layers": {name: {field: array}}}."""
    out = {k: np.asarray(v) for k, v in jtree.items() if k != "layers"}
    out["layers"] = {
        n: ({f: np.asarray(a) for f, a in v._asdict().items()
             if a is not None} if hasattr(v, "_asdict") else np.asarray(v))
        for n, v in jtree["layers"].items()}
    return out


def test_run_kd_matches_jax(models, tmp_path):
    """Four fp32 steps at batch 2 with a held-out split (val_split 0.25),
    checkpoints every 2 steps keeping the newest one: the same log lines
    (keys and losses), the same checkpoint left, the same final params
    (the native ``final/`` checkpoint, read by the JAX reader)."""
    jc, teacher, student, c, blocks = models
    common = dict(batch_size=2, max_steps=4, log_steps=1, save_steps=2,
                  save_total_limit=1, val_split=0.25, plot=False, seed=3)
    jrun.run_kd(jc, student, teacher, blocks, kd_cfg=JKD(**KD),
                train_cfg=JTC(learning_rate=1e-3),
                run_cfg=jrun.KDRunConfig(output_dir=str(tmp_path / "jax"),
                                         compute_dtype=jnp.float32,
                                         mesh_shape=(1, 1), **common))
    state = trun.run_kd(c, _port(student, c), _port(teacher, c), blocks,
                        kd_cfg=KDConfig(**KD),
                        train_cfg=TrainConfig(learning_rate=1e-3),
                        run_cfg=trun.KDRunConfig(
                            output_dir=str(tmp_path / "port"),
                            compute_dtype=torch.float32, **common))
    assert state.step == 4
    jlog, tlog = _log(tmp_path / "jax"), _log(tmp_path / "port")
    assert [sorted(e) for e in tlog] == [sorted(e) for e in jlog]
    assert any("eval_loss" in e for e in tlog)
    for a, w in zip(tlog, jlog):
        for k, v in w.items():
            if isinstance(v, float) and k not in ("epoch", "percentage"):
                np.testing.assert_allclose(a[k], v, rtol=TOL, err_msg=k)
    assert _ckpts(tmp_path / "port") == _ckpts(tmp_path / "jax") == \
        ["checkpoint-4"]
    got = _tree(jload(str(tmp_path / "port" / "final"))["params"])
    want = _tree(jload(str(tmp_path / "jax" / "final"))["params"])
    _same_params(got, want, _tree(student))
    _same_params(params_to_numpy(state.params), want, _tree(student))


def test_run_kd_resume_and_one_device(models, tmp_path):
    """A run resumed from its step-2 state ends where the unbroken run
    ends, bit for bit; a mesh of several devices and sharded states raise
    naming ROADMAP.md §1 item 8, the rest of parallelism."""
    jc, teacher, student, c, blocks = models
    kw = dict(batch_size=2, max_steps=4, save_steps=2, plot=False,
              compute_dtype=torch.float32)
    full = trun.run_kd(c, _port(student, c), _port(teacher, c), blocks,
                       kd_cfg=KDConfig(**KD),
                       run_cfg=trun.KDRunConfig(
                           output_dir=str(tmp_path / "a"), **kw))
    assert _ckpts(tmp_path / "a") == ["checkpoint-2", "checkpoint-4"]
    resumed = trun.run_kd(c, _port(student, c), _port(teacher, c), blocks,
                          kd_cfg=KDConfig(**KD),
                          run_cfg=trun.KDRunConfig(
                              output_dir=str(tmp_path / "b"),
                              resume_from=str(tmp_path / "a" /
                                              "checkpoint-2"), **kw))
    assert resumed.step == 4 and resumed.opt_state.count == 4
    a, b = params_to_numpy(full.params), params_to_numpy(resumed.params)
    for name in jb.PROJ_NAMES:
        for field, arr in a["layers"][name].items():
            assert arr.tobytes() == b["layers"][name][field].tobytes()
    for bad in (dict(mesh_shape=(2, 1)), dict(sharded_ckpt=True)):
        with pytest.raises(NotImplementedError, match="item 8"):
            trun.run_kd(c, _port(student, c), _port(teacher, c), blocks,
                        run_cfg=trun.KDRunConfig(
                            output_dir=str(tmp_path / "c"), **bad))


def test_output_dir_clobber_protection(models, tmp_path):
    """An output dir that holds the port's resume file needs resume_from;
    run_kd applies the rule before any step."""
    from onebit_tpu_torch.train.validate import ConfigError, validate_run
    jc, teacher, student, c, blocks = models
    out = tmp_path / "out"
    out.mkdir()
    run = trun.KDRunConfig(output_dir=str(out), batch_size=2, plot=False)
    validate_run(run, c)
    (out / trun.STATE_FILE).write_bytes(b"")
    with pytest.raises(ConfigError, match="output-dir-clobber"):
        validate_run(run, c)
    with pytest.raises(ConfigError, match="output-dir-clobber"):
        trun.run_kd(c, _port(student, c), _port(teacher, c), blocks,
                    run_cfg=run)
    validate_run(trun.KDRunConfig(output_dir=str(out), resume_from=str(out)),
                 c)


def _cli(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "onebit_tpu_torch", *args],
                          cwd=ROOT, capture_output=True, text=True, env=env,
                          timeout=300)


def test_cli_pipeline(models, tmp_path, capsys):
    """build-start-ckpt from a JAX teacher checkpoint gives the JAX
    command's start checkpoint; train --tokens on it gives what run_kd
    gives in process (bf16, the default); convert packs the final model as
    the JAX command packs it."""
    jc, teacher, _, c, blocks = models
    d = tmp_path
    jsave(str(d / "teacher"), jc, teacher)
    np.save(d / "blocks.npy", blocks)
    run = _cli("build-start-ckpt", str(d / "teacher"), str(d / "start"),
               "--device", "cpu")
    assert run.returncode == 0, run.stderr
    jmain(["build-start-ckpt", str(d / "teacher"), str(d / "jax_start")])
    with np.load(d / "start" / "params.npz") as a, \
            np.load(d / "jax_start" / "params.npz") as b:
        assert a.files == b.files
        for k in b.files:
            if k.endswith(("weight_scale", "input_factor")):
                assert np.abs(a[k] - b[k]).max() <= TOL * np.abs(b[k]).max()
            else:
                assert a[k].tobytes() == b[k].tobytes(), k
    # the JAX writer's latent checkpoint loads and comes back byte for byte
    save_native(str(d / "jax_start_again"), c,
                load_native(str(d / "jax_start"), device="cpu")["params"])
    with np.load(d / "jax_start" / "params.npz") as a, \
            np.load(d / "jax_start_again" / "params.npz") as b:
        assert a.files == b.files
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)

    args = ["--student", str(d / "start"), "--teacher", str(d / "teacher"),
            "--tokens", str(d / "blocks.npy"), "--batch-size", "2",
            "--max-steps", "3", "--save-steps", "1", "--save-total-limit",
            "1", "--warmup-steps", "1", "--device", "cpu"]
    run = _cli("train", *args, "--output-dir", str(d / "out"))
    assert run.returncode == 0, run.stderr
    assert _ckpts(d / "out") == ["checkpoint-3"]
    log = _log(d / "out")
    assert [e["current_steps"] for e in log] == [3]
    assert {"loss", "kd_loss", "student_loss", "pkd_loss", "grad_norm",
            "learning_rate"} <= set(log[0])
    start = load_native(str(d / "start"), device="cpu")
    state = trun.run_kd(c, start["params"],
                        load_native(str(d / "teacher"),
                                    device="cpu")["params"], blocks,
                        kd_cfg=KDConfig(kd_beta=1.0, kd_loss_scale=0.01),
                        train_cfg=TrainConfig(warmup_steps=1),
                        run_cfg=trun.KDRunConfig(
                            output_dir=str(d / "in_process"), batch_size=2,
                            max_steps=3, save_steps=1, save_total_limit=1,
                            num_epochs=50, plot=False))
    assert _log(d / "in_process")[0]["loss"] == log[0]["loss"]
    final = load_native(str(d / "out" / "final"), device="cpu")["params"]
    for name in jb.PROJ_NAMES:
        assert torch.equal(final["layers"][name].latent,
                           state.params["layers"][name].latent.detach())

    run = _cli("convert", str(d / "out" / "final"), str(d / "packed"),
               "--device", "cpu")
    assert run.returncode == 0, run.stderr
    jmain(["convert", str(d / "out" / "final"), str(d / "jax_packed")])
    capsys.readouterr()
    with np.load(d / "packed" / "params.npz") as a, \
            np.load(d / "jax_packed" / "params.npz") as b:
        assert a.files == b.files
        for k in b.files:
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("cmd", [
    ["train", "--data", "d", "--dataset", "kd"], ["train", "--tokenizer", "t"],
    ["train", "--dry-compile", "--model", "llama2-7b"],
    ["train", "--sharded-ckpt"],
    ["convert", "x", "y", "--format", "sharded"]],
    ids=["text", "tokenizer", "dry-compile", "sharded", "convert-sharded"])
def test_cli_unported_exit_nonzero(cmd):
    run = _cli(*cmd, "--device", "cpu")
    assert run.returncode != 0
    assert "not ported yet" in run.stderr
