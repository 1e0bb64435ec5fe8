"""KD training driver: the reference's ``run_kd`` (kd.py:195-240).

Port of ``onebit_tpu/train/run_kd.py``: pre-chunked token blocks -> the
train loop with jsonl logging, held-out evaluation, periodic checkpoints
with rotation, resume, the final native checkpoint under ``final/`` and
loss plots. On one device, or sharded over the ranks of a ``(data,
model)`` mesh (``parallel/sharding.py``, ``train/trainer.py``
``make_sharded_train_step``) when the default process group has more than
one rank: params, teacher and moments split over every rank, the model
axis tensor-parallel. The mesh is ``mesh_shape`` or JAX's default
(:func:`pick_mesh`). Rank 0 alone writes the jsonl log, the plots and the
final checkpoint.

The resume state is the port's own: ``train_state.pt`` (the params under
their native-checkpoint keys, the Adam moments, the step; in a group
gathered over both axes to rank 0, which writes it once: the file of a
one-device run, which any mesh resumes), or with ``sharded_ckpt`` a
``train_state.dcp/`` directory of ``torch.distributed.checkpoint`` files that
each rank writes its blocks into and reads them from
(``ckpt/sharded.py``; each block written with its place in the full
tensor, so that another mesh reads the blocks it needs). optax's state pytree has no torch counterpart, so
the JAX package's ``train_state.npz`` and orbax states do not load here,
nor the port's there.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from onebit_tpu_torch.ckpt.native import save_native
from onebit_tpu_torch.ckpt.sharded import load_dcp, save_dcp
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.parallel.mesh import Mesh2D, create_mesh
from onebit_tpu_torch.parallel.sharding import (MeshLayout, block,
                                                gather_full,
                                                gather_params, mesh_layout,
                                                shard_params)
from onebit_tpu_torch.train.data import batch_iterator, split_dataset
from onebit_tpu_torch.train.losses import KDConfig
from onebit_tpu_torch.train.trainer import (TrainConfig, TrainState,
                                            clone_params, init_train_state,
                                            load_state_tensors,
                                            make_eval_step, make_schedule,
                                            make_sharded_train_step,
                                            make_train_step,
                                            named_trainable, state_tensors)
from onebit_tpu_torch.train.validate import validate_train_run
from onebit_tpu_torch.utils.logging import TrainerLog, get_logger, plot_loss

logger = get_logger(__name__)

STATE_FILE = "train_state.pt"
STATE_DIR = "train_state.dcp"
# the JAX package's resume states: npz, and orbax's directory
JAX_STATES = ("train_state.npz", "train_state")


def state_split(state: TrainState, layout: MeshLayout) -> MeshLayout:
    """The split axes of :func:`state_tensors`' keys: a split param's, and
    its moments'."""
    def of(split):
        out = {f"params.{k}": a for k, a in split.items()}
        for i, (key, _) in enumerate(named_trainable(state.params)):
            if key in split:
                out[f"mu.{i}"] = out[f"nu.{i}"] = split[key]
        return out
    return MeshLayout(of(layout.data), of(layout.model))


def save_train_state(path: str, state: TrainState, sharded: bool = False,
                     *, mesh: Optional[Mesh2D] = None,
                     layout: MeshLayout = MeshLayout({}, {})) -> None:
    """``sharded``: ``path/train_state.dcp/`` in DCP's files, each rank's
    blocks written by that rank. Else ``path/train_state.pt`` on the host;
    on a mesh every leaf is gathered (a collective: every rank calls this)
    and rank 0 alone writes the file."""
    flat = state_tensors(state)
    split = state_split(state, layout)
    if sharded:
        save_dcp(os.path.join(os.path.abspath(path), STATE_DIR), flat,
                 split, mesh)
        return
    host = {k: (v.detach() if mesh is None
                else gather_full(v, k, split, mesh)).cpu()
            for k, v in flat.items()}
    if mesh is None or mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        torch.save(host, os.path.join(path, STATE_FILE))


def load_train_state(path: str, template: TrainState, *,
                     mesh: Optional[Mesh2D] = None,
                     layout: MeshLayout = MeshLayout({}, {})) -> TrainState:
    """The state saved under ``path`` (either layout, from any mesh),
    copied into ``template``'s tensors (the params and moments of
    :func:`init_train_state`; on a mesh the rank's blocks)."""
    flat = state_tensors(template)
    split = state_split(template, layout)
    if os.path.isdir(os.path.join(path, STATE_DIR)):
        load_dcp(os.path.join(os.path.abspath(path), STATE_DIR), flat, split,
                 mesh)
    elif not os.path.exists(os.path.join(path, STATE_FILE)):
        jax = [n for n in JAX_STATES if os.path.exists(os.path.join(path, n))]
        if jax:
            raise ValueError(
                f"{path} holds the JAX package's train state ({jax[0]}: "
                f"optax's pytree, orbax's files); the port resumes from its "
                f"own, {STATE_FILE} or {STATE_DIR}/")
        raise FileNotFoundError(f"no {STATE_FILE} or {STATE_DIR}/ in {path}")
    else:
        flat = torch.load(os.path.join(path, STATE_FILE), weights_only=True)
        if mesh is not None:
            for axes, g in ((split.model, mesh.model), (split.data,
                                                        mesh.data)):
                for k, axis in axes.items():
                    flat[k] = block(flat[k], axis, g.size, g.rank, "cpu")
    return load_state_tensors(template, flat)


def _prune_checkpoints(output_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` checkpoint-* dirs (the HF
    Trainer's ``save_total_limit`` rotation)."""
    entries = []
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and os.path.isdir(os.path.join(output_dir, name)):
            entries.append((int(m.group(1)), name))
    for _, name in sorted(entries)[:-keep]:
        shutil.rmtree(os.path.join(output_dir, name), ignore_errors=True)
        logger.info(f"pruned {name} (save_total_limit={keep})")


@dataclasses.dataclass
class KDRunConfig:
    output_dir: str = "out"
    batch_size: int = 4
    num_epochs: int = 1
    max_steps: Optional[int] = None
    log_steps: int = 10
    save_steps: int = 5000          # reference llama_7b.sh:46
    mesh_shape: Optional[tuple] = None   # (data, model); default pick_mesh
    compute_dtype: Any = torch.bfloat16
    resume_from: Optional[str] = None
    plot: bool = True
    seed: int = 42
    # held-out evaluation (the reference Trainer's eval loop): either pass
    # eval_blocks to run_kd, or set val_split to carve them from `blocks`
    # with train.data.split_dataset semantics (dsets.py:42-63)
    val_split: float = 0.0
    eval_steps: Optional[int] = None   # default: evaluate at save points
    eval_batches: int = 16             # eval subset size cap (batches)
    # train states in DCP's sharded files (each rank writes its blocks)
    sharded_ckpt: bool = False
    # keep only the newest N checkpoint-* dirs (HF Trainer save_total_limit,
    # training_args save_total_limit semantics); None = keep all
    save_total_limit: Optional[int] = None


def pick_mesh(run_cfg: KDRunConfig, world: int) -> tuple:
    """The run's ``(data, model)`` mesh over ``world`` ranks:
    ``mesh_shape``, or JAX's default ``(gcd(world, batch), world // gcd)``
    (``onebit_tpu/train/run_kd.py:150-162``)."""
    shape = run_cfg.mesh_shape
    if shape is None:
        d = math.gcd(world, run_cfg.batch_size)
        shape = (d, world // d)
    data, model = (int(x) for x in shape)
    if data * model != world:
        raise ValueError(f"mesh shape {(data, model)} needs {data * model} "
                         f"ranks, the process group has {world}")
    if run_cfg.batch_size % data != 0:
        raise ValueError(f"batch_size {run_cfg.batch_size} not divisible by "
                         f"data axis {data}")
    return data, model


def run_kd(config: BitLlamaConfig, student_params, teacher_params,
           blocks: np.ndarray, *, kd_cfg: KDConfig = KDConfig(),
           train_cfg: TrainConfig = TrainConfig(),
           run_cfg: KDRunConfig = KDRunConfig(),
           eval_blocks: Optional[np.ndarray] = None,
           device: Optional[str] = None,
           mesh: Optional[Mesh2D] = None) -> TrainState:
    """Train the student against the teacher on pre-chunked token blocks
    ``[N, S]``. The caller's student params are not changed: the run
    trains a copy. One process: on the device the params live on. When
    the default process group holds N > 1 ranks (``initialize_distributed``
    or ``spawn_tp``), every rank calls this with the full params (on any
    device, the host is best) and the same blocks, and trains its shards
    of the mesh (:func:`pick_mesh`) on its device: ``cuda:{rank %
    device_count}`` for ``device="cuda"``, the CPU for ``"cpu"`` (default:
    the params' device type). ``mesh``: the ranks' mesh, made by the
    caller, in place of the default process group's. The returned state
    then holds the rank's shards."""
    if mesh is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        shape = pick_mesh(run_cfg, world)
        if world > 1:
            mesh = create_mesh(shape, device or student_params[
                "embed_tokens"].device.type)
    elif run_cfg.batch_size % mesh.shape[0]:
        raise ValueError(f"batch_size {run_cfg.batch_size} not divisible by "
                         f"data axis {mesh.shape[0]}")
    is_main = mesh is None or mesh.rank == 0
    if eval_blocks is None and run_cfg.val_split > 0:
        blocks, eval_blocks = split_dataset(blocks, run_cfg.val_split,
                                            seed=run_cfg.seed)
    steps_per_epoch = len(blocks) // run_cfg.batch_size
    total = run_cfg.max_steps or steps_per_epoch * run_cfg.num_epochs
    train_cfg = dataclasses.replace(train_cfg, total_steps=total)
    if train_cfg.warmup_steps >= total:
        # short runs (smoke tests, tiny corpora) keep the default warmup of
        # 500 (llama_7b.sh:45); clamp rather than reject
        logger.info(f"clamping warmup_steps {train_cfg.warmup_steps} -> "
                    f"{max(total // 10, 1)} (total_steps={total})")
        train_cfg = dataclasses.replace(train_cfg,
                                        warmup_steps=max(total // 10, 1))

    # pre-flight cross-validation (reference get_train_args, core.py:81-215)
    validate_train_run(config, kd_cfg, train_cfg, run_cfg,
                       n_blocks=len(blocks), block_len=int(blocks.shape[1]))

    layout = MeshLayout({}, {})
    if mesh is None:
        state = init_train_state(clone_params(student_params), train_cfg)
        step_fn = make_train_step(config, kd_cfg, train_cfg,
                                  compute_dtype=run_cfg.compute_dtype)
        eval_fn = make_eval_step(config, kd_cfg, train_cfg,
                                 compute_dtype=run_cfg.compute_dtype)
    else:
        layout = mesh_layout(student_params, config, mesh.shape)
        t_layout = mesh_layout(teacher_params, config, mesh.shape)
        state = init_train_state(
            shard_params(student_params, mesh, layout), train_cfg)
        teacher_params = shard_params(teacher_params, mesh, t_layout)
        step_fn = make_sharded_train_step(
            config, kd_cfg, train_cfg, mesh, layout, t_layout,
            compute_dtype=run_cfg.compute_dtype)
        eval_fn = step_fn.eval_step
    if run_cfg.resume_from:
        state = load_train_state(run_cfg.resume_from, state, mesh=mesh,
                                 layout=layout)
        logger.info(f"resumed from {run_cfg.resume_from} at step "
                    f"{state.step}")
    schedule = make_schedule(train_cfg)
    if eval_blocks is None or len(eval_blocks) < run_cfg.batch_size:
        eval_fn = None

    def run_eval(params):
        """Mean held-out metrics over up to eval_batches batches."""
        sums: Dict[str, float] = {}
        count = 0
        for mb in batch_iterator(eval_blocks, run_cfg.batch_size,
                                 shuffle=False, epochs=1):
            for k, v in eval_fn(params, teacher_params, mb).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
            if count >= run_cfg.eval_batches:
                break
        return {f"eval_{k}": v / count for k, v in sums.items()}

    tlog = TrainerLog(run_cfg.output_dir, total) if is_main else None
    start_step = state.step
    it = batch_iterator(blocks, run_cfg.batch_size, seed=run_cfg.seed,
                        epochs=None)
    # skip already-consumed batches on resume
    for _ in range(start_step):
        next(it)

    for step_idx in range(start_step, total):
        state, metrics = step_fn(state, teacher_params, next(it))
        epoch = (step_idx + 1) / max(steps_per_epoch, 1)
        if is_main and ((step_idx + 1) % run_cfg.log_steps == 0
                        or step_idx + 1 == total):
            m = {k: float(v) for k, v in metrics.items()}
            m["learning_rate"] = float(schedule(step_idx))
            entry = tlog.log(step_idx + 1, m, epoch=epoch)
            logger.info(
                f"step {step_idx + 1}/{total} loss={m['loss']:.4f} "
                f"kd={m.get('kd_loss', 0):.4f} "
                f"ce={m.get('student_loss', 0):.4f} "
                f"lr={m['learning_rate']:.2e} eta={entry['remaining_time']}")
        eval_every = run_cfg.eval_steps or run_cfg.save_steps
        if eval_fn is not None and ((step_idx + 1) % eval_every == 0
                                    or step_idx + 1 == total):
            em = run_eval(state.params)
            if is_main:
                tlog.log(step_idx + 1, em, epoch=epoch)
                logger.info(f"eval step {step_idx + 1}: "
                            f"loss={em.get('eval_loss', float('nan')):.4f}")
        if (step_idx + 1) % run_cfg.save_steps == 0 or step_idx + 1 == total:
            ckpt_dir = os.path.join(run_cfg.output_dir,
                                    f"checkpoint-{step_idx + 1}")
            # every rank takes part (DCP's writes and the gathers are
            # collectives); rank 0 alone writes train_state.pt
            save_train_state(ckpt_dir, state, sharded=run_cfg.sharded_ckpt,
                             mesh=mesh, layout=layout)
            if is_main:
                logger.info(f"saved {ckpt_dir}")
            if is_main and run_cfg.save_total_limit:
                _prune_checkpoints(run_cfg.output_dir,
                                   run_cfg.save_total_limit)

    # final params in the loadable native format (the reference Trainer's
    # end-of-run save_pretrained): convert and eval read it; the
    # checkpoint-* states are resume state, not a model
    final_dir = os.path.join(run_cfg.output_dir, "final")
    params_out = (state.params if mesh is None
                  else gather_params(state.params, layout, mesh, dst=0))
    if is_main:
        save_native(final_dir, config, params_out)
        logger.info(f"final model -> {final_dir}")
    del params_out

    if run_cfg.plot and is_main:
        try:
            plot_loss(run_cfg.output_dir, keys=["loss", "kd_loss",
                                                "student_loss"])
        except Exception as e:  # plotting must never kill a run
            logger.warning(f"plot_loss failed: {e!r}")
    return state
