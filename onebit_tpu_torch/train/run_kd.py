"""KD training driver: the reference's ``run_kd`` (kd.py:195-240) on one
device.

Port of ``onebit_tpu/train/run_kd.py``: pre-chunked token blocks -> the
train loop with jsonl logging, held-out evaluation, periodic checkpoints
with rotation, resume, the final native checkpoint under ``final/`` and
loss plots. The resume state is the port's own file, ``train_state.pt``
(the params under their native-checkpoint keys, the Adam moments, the
step): optax's state pytree has no torch counterpart, so the JAX package's
``train_state.npz`` does not load here, nor the port's there. Meshes of
more than one device and orbax sharded states wait for the rest of
parallelism (ROADMAP.md §1 item 6).
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from onebit_tpu_torch.ckpt.native import save_native
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.parallel.mesh import PARALLEL_WAIT
from onebit_tpu_torch.train.data import batch_iterator, split_dataset
from onebit_tpu_torch.train.losses import KDConfig
from onebit_tpu_torch.train.trainer import (TrainConfig, TrainState,
                                            clone_params, init_train_state,
                                            load_state_tensors,
                                            make_eval_step, make_schedule,
                                            make_train_step, state_tensors)
from onebit_tpu_torch.train.validate import validate_train_run
from onebit_tpu_torch.utils.logging import TrainerLog, get_logger, plot_loss

logger = get_logger(__name__)

STATE_FILE = "train_state.pt"


def save_train_state(path: str, state: TrainState) -> None:
    """``path/train_state.pt``: the state's tensors, on the host."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_tensors(state).items()},
               os.path.join(path, STATE_FILE))


def load_train_state(path: str, template: TrainState) -> TrainState:
    """The state saved under ``path``, copied into ``template``'s tensors
    (the params and moments of :func:`init_train_state`)."""
    flat = torch.load(os.path.join(path, STATE_FILE), weights_only=True)
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
    mesh_shape: Optional[tuple] = None   # one device; more wait (item 6)
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
    sharded_ckpt: bool = False         # orbax sharded states: item 6
    # keep only the newest N checkpoint-* dirs (HF Trainer save_total_limit,
    # training_args save_total_limit semantics); None = keep all
    save_total_limit: Optional[int] = None


def _one_device(run_cfg: KDRunConfig) -> None:
    shape = run_cfg.mesh_shape
    if shape is not None and int(np.prod(shape)) != 1:
        raise NotImplementedError(
            f"mesh_shape {tuple(shape)}: data- and model-parallel training "
            f"wait for {PARALLEL_WAIT}; run_kd trains on one device")
    if run_cfg.sharded_ckpt:
        raise NotImplementedError(
            f"sharded_ckpt: orbax sharded train states wait for "
            f"{PARALLEL_WAIT}")


def run_kd(config: BitLlamaConfig, student_params, teacher_params,
           blocks: np.ndarray, *, kd_cfg: KDConfig = KDConfig(),
           train_cfg: TrainConfig = TrainConfig(),
           run_cfg: KDRunConfig = KDRunConfig(),
           eval_blocks: Optional[np.ndarray] = None) -> TrainState:
    """Train the student against the teacher on pre-chunked token blocks
    ``[N, S]``, on the device the params live on. The caller's student
    params are not changed: the run trains a copy."""
    _one_device(run_cfg)
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

    state = init_train_state(clone_params(student_params), train_cfg)
    if run_cfg.resume_from:
        state = load_train_state(run_cfg.resume_from, state)
        logger.info(f"resumed from {run_cfg.resume_from} at step "
                    f"{state.step}")

    step_fn = make_train_step(config, kd_cfg, train_cfg,
                              compute_dtype=run_cfg.compute_dtype)
    schedule = make_schedule(train_cfg)

    eval_fn = None
    if eval_blocks is not None and len(eval_blocks) >= run_cfg.batch_size:
        eval_fn = make_eval_step(config, kd_cfg, train_cfg,
                                 compute_dtype=run_cfg.compute_dtype)

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

    tlog = TrainerLog(run_cfg.output_dir, total)
    start_step = state.step
    it = batch_iterator(blocks, run_cfg.batch_size, seed=run_cfg.seed,
                        epochs=None)
    # skip already-consumed batches on resume
    for _ in range(start_step):
        next(it)

    for step_idx in range(start_step, total):
        state, metrics = step_fn(state, teacher_params, next(it))
        epoch = (step_idx + 1) / max(steps_per_epoch, 1)
        if ((step_idx + 1) % run_cfg.log_steps == 0
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
            tlog.log(step_idx + 1, em, epoch=epoch)
            logger.info(f"eval step {step_idx + 1}: "
                        f"loss={em.get('eval_loss', float('nan')):.4f}")
        if (step_idx + 1) % run_cfg.save_steps == 0 or step_idx + 1 == total:
            ckpt_dir = os.path.join(run_cfg.output_dir,
                                    f"checkpoint-{step_idx + 1}")
            save_train_state(ckpt_dir, state)
            logger.info(f"saved {ckpt_dir}")
            if run_cfg.save_total_limit:
                _prune_checkpoints(run_cfg.output_dir,
                                   run_cfg.save_total_limit)

    # final params in the loadable native format (the reference Trainer's
    # end-of-run save_pretrained): convert and eval read it; the
    # checkpoint-* states are resume state, not a model
    final_dir = os.path.join(run_cfg.output_dir, "final")
    save_native(final_dir, config, state.params)
    logger.info(f"final model -> {final_dir}")

    if run_cfg.plot:
        try:
            plot_loss(run_cfg.output_dir, keys=["loss", "kd_loss",
                                                "student_loss"])
        except Exception as e:  # plotting must never kill a run
            logger.warning(f"plot_loss failed: {e!r}")
    return state
