"""Cross-validation of training run arguments before any device work.

A copy of ``onebit_tpu/train/validate.py``, which imports no framework; the
port keeps its own copy so that it imports nothing of the JAX package. One
change: the output-dir rule looks for the port's resume state
(``train_state.pt`` or ``train_state.dcp/``), not the JAX package's
``train_state.npz``.

The reference validates its five HfArgumentParser dataclass groups with ~25
cross-checks in ``get_train_args`` (llama_factory/llamafactory/core.py:81-215)
— stage/template coherence, generation-flag gating, checkpoint-dir rules,
output-dir clobber protection.  Many of those guard LoRA/PPO/RM/DPO paths
outside this framework's scope; this module applies the same discipline to
the config space that exists here (model geometry, KD hyperparameters, data
shapes, optimizer schedule, mesh, checkpoint dirs) so a bad run fails in
milliseconds with a named rule instead of minutes into a run.

Every rule raises ``ConfigError`` with a ``[rule-name]`` prefix so tests (and
users) can pin the exact rejection path.
"""

from __future__ import annotations

import os
from typing import Optional


class ConfigError(ValueError):
    """A named configuration cross-validation failure."""

    def __init__(self, rule: str, message: str):
        self.rule = rule
        super().__init__(f"[{rule}] {message}")


def _req(cond: bool, rule: str, message: str) -> None:
    if not cond:
        raise ConfigError(rule, message)


def validate_model_config(config) -> None:
    """Geometry rules a BitLlama config must satisfy to run at all.

    Head/GQA divisibility and rope_scaling shape are already enforced by
    ``BitLlamaConfig.__post_init__`` (config.py:49-69) at construction; the
    rules here are the ones only the quantized runtime cares about.
    """
    _req(config.vocab_size > 0 and config.num_hidden_layers > 0,
         "positive-dims", "vocab_size and num_hidden_layers must be > 0")
    _req(config.hidden_size % 32 == 0 and config.intermediate_size % 32 == 0,
         "pack-divisibility",
         f"hidden_size {config.hidden_size} / intermediate_size "
         f"{config.intermediate_size} must be multiples of 32 (sign words "
         "pack 32 elements; reference convert_llama_to_infer_ckpt.py:8-9 "
         "has the same %8 precondition for int8 bytes)")


def validate_kd(kd_cfg, student_config, teacher_config=None) -> None:
    """KD hyperparameter coherence (reference kd.py:34-111 semantics)."""
    _req(0.0 <= kd_cfg.kd_alpha <= 1.0, "kd-alpha-range",
         f"kd_alpha {kd_cfg.kd_alpha} outside [0, 1] (it convexly mixes KD "
         "and CE: kd.py:80)")
    _req(kd_cfg.kd_loss_scale > 0, "kd-scale-positive",
         f"kd_loss_scale {kd_cfg.kd_loss_scale} must be > 0")
    _req(kd_cfg.kd_beta >= 0 and kd_cfg.kd_gamma >= 0, "kd-beta-gamma-sign",
         "kd_beta / kd_gamma are loss weights and must be >= 0")
    if teacher_config is not None:
        _req(teacher_config.vocab_size == student_config.vocab_size,
             "teacher-vocab-match",
             f"teacher vocab {teacher_config.vocab_size} != student vocab "
             f"{student_config.vocab_size}: KL over logits requires the "
             "same vocabulary (kd.py:34-40)")
        if kd_cfg.kd_beta > 0:
            _req(teacher_config.hidden_size == student_config.hidden_size,
                 "teacher-hidden-match",
                 "kd_beta > 0 compares per-layer hidden states "
                 "(kd.py:85-98); teacher hidden_size "
                 f"{teacher_config.hidden_size} != student "
                 f"{student_config.hidden_size}")
            _req(teacher_config.num_hidden_layers
                 == student_config.num_hidden_layers,
                 "teacher-depth-match",
                 "kd_beta > 0 pairs hidden states layer-by-layer; depths "
                 f"differ ({teacher_config.num_hidden_layers} vs "
                 f"{student_config.num_hidden_layers})")
        if kd_cfg.kd_gamma > 0:
            _req(teacher_config.num_attention_heads
                 == student_config.num_attention_heads,
                 "teacher-heads-match",
                 "kd_gamma > 0 compares attention maps (kd.py:100-111); "
                 "head counts differ "
                 f"({teacher_config.num_attention_heads} vs "
                 f"{student_config.num_attention_heads})")


def validate_train(train_cfg) -> None:
    """Optimizer/schedule sanity (reference Seq2SeqTrainingArguments side)."""
    _req(train_cfg.learning_rate > 0, "lr-positive",
         f"learning_rate {train_cfg.learning_rate} must be > 0")
    _req(0 < train_cfg.adam_beta1 < 1 and 0 < train_cfg.adam_beta2 < 1,
         "adam-beta-range", "adam betas must lie in (0, 1)")
    _req(train_cfg.weight_decay >= 0, "wd-sign",
         f"weight_decay {train_cfg.weight_decay} must be >= 0")
    _req(train_cfg.grad_accum_steps >= 1, "accum-positive",
         f"grad_accum_steps {train_cfg.grad_accum_steps} must be >= 1")
    _req(train_cfg.lr_schedule in ("cosine", "constant"), "schedule-known",
         f"unknown lr_schedule {train_cfg.lr_schedule!r}")
    _req(0.0 <= train_cfg.min_lr_ratio <= 1.0, "min-lr-range",
         f"min_lr_ratio {train_cfg.min_lr_ratio} outside [0, 1]")
    _req(train_cfg.warmup_steps >= 0, "warmup-sign",
         "warmup_steps must be >= 0")
    _req(train_cfg.warmup_steps < train_cfg.total_steps,
         "warmup-vs-total",
         f"warmup_steps {train_cfg.warmup_steps} >= total_steps "
         f"{train_cfg.total_steps}: the cosine schedule never leaves warmup")
    _req(train_cfg.max_grad_norm > 0, "clip-positive",
         f"max_grad_norm {train_cfg.max_grad_norm} must be > 0")


def validate_run(run_cfg, config, *, n_blocks: Optional[int] = None,
                 block_len: Optional[int] = None,
                 n_data_devices: Optional[int] = None) -> None:
    """Run-shape rules: batch vs mesh vs dataset vs output dir."""
    _req(run_cfg.batch_size >= 1, "batch-positive",
         f"batch_size {run_cfg.batch_size} must be >= 1")
    _req(run_cfg.save_steps > 0 and run_cfg.log_steps > 0,
         "steps-positive", "save_steps / log_steps must be > 0")
    _req(run_cfg.max_steps is None or run_cfg.max_steps > 0,
         "max-steps-positive", "max_steps, when set, must be > 0")
    _req(0.0 <= run_cfg.val_split < 1.0, "val-split-range",
         f"val_split {run_cfg.val_split} outside [0, 1)")
    if n_data_devices is not None:
        _req(run_cfg.batch_size % n_data_devices == 0, "batch-vs-mesh",
             f"batch_size {run_cfg.batch_size} not divisible by data-"
             f"parallel size {n_data_devices} (one global batch is sharded "
             "over the data axis)")
    if n_blocks is not None:
        _req(n_blocks >= run_cfg.batch_size, "dataset-vs-batch",
             f"dataset has {n_blocks} blocks < batch_size "
             f"{run_cfg.batch_size}: not one full step of data")
    if block_len is not None:
        _req(block_len <= config.max_position_embeddings, "cutoff-vs-ctx",
             f"block length {block_len} exceeds max_position_embeddings "
             f"{config.max_position_embeddings} (reference cutoff_len "
             "contract, data_args.py:45)")
    if run_cfg.resume_from is not None:
        _req(os.path.isdir(run_cfg.resume_from), "resume-exists",
             f"resume_from {run_cfg.resume_from!r} is not a directory")
    # output-dir clobber protection (reference core.py:185-197): an output
    # dir holding a previous run's state requires explicit resume
    if run_cfg.resume_from is None and os.path.isdir(run_cfg.output_dir):
        held = [os.path.join(run_cfg.output_dir, n)
                for n in ("train_state.pt", "train_state.dcp")]
        _req(not any(map(os.path.exists, held)), "output-dir-clobber",
             f"output_dir {run_cfg.output_dir!r} already holds a training "
             "state; pass resume_from to continue it or choose a fresh "
             "directory")


def validate_train_run(config, kd_cfg, train_cfg, run_cfg, *,
                       teacher_config=None, n_blocks: Optional[int] = None,
                       block_len: Optional[int] = None,
                       n_data_devices: Optional[int] = None) -> None:
    """The full pre-flight pass ``run_kd`` applies (reference get_train_args
    equivalent): every rule above, in order, fail-fast."""
    validate_model_config(config)
    if teacher_config is not None:
        validate_model_config(teacher_config)
    validate_kd(kd_cfg, config, teacher_config)
    validate_train(train_cfg)
    validate_run(run_cfg, config, n_blocks=n_blocks, block_len=block_len,
                 n_data_devices=n_data_devices)
