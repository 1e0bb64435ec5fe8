"""Knowledge-distillation losses, matching the reference KDTrainer.

Port of ``onebit_tpu/train/losses.py``. Reference semantics
(llama_factory/llamafactory/kd.py):

* ``kd_kl_loss`` (:34-40): ``KL(log_softmax(student) ‖ softmax(teacher))``
  with torch ``reduction="batchmean"``: the KL summed over all elements and
  divided by the size of the first dimension (batch), not by tokens.
* ``causal_ce_loss``: the student's own next-token cross-entropy (HF
  ``outputs.loss``: the mean over non-ignored shifted tokens).
* ``hidden_state_loss`` (:85-98): per layer, rows L2-normalized, the mean
  over rows of the squared L2 distance, summed over layers (``kd_beta``).
* ``attention_map_loss`` (:100-111): the same form on attention maps, rows
  not normalized (``kd_gamma``).
* total (:80, :97, :110):
  ``alpha·scale·kl + (1-alpha)·ce + beta·pkd + gamma·attn``.

Every loss works in fp32 over the whole tensor, as the JAX package does.

A data-parallel rank sees only its rows of the batch, and JAX's losses are
means over the global batch. So each loss takes the global batch's
denominators (``batch_size``, ``valid_tokens``): a rank's loss is then its
share of the global one, and the ranks' shares sum to it
(``train/trainer.py`` ``make_sharded_train_step``). Without them the
denominators are the tensors' own. A rank of a model axis holds the whole
logits and hidden states, but only its heads' attention maps: the
attention-map loss then takes the model group (``heads_group``), counts
its rows over every rank's heads, and sums the ranks' shares forward
(``kernels/bitlinear_sharded.py`` ``reduce_from_model``: each rank's
share is the only path to its heads, so the backward passes the gradient
as it is).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from onebit_tpu_torch.kernels.bitlinear_sharded import reduce_from_model

IGNORE_INDEX = -100  # HF convention (llamafactory/extras.py IGNORE_INDEX)


@dataclasses.dataclass(frozen=True)
class KDConfig:
    """KD hyperparameters (reference hparams/model_args.py:81-100; script
    defaults from scripts/llama_7b.sh:44-47)."""
    kd_alpha: float = 1.0
    kd_beta: float = 0.0
    kd_gamma: float = 0.0
    kd_loss_scale: float = 1.0


def kd_kl_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               batch_size: Optional[int] = None) -> torch.Tensor:
    """KL(student ‖ teacher) with torch 'batchmean' reduction semantics:
    divided by ``batch_size`` (default: the logits' own)."""
    s = torch.log_softmax(student_logits.float(), dim=-1)
    log_t = torch.log_softmax(teacher_logits.float(), dim=-1)
    t = torch.softmax(teacher_logits.float(), dim=-1)
    return (t * (log_t - s)).sum() / (batch_size or student_logits.shape[0])


def causal_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = IGNORE_INDEX,
                   valid_tokens: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Shifted next-token CE, mean over valid tokens (HF CausalLM loss):
    over ``valid_tokens`` when given (the global batch's count)."""
    logits = logits[:, :-1].float()
    labels = labels[:, 1:].long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    count = valid.sum() if valid_tokens is None else valid_tokens
    return nll.sum() / count.clamp(min=1)


def _row_mean(sq: torch.Tensor, rows: Optional[int]) -> torch.Tensor:
    """``sq [n, R]`` -> the mean over each slice's rows, or their sum over
    ``rows`` (the global batch's)."""
    return sq.mean(-1) if rows is None else sq.sum(-1) / rows


def _global_rows(x: torch.Tensor, batch_dim: int,
                 batch_size: Optional[int]) -> Optional[int]:
    """The rows a slice of ``x`` would have over the global batch."""
    if batch_size is None:
        return None
    per_slice = x[0].numel() // x.shape[-1]
    return per_slice // x.shape[batch_dim] * batch_size


def _normalized_rowwise_mse(s: torch.Tensor, t: torch.Tensor,
                            rows: Optional[int] = None):
    """Mean over rows of ‖normalize(t) - normalize(s)‖², per leading slice,
    summed over the slices."""
    s = s.reshape(s.shape[0], -1, s.shape[-1]).float()
    t = t.reshape(t.shape[0], -1, t.shape[-1]).float()
    s = s / (torch.linalg.vector_norm(s, dim=-1, keepdim=True) + 1e-12)
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)
    return _row_mean(((t - s) ** 2).sum(-1), rows).sum()


def hidden_state_loss(student_hidden, teacher_hidden, num_layers: int,
                      batch_size: Optional[int] = None):
    """Normalized per-layer hidden-state MSE (reference kd.py:85-98) on
    stacked ``[L+1, B, S, D]`` hidden states (``forward(...,
    output_hidden_states=True)``): slices ``[0:num_layers]``, the embedding
    output and the first ``num_layers - 1`` layer outputs, as the reference
    loop indexes them."""
    return _normalized_rowwise_mse(
        student_hidden[:num_layers], teacher_hidden[:num_layers],
        _global_rows(student_hidden, 1, batch_size))


def attention_map_loss(student_attn, teacher_attn, num_layers: int,
                       batch_size: Optional[int] = None, heads_group=None):
    """Attention-map MSE (reference kd.py:100-111) on stacked
    ``[L, B, H, S, T]`` maps; rows are not normalized. ``heads_group``: the
    model group whose ranks hold the other heads (see the module
    docstring)."""
    rows = _global_rows(student_attn, 1, batch_size)
    if heads_group is not None:
        if rows is None:
            rows = student_attn[0].numel() // student_attn.shape[-1]
        rows *= heads_group.size
    s = student_attn[:num_layers].float().reshape(num_layers, -1,
                                                 student_attn.shape[-1])
    t = teacher_attn[:num_layers].float().reshape(num_layers, -1,
                                                 teacher_attn.shape[-1])
    loss = _row_mean(((t - s) ** 2).sum(-1), rows).sum()
    return loss if heads_group is None else reduce_from_model(loss,
                                                              heads_group)


def kd_total_loss(cfg: KDConfig, *, student_logits, teacher_logits, labels,
                  student_hidden: Optional[torch.Tensor] = None,
                  teacher_hidden: Optional[torch.Tensor] = None,
                  student_attn: Optional[torch.Tensor] = None,
                  teacher_attn: Optional[torch.Tensor] = None,
                  num_layers: Optional[int] = None,
                  batch_size: Optional[int] = None,
                  valid_tokens: Optional[torch.Tensor] = None,
                  heads_group=None):
    """The combined KD objective (reference kd.py:71-111) -> ``(total,
    metrics)``; the metrics are 0-d tensors keyed ``kd_loss``,
    ``student_loss`` and ``loss``, plus ``pkd_loss`` / ``attn_loss`` when
    their terms are on. ``batch_size`` and ``valid_tokens``: the global
    batch's denominators; ``heads_group``: the model group of split heads
    (see the module docstring)."""
    kl = (kd_kl_loss(student_logits, teacher_logits, batch_size)
          if cfg.kd_loss_scale > 0 else student_logits.new_zeros(()))
    ce = causal_ce_loss(student_logits, labels, valid_tokens=valid_tokens)
    total = cfg.kd_alpha * cfg.kd_loss_scale * kl + (1.0 - cfg.kd_alpha) * ce
    metrics = {"kd_loss": kl, "student_loss": ce}
    if cfg.kd_beta > 0 and student_hidden is not None:
        pkd = hidden_state_loss(student_hidden, teacher_hidden, num_layers,
                                batch_size)
        total = total + cfg.kd_beta * pkd
        metrics["pkd_loss"] = pkd
    if cfg.kd_gamma > 0 and student_attn is not None:
        attn = attention_map_loss(student_attn, teacher_attn, num_layers,
                                  batch_size, heads_group)
        total = total + cfg.kd_gamma * attn
        metrics["attn_loss"] = attn
    metrics["loss"] = total
    return total, metrics
