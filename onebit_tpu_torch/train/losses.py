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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

IGNORE_INDEX = -100  # HF convention (llamafactory/extras.py IGNORE_INDEX)


@dataclasses.dataclass(frozen=True)
class KDConfig:
    """KD hyperparameters (reference hparams/model_args.py:81-100; script
    defaults from scripts/llama_7b.sh:44-47)."""
    kd_alpha: float = 1.0
    kd_beta: float = 0.0
    kd_gamma: float = 0.0
    kd_loss_scale: float = 1.0


def kd_kl_loss(student_logits: torch.Tensor,
               teacher_logits: torch.Tensor) -> torch.Tensor:
    """KL(student ‖ teacher) with torch 'batchmean' reduction semantics."""
    s = torch.log_softmax(student_logits.float(), dim=-1)
    log_t = torch.log_softmax(teacher_logits.float(), dim=-1)
    t = torch.softmax(teacher_logits.float(), dim=-1)
    return (t * (log_t - s)).sum() / student_logits.shape[0]


def causal_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Shifted next-token CE, mean over valid tokens (HF CausalLM loss)."""
    logits = logits[:, :-1].float()
    labels = labels[:, 1:].long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def _normalized_rowwise_mse(s: torch.Tensor, t: torch.Tensor):
    """Mean over rows of ‖normalize(t) - normalize(s)‖², per leading slice,
    summed over the slices."""
    s = s.reshape(s.shape[0], -1, s.shape[-1]).float()
    t = t.reshape(t.shape[0], -1, t.shape[-1]).float()
    s = s / (torch.linalg.vector_norm(s, dim=-1, keepdim=True) + 1e-12)
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)
    return ((t - s) ** 2).sum(-1).mean(-1).sum()


def hidden_state_loss(student_hidden, teacher_hidden, num_layers: int):
    """Normalized per-layer hidden-state MSE (reference kd.py:85-98) on
    stacked ``[L+1, B, S, D]`` hidden states (``forward(...,
    output_hidden_states=True)``): slices ``[0:num_layers]``, the embedding
    output and the first ``num_layers - 1`` layer outputs, as the reference
    loop indexes them."""
    return _normalized_rowwise_mse(student_hidden[:num_layers],
                                   teacher_hidden[:num_layers])


def attention_map_loss(student_attn, teacher_attn, num_layers: int):
    """Attention-map MSE (reference kd.py:100-111) on stacked
    ``[L, B, H, S, T]`` maps; rows are not normalized."""
    s = student_attn[:num_layers].float().reshape(num_layers, -1,
                                                 student_attn.shape[-1])
    t = teacher_attn[:num_layers].float().reshape(num_layers, -1,
                                                 teacher_attn.shape[-1])
    return ((t - s) ** 2).sum(-1).mean(-1).sum()


def kd_total_loss(cfg: KDConfig, *, student_logits, teacher_logits, labels,
                  student_hidden: Optional[torch.Tensor] = None,
                  teacher_hidden: Optional[torch.Tensor] = None,
                  student_attn: Optional[torch.Tensor] = None,
                  teacher_attn: Optional[torch.Tensor] = None,
                  num_layers: Optional[int] = None):
    """The combined KD objective (reference kd.py:71-111) -> ``(total,
    metrics)``; the metrics are 0-d tensors keyed ``kd_loss``,
    ``student_loss`` and ``loss``, plus ``pkd_loss`` / ``attn_loss`` when
    their terms are on."""
    kl = (kd_kl_loss(student_logits, teacher_logits)
          if cfg.kd_loss_scale > 0 else student_logits.new_zeros(()))
    ce = causal_ce_loss(student_logits, labels)
    total = cfg.kd_alpha * cfg.kd_loss_scale * kl + (1.0 - cfg.kd_alpha) * ce
    metrics = {"kd_loss": kl, "student_loss": ce}
    if cfg.kd_beta > 0 and student_hidden is not None:
        pkd = hidden_state_loss(student_hidden, teacher_hidden, num_layers)
        total = total + cfg.kd_beta * pkd
        metrics["pkd_loss"] = pkd
    if cfg.kd_gamma > 0 and student_attn is not None:
        attn = attention_map_loss(student_attn, teacher_attn, num_layers)
        total = total + cfg.kd_gamma * attn
        metrics["attn_loss"] = attn
    metrics["loss"] = total
    return total, metrics
