"""The SFT stage: the reference's secondary stage (llamafactory/sft.py).

Port of ``onebit_tpu/train/run_sft.py`` on one device. ``run_sft`` =
supervised fine-tuning of the (quantized) student on (prompt, response)
pairs with prompt-masked CE — the KD train step with every distillation
term off. Its batches carry a padding mask, so attention is the masked
plain attention (never B11) and the projections are the latent fp32
products, on the card as on the CPU. ``save_predictions`` mirrors
CustomSeq2SeqTrainer.save_predictions (sft.py:167-192): greedy-generate on
prompts (``generate``: K1, K2, K3 and B9 on the card for packed params) and
dump {"label", "predict"} jsonl.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from onebit_tpu_torch.engine.generate import generate
from onebit_tpu_torch.engine.sampler import SamplingConfig
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.train.data import prepare_sft_dataset
from onebit_tpu_torch.train.gen_metrics import compute_generation_metrics
from onebit_tpu_torch.train.losses import KDConfig
from onebit_tpu_torch.train.run_kd import KDRunConfig
from onebit_tpu_torch.train.trainer import (TrainConfig, TrainState,
                                            clone_params, init_train_state,
                                            make_train_step)
from onebit_tpu_torch.utils.logging import TrainerLog, get_logger

logger = get_logger(__name__)

# prompt-masked CE alone: every distillation term off, no teacher
SFT_KD = KDConfig(kd_alpha=0.0, kd_beta=0.0, kd_gamma=0.0, kd_loss_scale=0.0)


def run_sft(config: BitLlamaConfig, params,
            pairs: Sequence[Tuple[str, str]], tokenize: Callable, *,
            cutoff_len: int = 1024, template: str = "vanilla",
            train_cfg: TrainConfig = TrainConfig(),
            run_cfg: KDRunConfig = KDRunConfig(),
            impl: str = "auto") -> TrainState:
    """Supervised fine-tune on (prompt, response) pairs (CE only), on the
    device the params live on. The caller's params are not changed: the
    run trains a copy. Each step draws ``batch_size`` rows with
    ``np.random.default_rng(seed).choice`` (with replacement only when the
    dataset holds fewer rows), as JAX draws them. Like JAX's, it never
    shards: a ``mesh_shape`` of more than one device raises."""
    shape = run_cfg.mesh_shape
    if shape is not None and int(np.prod(shape)) != 1:
        raise NotImplementedError(
            f"mesh_shape {tuple(shape)}: run_sft trains on one device, as "
            f"the JAX package's run_sft does (it never shards)")
    batch = prepare_sft_dataset(pairs, tokenize, cutoff_len=cutoff_len,
                                eos_id=config.eos_token_id or 2,
                                template=template)
    n = len(batch["input_ids"])
    steps_per_epoch = max(n // run_cfg.batch_size, 1)
    total = run_cfg.max_steps or steps_per_epoch * run_cfg.num_epochs
    train_cfg = dataclasses.replace(train_cfg, total_steps=total)

    state = init_train_state(clone_params(params), train_cfg)
    step_fn = make_train_step(config, SFT_KD, train_cfg,
                              compute_dtype=run_cfg.compute_dtype, impl=impl)
    tlog = TrainerLog(run_cfg.output_dir, total)
    rng = np.random.default_rng(run_cfg.seed)
    for step_idx in range(total):
        idx = rng.choice(n, size=run_cfg.batch_size,
                         replace=n < run_cfg.batch_size)
        state, metrics = step_fn(state, None,
                                 {k: v[idx] for k, v in batch.items()})
        if (step_idx + 1) % run_cfg.log_steps == 0 or step_idx + 1 == total:
            m = {k: float(v) for k, v in metrics.items()}
            tlog.log(step_idx + 1, m)
            logger.info(f"sft step {step_idx + 1}/{total} "
                        f"loss={m['loss']:.4f}")
    return state


@torch.no_grad()
def save_predictions(output_dir: str, params, config: BitLlamaConfig,
                     prompts: Sequence[str], labels: Sequence[str],
                     tokenize: Callable, detokenize: Callable, *,
                     max_new_tokens: int = 64,
                     compute_metrics: bool = True) -> str:
    """Greedy-generate per prompt and dump jsonl (reference sft.py:167-192).

    With ``compute_metrics`` (the reference's ComputeMetrics predict stage,
    sft.py:31-68) also writes ``predict_results.json`` holding mean
    rouge-1/2/l and bleu-4 over the (prediction, label) pairs. Returns the
    jsonl's path."""
    os.makedirs(output_dir, exist_ok=True)
    outs = generate(params, config, [tokenize(p) for p in prompts],
                    max_new_tokens=max_new_tokens,
                    sampling=SamplingConfig(greedy=True))
    preds = [detokenize(out) for out in outs]
    path = os.path.join(output_dir, "generated_predictions.jsonl")
    with open(path, "w", encoding="utf-8") as f:
        for label, pred in zip(labels, preds):
            f.write(json.dumps({"label": label, "predict": pred},
                               ensure_ascii=False) + "\n")
    if compute_metrics:
        metrics = compute_generation_metrics(preds, list(labels))
        with open(os.path.join(output_dir, "predict_results.json"),
                  "w", encoding="utf-8") as f:
            json.dump(metrics, f, indent=2)
    return path
