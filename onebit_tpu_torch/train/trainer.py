"""The KD train step: masked AdamW over the trainable BitLinear leaves.

Port of ``onebit_tpu/train/trainer.py``, on one device
(:func:`make_train_step`) or sharded over the ranks of a ``(data, model)``
mesh (:func:`make_sharded_train_step`, ``parallel/sharding.py``):

* only BitLinear float params train (latent weight, weight_scale,
  input_factor, bias): ``requires_grad`` is set on those leaves and cleared
  on every other (embeddings, lm_head, norms), the reference's wiring
  (modeling_bitllama.py:1053, 1345-1347, :73) and the JAX optax mask;
* the optimizer is optax's ``chain(clip_by_global_norm, adamw)`` written
  out: the clip by the global norm of the trainable gradients, ``g ·
  max_norm / norm`` when ``norm >= max_norm`` (not
  ``torch.nn.utils.clip_grad_norm_``, whose ``+1e-6`` differs); AdamW with
  eps 1e-8, bias correction, decay ``lr·wd·p``; the learning rate of update
  ``n`` (from 0) is ``schedule(n)``, so the first update under a warmup
  from 0 moves nothing;
* the teacher runs under ``torch.no_grad`` in the compute dtype;
* gradient accumulation averages the micro-batches' gradients and metrics.

The step updates the params and the moments in place (JAX donates their
buffers); the state it returns holds the same tensors. Moments are kept in
the params' dtype (fp32), as optax keeps them. The update runs a stacked
plane a layer at a time (its slices along its first axis): elementwise,
so the numbers are the whole leaf's, and its temporaries are a layer's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple

import torch

from onebit_tpu_torch.kernels.bitlinear import BitLinearWeights
from onebit_tpu_torch.model.bitllama import forward
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.parallel.mesh import Mesh2D
from onebit_tpu_torch.parallel.sharding import (MeshLayout, ShardGrads,
                                                model_partial, named_leaves,
                                                sharded_proj)
from onebit_tpu_torch.train.losses import (IGNORE_INDEX, KDConfig,
                                           kd_total_loss)
from onebit_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer/schedule hyperparameters (defaults = scripts/llama_7b.sh)."""
    learning_rate: float = 4e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.98
    weight_decay: float = 0.01
    warmup_steps: int = 500
    total_steps: int = 100_000
    max_grad_norm: float = 1.0
    lr_schedule: str = "cosine"   # "cosine" | "constant"
    min_lr_ratio: float = 0.0
    grad_accum_steps: int = 1     # reference llama_7b.sh:36 uses 4
    remat: bool = False           # gradient checkpointing (core.py:254-263)


ADAM_EPS = 1e-8   # optax.adamw's default


class AdamState(NamedTuple):
    count: int                  # updates applied so far
    mu: List[torch.Tensor]      # first moments, one per trainable leaf
    nu: List[torch.Tensor]      # second moments


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    step: int


def trainable_mask(params: Dict[str, Any]) -> Dict[str, Any]:
    """True for trainable leaves: only BitLinear float params (latent
    weight, weight_scale, input_factor, bias); embeddings, lm_head, norm
    weights and packed int words are frozen. The tree of the params, a bool
    (or None) in place of each leaf."""
    def mask_layers(val):
        if isinstance(val, BitLinearWeights):
            return BitLinearWeights(*(None if a is None
                                      else a.is_floating_point()
                                      for a in val))
        if isinstance(val, tuple):
            return type(val)(*(None if a is None else False for a in val))
        return False

    return {"embed_tokens": False, "lm_head": False, "final_norm": False,
            "layers": {k: mask_layers(v)
                       for k, v in params["layers"].items()}}


def _leaves(params: Dict[str, Any], mask: Dict[str, Any]):
    """(native key, leaf, trainable) in the JAX tree's order (dict keys
    sorted, named-tuple fields in order)."""
    out = []
    for key in sorted(params):
        if key != "layers":
            out.append((key, params[key], mask[key]))
            continue
        for name in sorted(params["layers"]):
            val, m = params["layers"][name], mask["layers"][name]
            if isinstance(val, tuple):
                out.extend((f"layers.{name}.{f}", a, t)
                           for f, a, t in zip(val._fields, val, m)
                           if a is not None)
            else:
                out.append((f"layers.{name}", val, m))
    return out


def named_trainable(params: Dict[str, Any]) -> List[tuple]:
    """Set ``requires_grad`` on the trainable leaves, clear it on the rest,
    and return ``(key, leaf)`` of the trainable ones in the JAX tree's
    order (the order of the moments)."""
    train = []
    for key, leaf, trainable in _leaves(params, trainable_mask(params)):
        leaf.requires_grad_(bool(trainable))
        if trainable:
            train.append((key, leaf))
    return train


def trainable_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """:func:`named_trainable`'s leaves."""
    return [leaf for _, leaf in named_trainable(params)]


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate of update ``count`` (from 0): optax's
    ``warmup_cosine_decay_schedule(0, lr, warmup, total, lr·min_lr_ratio)``
    or, for ``"constant"``, a linear warmup from 0 joined to a constant,
    their formulas written out."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps

    def linear(count):
        if warmup <= 0:
            return 0.0
        frac = 1 - min(max(count, 0), warmup) / warmup
        return (0.0 - peak) * frac + peak

    if cfg.lr_schedule == "cosine":
        decay_steps = cfg.total_steps - warmup
        if decay_steps <= 0:
            raise ValueError("the cosine schedule requires total_steps > "
                             f"warmup_steps, got {cfg.total_steps} and "
                             f"{warmup}")
        alpha = 0.0 if peak == 0.0 else peak * cfg.min_lr_ratio / peak

        def after(count):
            count = min(count, decay_steps)
            cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
            return peak * ((1 - alpha) * cosine + alpha)
    else:
        def after(count):
            return peak

    def schedule(count: int) -> float:
        return linear(count) if count < warmup else after(count - warmup)
    return schedule


def init_train_state(params: Dict[str, Any], cfg: TrainConfig
                     ) -> TrainState:
    """Mark the trainable leaves and zero their moments."""
    leaves = trainable_leaves(params)
    return TrainState(
        params=params,
        opt_state=AdamState(count=0,
                            mu=[torch.zeros_like(p) for p in leaves],
                            nu=[torch.zeros_like(p) for p in leaves]),
        step=0)


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: the square root of the sum of squares, fp32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def _slices(p, *ts):
    """``p`` and the same-shaped tensors ``ts`` (or lists of their layers)
    a layer at a time along the first axis when ``p`` is a stacked plane
    (3-d or more); whole otherwise (stacked vectors are small)."""
    if p.dim() < 3:
        yield (p, *ts)
        return
    for i in range(p.shape[0]):
        yield (p[i], *(t[i] for t in ts))


@torch.no_grad()
def _adamw_update(cfg: TrainConfig, schedule, leaves, grads,
                  opt: AdamState, norm=None) -> AdamState:
    """clip_by_global_norm then adamw (optax semantics), in place, a layer
    at a time. ``norm``: the global norm of the gradients when they are a
    rank's shards (default: theirs); a gradient may be a list of its
    layers. The clip is optax's ``(g / norm) · max_norm`` where ``norm >=
    max_norm``: ``(g / den) · num`` with the two scalars chosen once on the
    device, ``(norm, max_norm)`` or ``(1, 1)``, which leave ``g`` exact."""
    if norm is None:
        norm = global_norm(grads)
    clip = ~(norm < cfg.max_grad_norm)
    one = torch.ones_like(norm)
    den = torch.where(clip, norm, one)
    num = torch.where(clip, torch.full_like(norm, cfg.max_grad_norm), one)
    b1, b2 = cfg.adam_beta1, cfg.adam_beta2
    count = opt.count + 1
    # optax forms decay**count in fp32
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
    lr = schedule(opt.count)
    for p_all, g_all, mu_all, nu_all in zip(leaves, grads, opt.mu, opt.nu):
        for p, g, mu, nu in _slices(p_all, g_all, mu_all, nu_all):
            g = (g / den.to(g.dtype)) * num.to(g.dtype)
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1.to(mu.device)) / (
                torch.sqrt(nu / bc2.to(nu.device)) + ADAM_EPS)
            u = u + cfg.weight_decay * p
            p.add_(u * torch.tensor(-lr, dtype=u.dtype, device=u.device))
    return AdamState(count=count, mu=opt.mu, nu=opt.nu)


def _on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as int64 tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.long)
            for k, v in batch.items()}


def _build_loss(config: BitLlamaConfig, kd_cfg: KDConfig,
                train_cfg: TrainConfig, compute_dtype, impl: str,
                student_proj=None, teacher_proj=None, heads_group=None):
    """Shared loss plumbing of the train and eval steps: ``(loss_fn(params,
    teacher_out, batch, **denominators) -> (total, metrics),
    teacher_fwd(teacher_params, batch) -> teacher_out | None)``.
    ``student_proj``/``teacher_proj``: ``params -> Proj``, a sharded
    rank's strategies (default: one device's); ``heads_group``: the model
    group whose ranks hold the other attention heads."""
    need_hidden = kd_cfg.kd_beta > 0
    need_attn = kd_cfg.kd_gamma > 0
    use_teacher = kd_cfg.kd_loss_scale > 0 or need_hidden or need_attn

    def unpack(out):
        """(logits, hidden?, attn?) per the forward extras convention."""
        if not (need_hidden or need_attn):
            return out, None, None
        items = list(out)
        logits = items.pop(0)
        hidden = items.pop(0) if need_hidden else None
        attn = items.pop(0) if need_attn else None
        return logits, hidden, attn

    def run(params, batch, make_proj, **kw):
        return forward(params, batch["input_ids"], config, impl=impl,
                       attention_mask=batch.get("attention_mask"),
                       compute_dtype=compute_dtype,
                       output_hidden_states=need_hidden,
                       output_attentions=need_attn,
                       proj=make_proj and make_proj(params), **kw)

    def loss_fn(params, teacher_out, batch, **denominators):
        s_logits, s_hidden, s_attn = unpack(
            run(params, batch, student_proj, remat=train_cfg.remat))
        if teacher_out is None:
            t_logits, t_hidden, t_attn = s_logits.detach(), None, None
        else:
            t_logits, t_hidden, t_attn = unpack(teacher_out)
        return kd_total_loss(
            kd_cfg, student_logits=s_logits, teacher_logits=t_logits,
            labels=batch["labels"], student_hidden=s_hidden,
            teacher_hidden=t_hidden, student_attn=s_attn,
            teacher_attn=t_attn, num_layers=config.num_hidden_layers,
            heads_group=heads_group, **denominators)

    @torch.no_grad()
    def teacher_fwd(teacher_params, batch):
        if not use_teacher:
            # pure-CE stage (kd_alpha = 0 without distillation terms)
            return None
        return run(teacher_params, batch, teacher_proj)

    return loss_fn, teacher_fwd


def make_train_step(config: BitLlamaConfig, kd_cfg: KDConfig,
                    train_cfg: TrainConfig, *,
                    compute_dtype=torch.bfloat16, impl: str = "auto"):
    """The KD train step ``step(state, teacher_params, batch) -> (state,
    metrics)`` with ``batch = {"input_ids": [B, S], "labels": [B, S]}``
    (numpy or tensors; moved to the params' device). ``metrics``: 0-d
    tensors ``loss``, ``kd_loss``, ``student_loss`` (and ``pkd_loss``,
    ``attn_loss`` when those terms are on) averaged over the micro-batches,
    and ``grad_norm`` of the averaged gradients before the clip. ``impl``:
    ``"auto"`` (B11 and its backward kernels on the card) or ``"torch"``
    (the plain attention). ``step.grads(state, teacher_params, batch) ->
    (grads, metrics)``: the step without the update, the trainable leaves'
    averaged gradients in the moments' order. With tracing on
    (``utils/trace.py``) a step records ``kd.step`` around ``kd.teacher``,
    ``kd.forward`` and ``kd.backward`` (each a micro-batch) and
    ``kd.update`` (the clip and AdamW), each with its CUDA events."""
    accum = max(train_cfg.grad_accum_steps, 1)
    loss_fn, teacher_fwd = _build_loss(config, kd_cfg, train_cfg,
                                       compute_dtype, impl)
    schedule = make_schedule(train_cfg)

    def grads_of(state: TrainState, teacher_params, batch):
        params = state.params
        leaves = trainable_leaves(params)
        for p in leaves:
            p.grad = None
        batch = _on(batch, params["embed_tokens"].device)
        n = batch["input_ids"].shape[0]
        if n % accum:
            raise ValueError(f"batch {n} is not a multiple of "
                             f"grad_accum_steps {accum}")
        sums: Dict[str, torch.Tensor] = {}
        for m in range(accum):
            micro = {k: v[m * n // accum:(m + 1) * n // accum]
                     for k, v in batch.items()}
            with trace.span("kd.teacher", device=True):
                teacher_out = teacher_fwd(teacher_params, micro)
            with trace.span("kd.forward", device=True):
                loss, metrics = loss_fn(params, teacher_out, micro)
            del teacher_out
            with trace.span("kd.backward", device=True):
                loss.backward()
            for k, v in metrics.items():
                v = v.detach()
                sums[k] = v if k not in sums else sums[k] + v
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        if accum > 1:
            grads = [g / accum for g in grads]
            sums = {k: v / accum for k, v in sums.items()}
        sums["grad_norm"] = global_norm(grads)
        for p in leaves:
            p.grad = None
        return grads, sums

    def train_step(state: TrainState, teacher_params, batch):
        with trace.span("kd.step", device=True):
            grads, sums = grads_of(state, teacher_params, batch)
            with trace.span("kd.update", device=True):
                opt = _adamw_update(train_cfg, schedule,
                                    trainable_leaves(state.params), grads,
                                    state.opt_state, norm=sums["grad_norm"])
        return TrainState(state.params, opt, state.step + 1), sums

    train_step.grads = grads_of
    return train_step


def make_eval_step(config: BitLlamaConfig, kd_cfg: KDConfig,
                   train_cfg: TrainConfig, *,
                   compute_dtype=torch.bfloat16, impl: str = "auto"):
    """Loss-only step for held-out evaluation during training:
    ``eval_step(params, teacher_params, batch) -> metrics`` (the train
    step's keys but ``grad_norm``), no gradient or optimizer work."""
    loss_fn, teacher_fwd = _build_loss(config, kd_cfg, train_cfg,
                                       compute_dtype, impl)

    @torch.no_grad()
    def eval_step(params, teacher_params, batch):
        batch = _on(batch, params["embed_tokens"].device)
        _, metrics = loss_fn(params, teacher_fwd(teacher_params, batch),
                             batch)
        return metrics

    return eval_step


def make_sharded_train_step(config: BitLlamaConfig, kd_cfg: KDConfig,
                            train_cfg: TrainConfig, mesh: Mesh2D,
                            layout: MeshLayout, teacher_layout: MeshLayout,
                            *,
                            compute_dtype=torch.bfloat16,
                            impl: str = "auto"):
    """The KD train step of one rank of a ``(data, model)`` mesh, over its
    trees (``parallel/sharding.py`` ``shard_params``; the student's split
    by ``layout``, the teacher's by ``teacher_layout``), with its moments
    (:func:`init_train_state` of its tree): the function JAX's
    ``make_train_step`` computes on ``shard_params(..., mesh)``.

    ``step(state, teacher_params, batch)`` takes the GLOBAL batch, the
    same on every rank. Micro-batch ``m`` is rows ``[m·B/A, (m+1)·B/A)``
    of it (JAX's reshape), and the rank takes block ``data index`` of
    those rows (so ``B/A`` must divide by the data ranks): every rank of a
    model group sees the same rows. The losses are the data rank's shares
    of the micro-batch's global losses (its global batch size and count of
    valid tokens; ``train/losses.py``). Gradients:

    * a data-split latent plane's is reduce-scattered into the rank's
      shards as the backward reaches each layer, every other leaf's
      all-reduced over the data group after the last micro-batch;
    * a leaf split over the model ranks keeps its own gradient; a leaf
      whole over them of which each rank's backward gives a part
      (``model_partial``: a column-parallel projection's g, and the leaves
      of k and v kept whole) is summed over the model group first;
    * the clip takes the global norm: each leaf's squares summed over the
      ranks that hold distinct blocks of it, a leaf whole over an axis
      counted once;

    and AdamW updates the rank's shards and their moments. ``metrics`` are
    the global ones, the same on every rank. ``step.grads(state,
    teacher_params, batch) -> (grads, metrics)``: the step without the
    update; a data-split leaf's gradient is the list of its layers'
    shards. ``step.update(state, grads, metrics) -> (state, metrics)``:
    the update of that output (``step`` is ``grads`` then ``update``).
    ``step.eval_step(params, teacher_params, batch)``: the global
    metrics of the whole batch at once (``make_eval_step``'s), without
    gradients."""
    accum = max(train_cfg.grad_accum_steps, 1)
    schedule = make_schedule(train_cfg)
    data, model = mesh.data, mesh.model
    heads_group = model if model.size > 1 else None

    def step_losses(params, teacher_params, batch, parts, grads=None):
        """Yield ``(loss, metrics)`` of the rank's rows of each of the
        batch's ``parts`` micro-batches (a generator, so that the caller's
        backward runs before the next micro-batch's forward)."""
        device = params["embed_tokens"].device
        batch = _on(batch, device)
        n = batch["input_ids"].shape[0]
        if n % parts or (n // parts) % data.size:
            raise ValueError(
                f"batch {n} is not a multiple of {parts} micro-batch(es) x "
                f"{data.size} data ranks")
        micro_n = n // parts
        per = micro_n // data.size

        def proj(tree, layout_):
            return sharded_proj(tree, layout_, config, mesh, impl=impl,
                                compute_dtype=compute_dtype, grads=grads)

        loss_fn, teacher_fwd = _build_loss(
            config, kd_cfg, train_cfg, compute_dtype, impl,
            student_proj=lambda p: proj(p, layout),
            teacher_proj=lambda p: proj(p, teacher_layout),
            heads_group=heads_group)
        for m in range(parts):
            lo = m * micro_n
            mine = slice(lo + data.rank * per, lo + (data.rank + 1) * per)
            micro = {k: v[mine] for k, v in batch.items()}
            labels = batch["labels"][lo:lo + micro_n, 1:]
            teacher_out = teacher_fwd(teacher_params, micro)
            yield loss_fn(params, teacher_out, micro, batch_size=micro_n,
                          valid_tokens=(labels != IGNORE_INDEX).sum())

    def global_metrics(sums, parts):
        keys = sorted(sums)
        total = data.all_reduce(torch.stack([sums[k] for k in keys]))
        return dict(zip(keys, (total / parts).unbind()))

    def grads_of(state: TrainState, teacher_params, batch):
        params = state.params
        named = named_trainable(params)
        for _, p in named:
            p.grad = None
        grads = ShardGrads()
        sums: Dict[str, torch.Tensor] = {}
        for loss, metrics in step_losses(params, teacher_params, batch,
                                         accum, grads):
            loss.backward()
            for k, v in metrics.items():
                v = v.detach()
                sums[k] = v if k not in sums else sums[k] + v
        # the squares by (split over model, split over data)
        sq = {(a, b): torch.zeros((), device=sums["loss"].device)
              for a in (True, False) for b in (True, False)}
        out = []
        for key, p in named:
            partial = model_partial(key, layout)
            if key in layout.data:
                g = [torch.zeros_like(p[i]) if x is None else x
                     for i, x in enumerate(grads.grads.get(key)
                                           or [None] * p.shape[0])]
                g = [model.all_reduce(x) if partial else x for x in g]
                g = [x / accum for x in g] if accum > 1 else g
                part = sum((x.float() ** 2).sum() for x in g)
            else:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                g = data.all_reduce(model.all_reduce(g) if partial else g)
                g = g / accum if accum > 1 else g
                part = (g.float() ** 2).sum()
            bucket = (key in layout.model, key in layout.data)
            sq[bucket] = sq[bucket] + part
            out.append(g)
        del grads
        for _, p in named:
            p.grad = None
        metrics = global_metrics(sums, accum)
        both, m_only = model.all_reduce(
            torch.stack([sq[True, True], sq[True, False]])).unbind()
        both, d_only = data.all_reduce(
            torch.stack([both, sq[False, True]])).unbind()
        metrics["grad_norm"] = torch.sqrt(both + m_only + d_only
                                          + sq[False, False])
        return out, metrics

    def update(state: TrainState, grads, metrics):
        opt = _adamw_update(train_cfg, schedule,
                            trainable_leaves(state.params), grads,
                            state.opt_state, norm=metrics["grad_norm"])
        return TrainState(state.params, opt, state.step + 1), metrics

    def train_step(state: TrainState, teacher_params, batch):
        return update(state, *grads_of(state, teacher_params, batch))

    @torch.no_grad()
    def eval_step(params, teacher_params, batch):
        sums: Dict[str, torch.Tensor] = {}
        for _, metrics in step_losses(params, teacher_params, batch, 1):
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
        return global_metrics(sums, 1)

    train_step.grads = grads_of
    train_step.update = update
    train_step.eval_step = eval_step
    return train_step


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state as flat named tensors (the resume file's contents): the
    params under their native-checkpoint keys, the moments by trainable
    leaf index, and the step."""
    flat: Dict[str, torch.Tensor] = {
        "step": torch.tensor(state.step),
        "count": torch.tensor(state.opt_state.count)}
    for key, val in named_leaves(state.params):
        flat[f"params.{key}"] = val.detach()
    for i, (mu, nu) in enumerate(zip(state.opt_state.mu,
                                     state.opt_state.nu)):
        flat[f"mu.{i}"], flat[f"nu.{i}"] = mu, nu
    return flat


def load_state_tensors(template: TrainState,
                       flat: Dict[str, torch.Tensor]) -> TrainState:
    """Copy :func:`state_tensors`' output into ``template``'s tensors (in
    place) and return the state at the saved step."""
    with torch.no_grad():
        for key, val in named_leaves(template.params):
            val.copy_(flat[f"params.{key}"])
        for i, (mu, nu) in enumerate(zip(template.opt_state.mu,
                                         template.opt_state.nu)):
            mu.copy_(flat[f"mu.{i}"])
            nu.copy_(flat[f"nu.{i}"])
    opt = template.opt_state._replace(count=int(flat["count"]))
    return TrainState(template.params, opt, int(flat["step"]))


def clone_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of ``params`` whose leaves are new tensors (what ``run_kd``
    trains, so that the caller's params stay as they were)."""
    def c(t):
        return None if t is None else t.detach().clone()
    layers = {name: (type(val)(*(c(a) for a in val))
                     if isinstance(val, tuple) else c(val))
              for name, val in params["layers"].items()}
    return {**{k: c(v) for k, v in params.items() if k != "layers"},
            "layers": layers}
