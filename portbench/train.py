"""A KD training cell's run: one object, the program's train step with its
model and optimizer state, driven from the seed through its first steps
in set-up and then through the measured window.

Set-up makes a random full-precision teacher on the device, lets the
program derive the student's SVID start (``core/build_start.py``) and its
AdamW state, and runs the recipe's first ``checked_steps`` steps through
the window's own call and feed (new rows every step): they are the
warm-up, and what the check compares. The window then runs whole steps
from the first step boundary for ``--seconds`` and to the end of the step
that crosses it; each step ends at ``torch.cuda.synchronize()``. A traced
run profiles ``PROFILE_STEPS`` more steps after the window. Then the
program's state is freed and the plain reference follows the checked steps
from the same seeded teacher and rows.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from portbench import reference, weights
from portbench.devtrace import Spans, device_summary

PROFILE_STEPS = 2        # steps a traced run profiles after the window


def _leaf_norms(named, tensors) -> Dict[str, float]:
    return {key: t.float().norm().item() for (key, _), t in
            zip(named, tensors)}


def run(run, out) -> None:
    """Set up, run the checked steps, measure, check (see
    ``serve.run``)."""
    cell, cfg, mix, dev = run.cell, run.cfg, run.mix, run.device
    if run.control:
        return _control(run, out)
    from onebit_tpu_torch.core.build_start import build_start_params
    from onebit_tpu_torch.model.config import BitLlamaConfig
    from onebit_tpu_torch.train.losses import KDConfig
    from onebit_tpu_torch.train.trainer import (TrainConfig,
                                                init_train_state,
                                                make_train_step,
                                                named_trainable)

    port_cfg = BitLlamaConfig.from_dict(cfg)
    b, s, vocab = mix["batch"], mix["seq_len"], cfg["vocab_size"]
    teacher = weights.to_port_teacher(weights.teacher(cfg, run.seed, dev))
    student = build_start_params(teacher)
    train_cfg = TrainConfig(**cell["train"])
    state = init_train_state(student, train_cfg)
    step = make_train_step(port_cfg, KDConfig(**cell["kd"]), train_cfg,
                           compute_dtype=torch.bfloat16)
    named = named_trainable(state.params)
    start = [leaf.detach().to("cpu", copy=True) for _, leaf in named]
    run.mark("engine")

    def feed(n):
        ids = weights.token_block(run.seed, n, b, s, vocab, dev)
        return {"input_ids": ids, "labels": ids}

    losses, grads = [], None
    for n in range(mix["checked_steps"]):
        state, m = step(state, teacher, feed(n))
        losses.append(m["loss"].item())
        if n == 0:
            # the first gradient as AdamW got it: mu = (1 - b1) g
            grads = {k: v / (1 - train_cfg.adam_beta1) for k, v in
                     _leaf_norms(named, state.opt_state.mu).items()}
    change = {key: (leaf.detach() - p0.to(dev)).norm().item()
              for (key, leaf), p0 in zip(named, start)}
    del start
    run.sync()
    run.mark("checked_steps")

    n = mix["checked_steps"]
    t_open = time.perf_counter()
    out.setup_s = t_open - run.t_start
    steps, t = 0, t_open
    while t < t_open + run.seconds:
        state, _ = step(state, teacher, feed(n + steps))
        run.sync()
        steps += 1
        t = time.perf_counter()
    window_s = t - t_open
    run.mark("window")
    out.attempted, out.failed = steps, 0
    out.e2e = {"train_tok_s": steps * b * s / window_s}
    out.notes.update({"window_s": window_s, "steps": steps,
                      "step_ms": 1e3 * window_s / steps,
                      "checked_losses": losses})
    if run.trace:
        # a few more steps under the profiler, after the window, so that
        # the profiler's own cost stays out of it
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        spans = Spans()
        spans.labelled = True
        with profile(activities=acts) as prof:
            tp0 = time.perf_counter()
            for i in range(PROFILE_STEPS):
                with spans.label("step"):
                    state, _ = step(state, teacher, feed(n + steps + i))
                    run.sync()
            tp1 = time.perf_counter()
        out.counters = {"window_s": window_s, "steps": steps, "batch": b,
                        "seq": s, "prof": {"steps": PROFILE_STEPS}}
        out.profile = (device_summary(prof, tp1 - tp0)
                       if dev.type == "cuda" else None)
        del prof
        run.mark("profile")
    out.peak_bytes = run.peak_bytes()
    del state, step, teacher, student, named
    gc.collect()
    run.free()
    run.mark("freed")

    ref = _reference(run, "fp32")
    run.mark("reference")
    out.check = compare({"loss": losses, "grad": grads, "change": change},
                        ref)
    out.notes["reference_losses"] = ref["loss"]
    out.notes["unmoved_leaves"] = sorted(
        set(ref["raw_grad"]) - set(reference.moved_leaves(ref["raw_grad"])))


def _reference(run, precision: str, rows=None) -> Dict:
    cfg, mix, dev = run.cfg, run.mix, run.device
    teacher_raw = weights.teacher(cfg, run.seed, dev)
    batches = [weights.token_block(run.seed, n, mix["batch"],
                                   mix["seq_len"], cfg["vocab_size"], dev)
               for n in range(mix["checked_steps"])]
    return reference.kd_reference(teacher_raw, cfg, batches,
                                  run.cell["kd"], run.cell["train"],
                                  precision=precision, rows=rows)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: each step's loss (the largest relative gap),
    the first gradient by the worst leaf, and the change over the checked
    steps by the worst leaf whose first raw gradient in the reference is
    at least a thousandth of the median leaf's."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                       ref["loss"]))
    grad_gap, _ = reference.leaf_gap(prog["grad"], ref["grad"])
    moved = reference.moved_leaves(ref["raw_grad"])
    change_gap, _ = reference.leaf_gap(prog["change"], ref["change"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def _control(run, out) -> None:
    """Readings for the limits, with no program: the fp32 reference
    against the fp8 control and against the reference with half of each
    batch left out (the mean over the other half)."""
    ref = _reference(run, "fp32")
    run.mark("reference")
    ctl = _reference(run, "fp8")
    run.mark("control")
    half = _reference(run, "fp32", rows=run.mix["batch"] // 2)
    run.mark("half_batch")
    out.setup_s = 0.0
    out.e2e = {}
    out.check = compare(ctl, ref)
    out.notes["half_batch"] = compare(half, ref)
    out.notes["reference_losses"] = ref["loss"]
