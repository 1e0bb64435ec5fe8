"""The KD step's model FLOP utilization: the operations that the
teacher's forward and the student's forward and backward require
(recomputation not counted), for every step completed in the window, over
the window's seconds times the bf16 peak."""

from portbench import roofline

LAYER = "whole KD step (train/trainer.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_tok_s"
WORKLOADS = ["mistral7b.kd"]


def read(ctx):
    c = ctx.counters
    flops = c["steps"] * roofline.kd_step_flops(ctx.cfg, c["batch"], c["seq"])
    return 100.0 * flops / roofline.BF16_FLOP_PER_S / c["window_s"]
