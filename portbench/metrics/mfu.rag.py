"""Prefill's share of the chip's peak: the products that the admitted
prompts' real tokens need (every projection, the causal attention, the
last token's lm_head) at the bf16 peak, over the harness's spans around
``ContinuousBatchingEngine._admit``."""

from portbench import roofline

LAYER = "whole prefill"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
MOVES = "ttft_p90_ms"
WORKLOADS = ["deepseek7b.rag"]


def read(ctx):
    c = ctx.counters
    if not c["prompt_lens"] or c["admit_s"] <= 0:
        return None
    flops = sum(roofline.prompt_flops(ctx.cfg, n) for n in c["prompt_lens"])
    return 100.0 * flops / roofline.BF16_FLOP_PER_S / c["admit_s"]
