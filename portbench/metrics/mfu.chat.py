"""The whole serving window's share of the chip: the least time of the
model work the window did (each decode token-step: every packed weight,
the lm_head and the decoding rows' KV read once, or its products at the
bf16 peak; each admitted prompt: the products of its real tokens) over the
window's wall seconds."""

from portbench import roofline

LAYER = "whole serving step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "output_tok_s"
WORKLOADS = ["mistral7b.chat", "deepseek7b.chat"]


def read(ctx):
    c = ctx.counters
    cfg, rows = ctx.cfg, c["max_batch"]
    steps = roofline.projections_work(cfg, rows) + \
        roofline.lm_head_work(cfg, rows)
    decode = roofline.Work(steps.bytes * c["token_steps"],
                           steps.flops * c["token_steps"])
    decode = decode + roofline.decode_attention_work(
        cfg, c["decode_lengths"], c["page_size"])
    prefill = sum(roofline.prompt_flops(cfg, n) for n in c["prompt_lens"])
    least = decode.least_s() + prefill / roofline.BF16_FLOP_PER_S
    return 100.0 * least / c["window_s"]
