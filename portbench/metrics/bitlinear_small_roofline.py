"""K1/K2's share of their roofline in the profiled steady window: the
least time of every packed projection that the small-M kernels serve
(each decode token-step's seven projections at M = the engine's rows, and
any prefill call that runs at most 128 rows, at the rows its prompts
need), over the device time of the kernels named ``small_m_kernel``."""

from portbench import roofline
from portbench.devtrace import kernel_seconds

LAYER = "kernels K1/K2: small-M BitLinear (kernels/bitlinear_cuda.py, csrc/bitlinear_small_m.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "output_tok_s"
WORKLOADS = ["mistral7b.chat", "deepseek7b.chat"]
KERNELS = ("small_m_kernel",)


def read(ctx):
    if ctx.profile is None:
        return None
    spent = kernel_seconds(ctx.profile["kernels"], KERNELS)
    p = ctx.counters["prof"]
    work = [roofline.projections_work(ctx.cfg, ctx.counters["max_batch"])
            ] * p["token_steps"]
    work += [roofline.projections_work(ctx.cfg, need)
             for run, need in p["prefill_m"] if run <= 128]
    if spent <= 0 or not work:
        return None
    return 100.0 * roofline.total_least_s(work) / spent
