"""K3's share of its roofline in the profiled steady window: every packed
projection of every prefill call that runs more than 128 rows (each chunk
is padded to the engine's chunk size, so every chunk does), counted at
the rows its prompts need (a last chunk's real rows, not its padding),
over the device time of the kernels named ``project_large_m`` and
``layernorm_segments`` (K3's projection and its LayerNorm)."""

from portbench import roofline
from portbench.devtrace import kernel_seconds

LAYER = "kernel K3: large-M BitLinear (kernels/bitlinear_cuda.py, csrc/bitlinear_large_m.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "ttft_p90_ms"
WORKLOADS = ["deepseek7b.rag"]
KERNELS = ("project_large_m", "layernorm_segments")


def read(ctx):
    if ctx.profile is None:
        return None
    spent = kernel_seconds(ctx.profile["kernels"], KERNELS)
    work = [roofline.projections_work(ctx.cfg, need)
            for run, need in ctx.counters["prof"]["prefill_m"] if run > 128]
    if spent <= 0 or not work:
        return None
    return 100.0 * roofline.total_least_s(work) / spent
