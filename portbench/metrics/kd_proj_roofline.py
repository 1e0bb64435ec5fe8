"""The KD step's matrix products' share of their roofline in the profiled
steps: the teacher's forward and the student's forward and backward of
every projection, and of the lm_head, against the bf16 peak (+-1 signs and
bf16 activations are exact on the tensor cores), over the device time of
the GEMM kernels (the latent projections' products and the head's)."""

from portbench import roofline
from portbench.devtrace import kernel_seconds

LAYER = "KD projections (core/bitlinear.py bitlinear_raw, kernels/linear.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_tok_s"
WORKLOADS = ["mistral7b.kd"]
KERNELS = ("gemm", "Gemm", "GEMM", "nvjet", "cutlass", "xmma")


def read(ctx):
    if ctx.profile is None:
        return None
    spent = kernel_seconds(ctx.profile["kernels"], KERNELS)
    c = ctx.counters
    steps = c["prof"]["steps"]
    if spent <= 0 or not steps:
        return None
    flops = steps * roofline.kd_gemm_flops(ctx.cfg, c["batch"], c["seq"])
    return 100.0 * flops / roofline.BF16_FLOP_PER_S / spent
