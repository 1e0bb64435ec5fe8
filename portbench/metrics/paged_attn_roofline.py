"""B10's share of its roofline in the profiled steady window: K and V
below each decoding row's length, at every layer, its page-table entries,
q and the fp32 output (``_paged_bound``'s count), for every decode token
emitted, over the device time of the kernels named ``paged_attention``."""

from portbench import roofline
from portbench.devtrace import kernel_seconds

LAYER = "kernel B10: paged decode attention (kernels/paged_attention.py, csrc/paged_attention.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "output_tok_s"
WORKLOADS = ["mistral7b.chat", "deepseek7b.chat"]
KERNELS = ("paged_attention",)


def read(ctx):
    if ctx.profile is None:
        return None
    spent = kernel_seconds(ctx.profile["kernels"], KERNELS)
    lengths = ctx.counters["prof"]["decode_lengths"]
    if spent <= 0 or not lengths:
        return None
    work = roofline.decode_attention_work(ctx.cfg, lengths,
                                          ctx.counters["page_size"])
    return 100.0 * work.least_s() / spent
