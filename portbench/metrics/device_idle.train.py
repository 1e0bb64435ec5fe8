"""The device's idle share in the profiled steady window: one minus the
union of its kernels', copies' and sets' intervals over the window's wall
seconds, from the profiler's trace."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_tok_s"
WORKLOADS = ["mistral7b.kd"]


def read(ctx):
    if ctx.profile is None:
        return None
    p = ctx.profile
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
