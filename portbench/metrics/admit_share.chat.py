"""Share of the window's wall time that the engine spends admitting: the
harness's span around ``ContinuousBatchingEngine._admit`` (the pipeline
flush, page reservation and the batched bucket prefill), summed over the
window, over the window's seconds."""

LAYER = "engine: admission and batched prefill (engine/batching.py)"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "output_tok_s"
WORKLOADS = ["mistral7b.chat", "deepseek7b.chat"]


def read(ctx):
    c = ctx.counters
    return 100.0 * c["admit_s"] / c["window_s"]
