"""Host milliseconds a decode token-step: the harness's span around
``ContinuousBatchingEngine._decode`` (block dispatch and replay, the
bookkeeping of the block before, pipeline waits), summed over the window,
over the token-steps it dispatched (blocks x block_steps)."""

LAYER = ("decode blocks and model step (engine/block_graph.py, "
         "engine/paged.py, model/ragged_decode.py)")
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "tpot_p90_ms"
WORKLOADS = ["mistral7b.chat", "deepseek7b.chat"]


def read(ctx):
    c = ctx.counters
    if not c["token_steps"]:
        return None
    return 1e3 * c["decode_s"] / c["token_steps"]
