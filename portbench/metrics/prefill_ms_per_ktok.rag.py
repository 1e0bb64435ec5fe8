"""Milliseconds of admission per thousand real prompt tokens: the
harness's span around ``ContinuousBatchingEngine._admit`` (chunked prefill
over pages, one request at a time), summed over the window, over the
prompt tokens it admitted."""

LAYER = "prefill: chunked prefill over pages (engine/paged.py, model/bitllama.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "ttft_p90_ms"
WORKLOADS = ["deepseek7b.rag"]


def read(ctx):
    c = ctx.counters
    tokens = sum(c["prompt_lens"])
    if not tokens:
        return None
    return 1e3 * c["admit_s"] / (tokens / 1e3)
