"""Where a decode step of the PyTorch port spends its time on the card.

    python scripts/torch_profile_decode.py [--steps 8] [--table PATH]
        [--kv-quant none|int8|int4] [--paged] [--block-steps N]

Serves a llama2-7b configuration of ``chip_smoke.py`` (random packed
weights from seed 0, the same 8 prompts): with ``--kv-quant none`` the
dense cache at ``max_len=256``, with ``int8`` or ``int4`` the quantized
pools at ``max_len=2048`` and the deep-context prompts of 700-1900 tokens;
with ``--paged`` KV pages of 16 positions at ``max_len=2048`` and the
deep-context prompts, bf16 pages (``--kv-quant none``) or int8 pages
(``int8``), whose decode attention runs kernel B10.
It admits all requests, times five decode steps (three blocks) without
the profiler, each alone (the device idle before it; also the warm-up),
then records ``--steps`` decode steps under ``torch.profiler`` after one
profiled warm-up step. Prints one JSON line: the host time per step
without the profiler (the median of those readings, as ``chip_smoke.py``'s
served runs take the median step, and each reading) and with it, the device time per step
summed over kernels, the device's busy and idle shares of the step
(device time over the unprofiled median: the profiler slows the host),
and the kernels by device time per step. With ``--block-steps N`` the engine decodes in
blocks of N steps, each one replayed CUDA graph (``engine/block_graph.py``):
an engine step is then a block, the windows hold ``ceil(--steps / N)``
blocks, and every number is given per token-step (a block's over N), with
the graph's capture seconds and pool bytes. ``--table`` also writes the
profiler's table. Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import deep_prompts, smoke_prompts  # noqa: E402
from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,  # noqa: E402
                              fuse_for_decode, host_random_packed_params)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--table", default=None,
                    help="also write the profiler's table to this file")
    ap.add_argument("--kv-quant", choices=("none", "int8", "int4"),
                    default="none")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--block-steps", type=int, default=1,
                    help="decode steps a block (one CUDA graph)")
    args = ap.parse_args()
    if args.paged and args.kv_quant == "int4":
        ap.error("--paged takes --kv-quant none or int8")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    config = BitLlamaConfig.named("llama2-7b")
    params = fuse_for_decode(host_random_packed_params(config, seed=0),
                             config)
    quantized_kv = {"none": False, "int8": True, "int4": "int4"}[args.kv_quant]
    deep = bool(quantized_kv) or args.paged
    n = args.block_steps
    windows = -(-args.steps // n)   # engine steps (blocks) a window
    reads = 5 if n == 1 else 3      # unprofiled engine steps, timed alone
    eng = ContinuousBatchingEngine(
        params, config, max_batch=8, max_len=2048 if deep else 256,
        quantized_kv=quantized_kv, paged=args.paged, page_size=16,
        block_steps=n)
    for prompt in deep_prompts() if deep else smoke_prompts():
        eng.add_request(prompt, max_new_tokens=(windows + 2 + reads) * n
                        + 1)
    eng.step()                      # admission and the first decode step
    plain = []
    for _ in range(reads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3 / n)
    plain_ms = sorted(plain)[reads // 2]
    # one profiled warm-up step before the recorded window: without it the
    # tracer misses the kernels of the window's first step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=windows,
                                   repeat=1)) as prof:
        eng.step()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(windows):
            eng.step()              # ends in a host read of the tokens
            prof.step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / windows / n
    steps = windows * n
    kernels = {}
    for evt in prof.key_averages():
        # device-side events only (kernels, copies): an operator's row
        # repeats the time of the kernels it launched, and the step
        # annotation spans them all
        us = _device_us(evt) if evt.device_type == DeviceType.CUDA else 0
        if us > 0 and not evt.key.startswith("ProfilerStep"):
            kernels[evt.key] = (us / 1e3 / steps, evt.count / steps)
    device_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "kv_quant": args.kv_quant, "paged": args.paged,
        "steps": steps, "block_steps": n,
        **({"capture_s": eng._graph.capture_s,
            "instantiate_s": eng._graph.instantiate_s,
            "graph_pool_bytes": eng._graph.pool_bytes}
           if eng._graph is not None else {}),
        "host_ms_per_step_unprofiled": plain_ms,
        "host_ms_per_step_unprofiled_each": plain,
        "host_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / plain_ms,
        "device_idle_share": 1 - device_ms / plain_ms,
        "kernels_per_step": sum(c for _, c in kernels.values()),
        "top": [{"name": k[:90], "ms_per_step": ms, "count_per_step": c}
                for k, (ms, c) in top]}), flush=True)
    if args.table:
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
