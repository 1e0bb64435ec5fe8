"""Where a decode step of the PyTorch port spends its time on the card.

    python scripts/torch_profile_decode.py [--steps 8] [--table PATH]

Serves the llama2-7b configuration of ``chip_smoke.py`` (random packed
weights from seed 0, ``ContinuousBatchingEngine(max_batch=8, max_len=256)``,
the same 8 prompts), admits all requests, runs three decode steps to warm
up, then records ``--steps`` decode steps under ``torch.profiler``. Prints
one JSON line: the host time per step, the device time per step summed over
kernels, the device's busy and idle shares of the step, and the kernels by
device time per step. ``--table`` also writes the profiler's table. Needs a
card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import smoke_prompts  # noqa: E402
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    config = BitLlamaConfig.named("llama2-7b")
    params = fuse_for_decode(host_random_packed_params(config, seed=0),
                             config)
    eng = ContinuousBatchingEngine(params, config, max_batch=8, max_len=256)
    for prompt in smoke_prompts():
        eng.add_request(prompt, max_new_tokens=3 + args.steps + 1)
    eng.step()                      # admission and the first decode step
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = {}
    for evt in prof.key_averages():
        # device-side events only (kernels, copies): an operator's row
        # repeats the time of the kernels it launched
        us = _device_us(evt) if evt.device_type == DeviceType.CUDA else 0
        if us > 0:
            kernels[evt.key] = (us / 1e3 / args.steps,
                                evt.count / args.steps)
    device_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "steps": args.steps, "host_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_idle_share": 1 - device_ms / wall_ms,
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
