"""Where a decode step of the PyTorch port spends its time on the card.

    python scripts/torch_profile_decode.py [--steps 8] [--table PATH]
        [--kv-quant none|int8|int4]

Serves a llama2-7b configuration of ``chip_smoke.py`` (random packed
weights from seed 0, the same 8 prompts): with ``--kv-quant none`` the
dense cache at ``max_len=256``, with ``int8`` or ``int4`` the quantized
pools at ``max_len=2048`` and the deep-context prompts of 700-1900 tokens.
It admits all requests, times three decode steps without the profiler
(also the warm-up), then records ``--steps`` decode steps under
``torch.profiler`` after one profiled warm-up step. Prints one JSON line:
the host time per step with and without the profiler, the device time per
step summed over kernels, the
device's busy and idle shares of the step (device time over the
unprofiled host time: the profiler slows the host), and the kernels by
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    config = BitLlamaConfig.named("llama2-7b")
    params = fuse_for_decode(host_random_packed_params(config, seed=0),
                             config)
    quantized_kv = {"none": False, "int8": True, "int4": "int4"}[args.kv_quant]
    eng = ContinuousBatchingEngine(
        params, config, max_batch=8, max_len=2048 if quantized_kv else 256,
        quantized_kv=quantized_kv)
    for prompt in deep_prompts() if quantized_kv else smoke_prompts():
        eng.add_request(prompt, max_new_tokens=args.steps + 6)
    eng.step()                      # admission and the first decode step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / 3
    # one profiled warm-up step before the recorded window: without it the
    # tracer misses the kernels of the window's first step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=args.steps,
                                   repeat=1)) as prof:
        eng.step()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()              # ends in a host read of the tokens
            prof.step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = {}
    for evt in prof.key_averages():
        # device-side events only (kernels, copies): an operator's row
        # repeats the time of the kernels it launched, and the step
        # annotation spans them all
        us = _device_us(evt) if evt.device_type == DeviceType.CUDA else 0
        if us > 0 and not evt.key.startswith("ProfilerStep"):
            kernels[evt.key] = (us / 1e3 / args.steps,
                                evt.count / args.steps)
    device_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "kv_quant": args.kv_quant, "steps": args.steps,
        "host_ms_per_step_unprofiled": plain_ms,
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
