"""Where an eval batch's time goes: llama2-7b perplexity on one NVIDIA card.

    python scripts/torch_profile_eval.py [--batches 1] [--table PATH]

Builds the llama2-7b random packed params (``host_random_packed_params``,
seed 0, unfused as a checkpoint loads them), runs one batch of 4 x 2048
windows through ``window_nlls`` (what ``perplexity`` sums, fp32) as a
warm-up, times ``--batches`` more on the host clock without the profiler,
then runs them under ``torch.profiler``. Prints one JSON line: seconds per
batch and eval tokens/s (unprofiled), the device time per batch summed over
kernels, the device busy share (device over unprofiled host time), the
shares of K3 (``project_large_m`` and its LayerNorm epilogue
``layernorm_segments``) and B11 (``flash_causal``) in the device time, and
the kernels by device time. ``--table`` also writes the profiler's table.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from onebit_tpu_torch import BitLlamaConfig, host_random_packed_params  # noqa: E402
from onebit_tpu_torch.eval.ppl import window_nlls  # noqa: E402

SEQLEN, BATCH = 2048, 4
GROUPS = {"K3": ("project_large_m", "layernorm_segments"),
          "B11": ("flash_causal",)}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=1)
    ap.add_argument("--table", default=None,
                    help="also write the profiler's table to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    config = BitLlamaConfig.named("llama2-7b")
    params = host_random_packed_params(config, seed=0)
    tokens = np.random.default_rng(4).integers(
        3, config.vocab_size, (args.batches + 1) * BATCH * SEQLEN)

    def run(n_batches, skip):
        return window_nlls(params, config,
                           tokens[skip * BATCH * SEQLEN:],
                           seqlen=SEQLEN, batch_size=BATCH,
                           limit=n_batches * BATCH)

    run(1, 0)                                    # warm-up batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(args.batches, 1)
    host_s = (time.perf_counter() - t0) / args.batches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(args.batches, 1)
    kernels = {}
    for evt in prof.key_averages():
        # device-side events only: an operator's row repeats the time of
        # the kernels it launched
        us = _device_us(evt) if evt.device_type == DeviceType.CUDA else 0
        if us > 0:
            kernels[evt.key] = (us / 1e3 / args.batches,
                                evt.count / args.batches)
    device_ms = sum(ms for ms, _ in kernels.values())
    shares = {g: sum(ms for k, (ms, _) in kernels.items()
                     if any(p in k for p in pats)) / device_ms
              for g, pats in GROUPS.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "config": "llama2-7b", "layers": config.num_hidden_layers,
        "batch": [BATCH, SEQLEN], "dtype": "float32",
        "batches": args.batches,
        "host_s_per_batch_unprofiled": host_s,
        "eval_tok_per_s": BATCH * SEQLEN / host_s,
        "device_ms_per_batch": device_ms,
        "device_busy_share": device_ms / (host_s * 1e3),
        "device_share": shares,
        "kernels_per_batch": sum(c for _, c in kernels.values()),
        "top": [{"name": k[:90], "ms_per_batch": ms, "count_per_batch": c}
                for k, (ms, c) in top]}), flush=True)
    if args.table:
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
