"""Collectives of two tensor-parallel ranks that share one card: what NCCL
says to them, and what one gloo all-reduce costs them.

    python scripts/torch_tp_probe.py [--timeout 120] [--iters 200]

Spawns two ranks with ``onebit_tpu_torch.parallel.mesh.spawn_tp`` and
``device="cuda"``; on a machine with one card both take ``cuda:0``.

1. On ``nccl``, each rank all-reduces one tensor: the error the launch
   raised (its last lines), or that the all-reduce completed.
2. On ``gloo``, each rank all-reduces the CUDA tensors of a llama2-7b
   tensor-parallel decode step at batch 8, ``--iters`` times each, the
   ranks' clocks starting together after a barrier: the column-parallel
   moments of q/k/v ([8, 6] fp32) and the row-parallel partial products
   ([8, 4096] fp32). Host ms per all-reduce, each ending in
   ``torch.cuda.synchronize()``.

Prints one JSON line, then the card's name and power limit. This is why
``chip_smoke.py`` runs its two ranks on ``gloo``, and what a decode step's
130 all-reduces (4 a layer, the embedding's and the lm_head's) cost there.
Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"moments_qkv": (8, 6), "row_partial": (8, 4096)}


def _all_reduce_once(group):
    t = torch.ones(4, device=group.device) * (group.rank + 1)
    group.all_reduce(t)
    torch.cuda.synchronize()
    return t.tolist()


def _all_reduce_ms(group, iters: int):
    import torch.distributed as dist
    out = {}
    for name, shape in SHAPES.items():
        t = torch.randn(shape, device=group.device)
        for _ in range(10):
            group.all_reduce(t)
        torch.cuda.synchronize()
        dist.barrier()
        start = time.perf_counter()
        for _ in range(iters):
            group.all_reduce(t)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - start) / iters * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is present", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from onebit_tpu_torch.parallel.mesh import spawn_tp
    line = {"ranks": 2, "device_count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nccl_version": ".".join(map(str, torch.cuda.nccl.version()))}
    try:
        spawn_tp(_all_reduce_once, 2, backend="nccl", device="cuda",
                 timeout=args.timeout)
        line["nccl_all_reduce_completed"] = True
    except (RuntimeError, TimeoutError) as e:
        line["nccl_all_reduce_completed"] = False
        line["nccl_error"] = str(e).strip().splitlines()[-6:]
    ms = spawn_tp(_all_reduce_ms, 2, backend="gloo", device="cuda",
                  timeout=args.timeout, args=(args.iters,))
    line["gloo_ms_per_all_reduce"] = {
        name: max(r[name] for r in ms) for name in SHAPES}
    line["shapes"] = SHAPES
    print(json.dumps(line), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
