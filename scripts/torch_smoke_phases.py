"""Run ``chip_smoke.py``'s serving-surface, task-harness, task-registry
and SFT phases alone on one card, and on request its decode-attention
kernel checks, its paged fp8 served runs, its tensor-parallel phase and
its parallel phase (fully sharded KD training, then tensor-parallel KD
training on the mesh (1, 2)).

    python scripts/torch_smoke_phases.py [serve_surface] [tasks] [registry]
        [sft] [attention_kernels] [paged_fp8] [tp] [serve_cli] [parallel]

Builds the CUDA sources, then runs ``serve_surface_checks`` on the fused
full-depth llama2-7b weights of ``chip_smoke.py``'s serving runs (with the
plain served runs it compares against, run here first) and
``serve_surface_cli`` on the 2-layer checkpoint under
``build/smoke_ckpt`` (written when missing); ``tasks_checks`` and
``registry_checks`` on the same weights unfused, as the evaluation phase
loads them (``host_random_packed_params(seed=0)``); and ``sft_checks``
(7B width, ``TRAIN_LAYERS`` layers), printing their JSON lines, the card's
name and power limit, and the wall seconds. All four phases by default.
``attention_kernels``: B10's and B9's checks (``paged_kernel_checks``,
``flat_kernel_checks``); ``paged_fp8``: the full-depth served run on fp8
pages and its block run (``served_run``, ``block_run``); ``tp``:
``tp_checks`` on the unfused weights; ``serve_cli``: ``serve_surface_cli``
alone (``serve_surface`` runs it too; with the multi-host ``serve --tp``);
``parallel``: ``parallel_checks``.
Each check raises as in ``chip_smoke.py``: a failure exits nonzero. Needs
a CUDA device; a few minutes with the build.
"""

from __future__ import annotations

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from onebit_tpu_torch import (BitLlamaConfig, fuse_for_decode,
                                  host_random_packed_params)
    from onebit_tpu_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = argv or ["serve_surface", "tasks", "registry", "sft"]
    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    build.build()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t})
    if "parallel" in phases:
        cs.parallel_checks(dev)
        torch.cuda.empty_cache()
    if "attention_kernels" in phases:
        cs.paged_kernel_checks(dev)
        cs.flat_kernel_checks(dev)
    if {"serve_surface", "tasks", "registry", "paged_fp8", "tp",
            "serve_cli"} & set(phases):
        config = BitLlamaConfig.named("llama2-7b")
        unfused = host_random_packed_params(config, seed=0, device=dev)
        if "paged_fp8" in phases:
            from onebit_tpu_torch.kernels import paged_attention_cuda as pc
            params = fuse_for_decode(unfused, config)
            opts = dict(max_len=2048, paged=True, page_size=16,
                        quantized_kv="fp8")
            cs.check_first_step(params, config, dev, cs.deep_prompts(), 32,
                                opts)
            _, tokens, _ = cs.served_run(params, config, dev,
                                         cs.deep_prompts(), 32, opts,
                                         pc.PAGED_FP8)
            cs.block_run(params, config, dev, cs.deep_prompts(), 32, opts,
                         pc.PAGED_FP8, tokens)
            del params
            torch.cuda.empty_cache()
        if "tp" in phases:
            cs.tp_checks(unfused, config, dev)
            torch.cuda.empty_cache()
        if "serve_surface" in phases:
            cs.serve_surface_checks(fuse_for_decode(unfused, config), config,
                                    dev)
            torch.cuda.empty_cache()
            cs.serve_surface_cli(dev)
        elif "serve_cli" in phases:
            cs.serve_surface_cli(dev)
        if "tasks" in phases:
            cs.tasks_checks(unfused, config, dev)
        if "registry" in phases:
            cs.registry_checks(unfused, config, dev)
        del unfused
        torch.cuda.empty_cache()
    if "sft" in phases:
        cs.sft_checks(dev)
    print(cs.nvidia_smi_line(), flush=True)
    cs.emit({"phase": "done", "wall_s": time.perf_counter() - t})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
