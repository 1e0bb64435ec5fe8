"""Times one KD projection's product on one NVIDIA card: the tensor-core
path against the fp32 path.

    python scripts/torch_kd_proj_probe.py [--rows 8192] [--reps 10]

For each projection shape of a Mistral-7B layer (q/o 4096 -> 4096, k/v
4096 -> 1024, gate/up 4096 -> 14336, down 14336 -> 4096) at ``--rows``
rows (a KD step's 4 x 2048), ``core/bitlinear.py`` ``project_f32`` on bf16
operands: the forward alone under ``no_grad`` (the teacher's call), and
the forward with the backward to y and to an fp32 latent through the STE
(the student's call). Each on the tensor cores (``_Bf16Product``) and on
the fp32 product of the upcast operands (the path of fp32 operands),
beside its bound: the products' operations at the bf16 peak, one pass a
product (the backward's second bf16 pass not counted). CUDA events over
``--reps`` calls after two; the peak bytes of one student call above its
inputs; then one student call of each path profiled, the kernels by name.
Prints one JSON line a shape and path, then the card's name and power
limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from onebit_tpu_torch.core import bitlinear as cbl  # noqa: E402

BF16_PEAK = 989e12
SHAPES = {"q_o": (4096, 4096), "k_v": (4096, 1024),
          "gate_up": (4096, 14336), "down": (14336, 4096)}


def _path(tensor_cores: bool):
    cbl._on_tensor_cores = (
        lambda a, b: tensor_cores and a.dtype == b.dtype == torch.bfloat16)


def _ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _calls(m: int, k: int, n: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(k + n)
    y = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    lat = 0.01 * torch.randn(n, k, generator=gen, device="cuda")
    dz = torch.randn(m, n, generator=gen, device="cuda")
    y.requires_grad_()
    lat.requires_grad_()

    def teacher():
        with torch.no_grad():
            return cbl.project_f32(y, lat.to(torch.bfloat16))

    def student():
        z = cbl.project_f32(y, cbl.sign_ste(lat).to(torch.bfloat16))
        z.backward(dz)
        y.grad = lat.grad = None
    return teacher, student


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=8192)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    m = args.rows
    for name, (k, n) in SHAPES.items():
        teacher, student = _calls(m, k, n)
        flops = 2 * m * k * n
        for tensor_cores in (True, False):
            _path(tensor_cores)
            row = {"shape": name, "m": m, "k": k, "n": n,
                   "path": "tensor_cores" if tensor_cores else "fp32",
                   "forward_ms": _ms(teacher, args.reps),
                   "forward_bound_ms": 1e3 * flops / BF16_PEAK,
                   "student_ms": _ms(student, args.reps),
                   "student_bound_ms": 3e3 * flops / BF16_PEAK}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            student()
            row["student_peak_mb"] = (torch.cuda.max_memory_allocated()
                                      - base) / 2 ** 20
            row["student_tflop_s"] = 3 * flops / row["student_ms"] / 1e9
            print(json.dumps(row), flush=True)
    from torch.profiler import ProfilerActivity, profile
    _, student = _calls(m, *SHAPES["gate_up"])
    for tensor_cores in (True, False):
        _path(tensor_cores)
        student()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            student()
            torch.cuda.synchronize()
        kernels = sorted(((e.key[:90], round(e.device_time_total / 1e3, 3))
                          for e in prof.key_averages()
                          if e.device_time_total > 0),
                         key=lambda kv: -kv[1])
        print(json.dumps({"profiled": "gate_up student",
                          "path": "tensor_cores" if tensor_cores else "fp32",
                          "kernels_ms": kernels[:12]}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
