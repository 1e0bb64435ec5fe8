"""Time the kernels of two checkouts of the port on one card, in turns.

    python scripts/torch_kernel_ab.py OTHER [--phases kernel_checks,flat_kernel_checks] [--rounds 2]
    python scripts/torch_kernel_ab.py build/parent --phases paged_kernel_checks,flash_kernel_checks

OTHER is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists). Each run builds that checkout's CUDA sources into its own
``build/kernels`` and calls the named phase functions of this checkout's
``chip_smoke.py`` (``kernel_checks``: K1-K3 and B4, the small-M kernels
timed cold over copies of their words; ``flat_kernel_checks``: B9 on the
flat pools, cycling over the 32 layers; ``kv_kernel_checks``: B5-B8;
``paged_kernel_checks``: B10; ``flash_kernel_checks``: B11;
``flash_bwd_kernel_checks``: B11-dkv/dq; ``kd_step_timing``: the device
ms of the fp32 KD micro-step at 7B width, 4 layers; the second line above
is the A/B of B10 and B11's redesigns), so that both checkouts' kernels
are driven and timed the same way, in a process of its own, in the order
OTHER, this, this, OTHER for two rounds. Every JSON line a phase prints
comes out with the checkout (``"other"`` or ``"this"``) and the run's index
added; a phase that raises (a kernel outside its tolerance) prints its
error and the run goes on. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import importlib.util, json, sys, traceback
import torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from onebit_tpu_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build()
dev = torch.device("cuda", 0)
for phase in sys.argv[1].split(","):
    try:
        getattr(cs, phase)(dev)
    except Exception as e:
        print(json.dumps({"phase": phase, "error": repr(e)}), flush=True)
"""


def run(checkout: str, label: str, index: int, phases: str) -> None:
    proc = subprocess.run([sys.executable, "-c", CHILD, phases,
                           os.path.join(ROOT, "chip_smoke.py")],
                          cwd=checkout, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict):
            print(json.dumps({"checkout": label, "run": index, **obj}),
                  flush=True)
    if proc.returncode != 0:
        print(json.dumps({"checkout": label, "run": index,
                          "returncode": proc.returncode,
                          "stderr": proc.stderr[-2000:]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--phases", default="kernel_checks,flat_kernel_checks")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    order = [(os.path.abspath(args.other), "other"), (ROOT, "this")]
    index = 0
    for r in range(args.rounds):
        for checkout, label in (order if r % 2 == 0 else order[::-1]):
            run(checkout, label, index, args.phases)
            index += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
