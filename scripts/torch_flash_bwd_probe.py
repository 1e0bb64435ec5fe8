"""Where the time of B11-dkv's and B11-dq's fp32 instances goes
(csrc/flash_attention_bwd.cu), on one NVIDIA card.

    python scripts/torch_flash_bwd_probe.py [--variants kernel,no_split,...]

Times both kernels on chip_smoke.py's fp32 case ([4, 2048, 32, 128], nkv
32, the residuals of B11's forward) for the kernel as built and for
variants of its source:

* ``no_split``: the walked tiles (Q and dO in B11-dkv, K and V in B11-dq)
  split into their bf16 parts at the first step only, the later steps
  reusing them (what the split of each step costs);
* ``no_mma``: no wgmma product issued, and what only feeds them left to
  the compiler to drop (what the products cost beside the rest);
* ``empty``: every CTA returns at once (the launch).

Each is timed through the wrappers of ``kernels/attention_cuda.py``, their
library functions swapped for the variant's. A variant's output is not
checked (none computes the gradients). Prints one JSON line per kernel
(ms for each variant), then the card's name and power limit. Needs a
CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from onebit_tpu_torch.kernels import attention_cuda as fc  # noqa: E402
from onebit_tpu_torch.kernels import build  # noqa: E402

SOURCE = "flash_attention_bwd.cu"
HEADER = "flash_attention_common.cuh"
DKV_SPLIT = "    split_tile<HD, 3, kSplitThreads>(qs, q + b * q_sb"
DKV_SPLIT_DO = "    split_tile<HD, 3, kSplitThreads>(\n        os, dout"
DQ_SPLIT = "    split_tile<HD, 3, kSplitThreads>(ks, kb, k_ss, k0, S);\n"
DQ_SPLIT_V = "    split_tile<HD, 3, kSplitThreads>(vs, vb, v_ss, k0, S);\n"
SPLIT_ENTRY = "flash_bwd_dkv_split(const float* __restrict__ q,"
VARIANTS = {
    "no_split": {SOURCE: [(DKV_SPLIT, "    if (it == 0)\n" + DKV_SPLIT),
                          (DKV_SPLIT_DO, "    if (it == 0)\n" + DKV_SPLIT_DO),
                          (DQ_SPLIT, "    if (kt == 0)\n" + DQ_SPLIT),
                          (DQ_SPLIT_V, "    if (kt == 0)\n" + DQ_SPLIT_V)]},
    "no_mma": {HEADER: [("    wgmma_ss_n64(d, ", "    (void)(d, "),
                        ("      wgmma_ss_n64(sm, ", "      (void)(sm, ")],
               SOURCE: [("      wgmma_rs_n64<1>(d, a[ap][kk],",
                         "      (void)(d, a[ap][kk],")]},
    "empty": {SOURCE: [("  using L = SplitBwdLayout<HD>;\n",
                        "  if (S > 0) return;\n  using L = "
                        "SplitBwdLayout<HD>;\n")]},
}


def build_variants(names) -> dict:
    """Each variant's library: the source and the shared header with
    VARIANTS[name]'s replacements, built into build/kernels/probe/<name>/,
    all nvcc processes started together (template statics kept local to
    each library with -fno-gnu-unique)."""
    procs = {}
    for name in names:
        out = build.BUILD_DIR / "probe" / name
        out.mkdir(parents=True, exist_ok=True)
        for f in sorted(p.name for p in build.CSRC.glob("*.cuh")) + [SOURCE]:
            text = (build.CSRC / f).read_text()
            for old, new in VARIANTS.get(name, {}).get(f, []):
                if old not in text:
                    raise RuntimeError(f"{old!r} not in {f}")
                text = text.replace(old, new)
            (out / f).write_text(text)
        lib = out / "libflash_attention_bwd.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xcompiler",
             "-fno-gnu-unique", "-o", str(lib), str(out / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(["kernel", *VARIANTS]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    names = args.variants.split(",")
    libs = build_variants(names)
    b, s, nh, hd = cs.FLASH_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    q = 5 * torch.randn(b, s, nh, hd, generator=gen, device=dev)
    k, v, do = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                for n in (nh, nh, nh))
    out, lse = fc.launch(q, k, v, 1, with_lse=True)
    di = (out * do).sum(-1).transpose(1, 2).contiguous()
    wrappers = {"dkv": (fc.launch_bwd_dkv, "_fn_dkv", "onebit_flash_bwd_dkv",
                        8),
                "dq": (fc.launch_bwd_dq, "_fn_dq", "onebit_flash_bwd_dq", 7)}
    for kernel, (launch, attr, symbol, n_ptr) in wrappers.items():
        line = {"kernel": kernel, "shape": [b, s, nh, hd], "nkv": nh}
        real = getattr(fc, attr)
        for name in names:
            fn = getattr(libs[name], symbol)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 8
                           + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            setattr(fc, attr, lambda fn=fn: fn)
            try:
                line[name + "_ms"] = cs.cuda_ms(
                    lambda: launch(q, k, v, do, lse, di, 1), 3)
            except RuntimeError as e:
                line[name + "_error"] = str(e)
            finally:
                setattr(fc, attr, real)
        print(json.dumps(line), flush=True)
    shutil.rmtree(build.BUILD_DIR / "probe", ignore_errors=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
