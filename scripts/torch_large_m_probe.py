"""Two questions about K3 (csrc/bitlinear_large_m.cu) on one NVIDIA card.

    python scripts/torch_large_m_probe.py [--promote 0,2]

1. What share of K3's time is its LayerNorm launch: each call of one
   llama2-7b prefill layer (bf16, M = 2048) and one fp32 eval layer
   (M = 8192) timed whole and with ``raw=True`` (the projection alone).
2. What the fp32 instance's restarts of its accumulators buy: the same
   source built again with each ``kPromote`` of ``--promote`` (0: one
   accumulator over all of K, summed by the tensor cores alone; P: restart
   every P k tiles), each call's largest and root-mean-square error after
   the LayerNorm against the plain version, beside the time.

The cases and inputs are chip_smoke.py's (``_case``, seed 0). Prints one
JSON line per build and dtype, then the card's name and power limit. Needs
a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from onebit_tpu_torch.kernels import bitlinear_cuda as bc  # noqa: E402
from onebit_tpu_torch.kernels import build  # noqa: E402

PROMOTE = "kPromote = 8"


def build_variant(promote: int) -> ctypes.CDLL:
    """bitlinear_large_m.cu with kPromote = ``promote``, built beside the
    port's libraries."""
    src = (build.CSRC / "bitlinear_large_m.cu").read_text()
    if PROMOTE not in src:
        raise RuntimeError(f"{PROMOTE!r} not in the source")
    out = build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"bitlinear_large_m_promote{promote}.cu"
    cu.write_text(src.replace(PROMOTE, f"kPromote = {promote}"))
    lib = out / f"libbitlinear_large_m_promote{promote}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def launcher(lib: ctypes.CDLL, c: dict, raw: bool):
    """One call of K3 from ``lib`` on case ``c``, as the wrapper makes it."""
    fn = lib.onebit_bitlinear_large_m
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 7 + [i] * 8 + [f, p]
    fn.restype = i
    x, packed, g, h = c["x"], c["packed"], c["g"], c["h"]
    m, k = x.shape
    n, ns, n_true = packed.shape[1], g.shape[0], c["n_true"]
    z = torch.empty((m, n), dtype=x.dtype, device=x.device)
    out = z if raw else torch.empty((ns, m, n_true), dtype=x.dtype,
                                    device=x.device)

    def call():
        err = fn(x.data_ptr(), g.data_ptr(), packed.data_ptr(), h.data_ptr(),
                 None, z.data_ptr(), out.data_ptr(), m, k, n, ns, n // ns,
                 n_true, bc._DTYPE_CODES[x.dtype], int(raw), 1e-5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--promote", default="0",
                    help="comma-separated kPromote values to build besides "
                         "the port's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    libs = {"kPromote 8 (the port)": bc._large_m_lib()}
    for p in args.promote.split(","):
        libs[f"kPromote {int(p)}"] = build_variant(int(p))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d, inter, f32 = 4096, 11008, torch.float32
    layers = {
        "bfloat16": [cs._case(gen, 2048, d, d, 3, d, dev),
                     cs._case(gen, 2048, d, d, 1, d, dev),
                     cs._case(gen, 2048, d, inter, 2, inter, dev),
                     cs._case(gen, 2048, inter, d, 1, d, dev)],
        # an eval layer's seven calls: four of these, two, one
        "float32": [cs._case(gen, 8192, d, d, 1, d, dev, f32),
                    cs._case(gen, 8192, d, inter, 1, inter, dev, f32),
                    cs._case(gen, 8192, inter, d, 1, d, dev, f32)],
    }
    weights = {"bfloat16": [1, 1, 1, 1], "float32": [4, 2, 1]}
    for dtype, cases in layers.items():
        wants = [bc.large_m_torch(c["x"], c["packed"], c["g"], c["h"],
                                  n_true=c["n_true"]) for c in cases]
        for name, lib in libs.items():
            if dtype == "bfloat16" and name != "kPromote 8 (the port)":
                continue      # kPromote is the fp32 instance's alone
            ms = raw_ms = 0.0
            errs, rms = [], []
            for c, want, w in zip(cases, wants, weights[dtype]):
                got = launcher(lib, c, False)()
                torch.cuda.synchronize()
                diff = got.float() - want.float()
                errs.append(diff.abs().max().item())
                rms.append(diff.square().mean().sqrt().item())
                iters = 5 if dtype == "bfloat16" else 3
                ms += w * cs.cuda_ms(launcher(lib, c, False), iters)
                raw_ms += w * cs.cuda_ms(launcher(lib, c, True), iters)
            print(json.dumps({
                "build": name, "dtype": dtype,
                "calls": sum(weights[dtype]),
                "ms": ms, "projection_ms": raw_ms,
                "layernorm_ms": ms - raw_ms,
                "layernorm_share": (ms - raw_ms) / ms,
                "max_abs_err_per_shape": errs,
                "rms_err_per_shape": rms}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
