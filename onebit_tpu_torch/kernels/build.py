"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``onebit_tpu_torch/csrc/*.cu`` file becomes one shared library with a
plain C interface, compiled for ``sm_90a`` at first use into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``).
A library's file name carries a hash of its sources and flags, so an edited
source is rebuilt. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("bitlinear_small_m.cu", "bitlinear_large_m.cu",
           "kv_attention_int8.cu", "kv_attention_int4.cu",
           "kv_attention_decode.cu", "paged_attention.cu",
           "flash_attention.cu", "flash_attention_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda = Path("/usr/local/cuda/bin/nvcc")
    path = str(cuda) if cuda.exists() else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        digest.update(f.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:12]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns seconds per source built (the
    wall time until that process ended). Raises on any failure, with the
    compiler's output. ptxas's register and shared-memory report is kept
    beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for src in todo:
        out = library_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    seconds, failures = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src}:\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _LIBS[source] = lib
        return lib
