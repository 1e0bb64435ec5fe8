"""Where the time of B5-B8 goes (csrc/kv_attention_kt.cuh), on one NVIDIA
card.

    python scripts/torch_kt_probe.py [--variants kernel,no_attend,...]

Times the append instances B5 (int8) and B7 (int4) with bf16 q on
chip_smoke.py's layer-31 cases (llama2-7b pools, nkv 32 and the GQA nkv 8,
rows of ``KV_LENGTHS``), cycling over the 32 layers as chip_smoke.py does,
for the kernel as built and for variants of its source:

* ``no_attend``: the copies, merges and append without the tiles' scores,
  softmax and P . V (what the memory side costs);
* ``no_copy``: the tiles' arithmetic on whatever shared memory holds,
  without the copies (what the arithmetic costs);
* ``no_merge``: each chunk writes its partial and stops (what the ticket
  and the last chunk's merge cost); ``empty``: every CTA returns at once
  (the launch);
* ``half_chunk``, ``double_chunk``: chunks of half and twice the byte
  columns (more CTAs and shorter walks, or fewer and longer);
* ``tile_32``: warp tiles of 32 byte columns (K rows copied a 32-byte
  sector at a time; twice the shared memory);
* ``stages_3``, ``stages_4``: rings of 3 and 4 tiles a warp;
* ``warps_8``: CTAs of 8 warps;
* ``l2_256``: every 16-byte copy asks L2 to fetch the 256 bytes around it
  (``cp.async ... .L2::256B``).

Each is timed through the wrapper, its library function swapped for the
variant's. A variant's output is not checked (``no_attend`` and
``no_copy`` compute nothing meaningful); a launch that fails is reported.
Prints one JSON line per case (us a launch for each variant), then the
card's name and power limit. Needs a CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from onebit_tpu_torch.kernels import build  # noqa: E402
from onebit_tpu_torch.kernels import kv_attention as ka  # noqa: E402
from onebit_tpu_torch.kernels import kv_attention_cuda as kc  # noqa: E402

HEADER = "kv_attention_kt.cuh"
ATTEND = ("    attend_tile<T, HD, G, INT4, TILE>(st, q_s, pr_s, t0, TB, "
          "start, length,\n                                      hd_scale, "
          "lane, m, l, acc);\n")
COPY = "      copy_tile<HD, INT4, TILE>(ring + (k % kStages) * S::kBytes,\n"
SOURCES = ("kv_attention_int8.cu", "kv_attention_int4.cu")
STAGES = "constexpr int kStages = 2;"
EMPTY = "  // pool pointers carry no __restrict__/const: with APPEND the CTA"
L2_256 = ("using onebit_sm90::cp_async16;\n",
          "__device__ __forceinline__ void cp_async16(uint32_t dst, "
          "const void* src, bool valid) {\n  asm volatile(\"cp.async.cg."
          "shared.global.L2::256B [%0], [%1], 16, %2;\\n\" ::\"r\"(dst), "
          "\"l\"(src), \"r\"(valid ? 16 : 0) : \"memory\");\n}\n")
VARIANTS = {
    "no_attend": {HEADER: [(ATTEND, "")]},
    "no_copy": {HEADER: [(COPY, "      if (false) " + COPY.lstrip())]},
    "no_merge": {HEADER: [("  if (n_work == 1) return;\n", "  return;\n")]},
    "empty": {HEADER: [(EMPTY, "  return;\n" + EMPTY)]},
    "half_chunk": {s: [("kChunk = 256", "kChunk = 128")] for s in SOURCES},
    "double_chunk": {s: [("kChunk = 256", "kChunk = 512")] for s in SOURCES},
    "tile_32": {s: [("kTile = 16", "kTile = 32")] for s in SOURCES},
    "stages_3": {HEADER: [(STAGES, "constexpr int kStages = 3;")]},
    "stages_4": {HEADER: [(STAGES, "constexpr int kStages = 4;")]},
    "warps_8": {HEADER: [("constexpr int kThreads = 128;",
                          "constexpr int kThreads = 256;")]},
    "l2_256": {HEADER: [L2_256]},
}
CHUNK = {"kv_attention_int8.cu": kc.KT_CHUNK,
         "kv_attention_int4.cu": kc.KT4_CHUNK}
SCALE = {"half_chunk": 0.5, "double_chunk": 2}     # of the chunk


def build_variants(names) -> dict:
    """Each (variant, source): the source and its header with
    VARIANTS[name]'s replacements, built into build/kernels/probe/<name>/,
    all nvcc processes started together. Template statics stay local to
    each library (-fno-gnu-unique), so that no variant skips the
    shared-memory attribute another one set."""
    procs = {}
    for name, source in itertools.product(names, SOURCES):
        out = build.BUILD_DIR / "probe" / name
        out.mkdir(parents=True, exist_ok=True)
        for f in (HEADER, source):
            text = (build.CSRC / f).read_text()
            for old, new in VARIANTS.get(name, {}).get(f, []):
                if old not in text:
                    raise RuntimeError(f"{old!r} not in {f}")
                text = text.replace(old, new)
            (out / f).write_text(text)
        lib = out / f"lib{source[:-3]}.so"
        procs[name, source] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xcompiler",
             "-fno-gnu-unique", "-I", str(build.CSRC), "-o", str(lib),
             str(out / source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log[-4000:]}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def launcher(lib, source, q, new, pools, lengths, pos):
    """Calls of the append instance's wrapper, cycling over the layers, with
    the wrapper's library function taken from ``lib``."""
    fn = getattr(lib, kc._SYMBOLS[source])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 15 + [i] * 8 + [ctypes.c_longlong, f, p]
    fn.restype = i
    kern = (ka.kv_attention_append_kt4 if source.endswith("int4.cu")
            else ka.kv_attention_append_kt)
    layers = itertools.cycle(range(pools[0].shape[0]))

    def call():
        return kern(q, *new, *pools, lengths, next(layers), pos)
    return call, fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(["kernel", *VARIANTS]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    names = args.variants.split(",")
    wrapper_fn = kc._fn
    libs = build_variants(names)
    n_layers, b, nh, hd, t = cs.KV_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lengths = torch.tensor(cs.KV_LENGTHS, dtype=torch.int32, device=dev)
    pos = torch.tensor([n - 1 if n else cs.KV_FROZEN_POS
                        for n in cs.KV_LENGTHS], dtype=torch.int32,
                       device=dev)
    q = (cs.KV_Q_STD * torch.randn(b, nh, hd, generator=gen, device=dev)
         ).to(torch.bfloat16)
    for source, nkv in itertools.product(
            SOURCES,
            (nh, cs.FLASH_GQA_NKV)):
        int4 = source.endswith("int4.cu")
        tb = t // 2 if int4 else t
        new = [torch.randint(-7, 8, (b, nkv, hd), generator=gen,
                             device=dev, dtype=torch.int8),
               torch.rand(b, nkv, device=dev),
               torch.randint(-7, 8, (b, nkv, hd), generator=gen,
                             device=dev, dtype=torch.int8),
               torch.rand(b, nkv, device=dev)]
        pools = [torch.randint(-128, 128, (n_layers, b, nkv, hd, tb),
                               generator=gen, device=dev, dtype=torch.int8),
                 torch.rand(n_layers, b, nkv, t, device=dev) / 64,
                 torch.randint(-128, 128, (n_layers, b, tb, nkv, hd),
                               generator=gen, device=dev, dtype=torch.int8),
                 torch.rand(n_layers, b, t, nkv, device=dev) / 64]
        line = {"source": source, "nkv": nkv, "g": nh // nkv}
        for name in names:
            call, fn = launcher(libs[name, source], source, q, new, pools,
                                lengths, pos)
            kc._fn = lambda library, fn=fn: fn
            kc.KT_CHUNK, kc.KT4_CHUNK = (int(CHUNK[s] * SCALE.get(name, 1))
                                         for s in CHUNK)
            try:
                line[name + "_us"] = 1e3 * cs.cuda_ms(call, 32)
            except RuntimeError as e:
                line[name + "_error"] = str(e)
            finally:
                kc._fn = wrapper_fn
                kc.KT_CHUNK, kc.KT4_CHUNK = CHUNK.values()
        print(json.dumps(line), flush=True)
        del pools, new
        torch.cuda.empty_cache()
    shutil.rmtree(build.BUILD_DIR / "probe", ignore_errors=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
