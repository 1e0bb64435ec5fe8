"""Where the small-M kernel's time goes (csrc/bitlinear_small_m.cu), on one
NVIDIA card.

    python scripts/torch_small_m_probe.py

For each call of one llama2-7b decode layer (M = 8: o_proj, down_proj,
q/k/v, gate/up, and B4's four mp = 2 shards), timed cold the way
chip_smoke.py times it (cycling over copies of the words past 64 MB):

* ``ms``: CUDA events around 20 calls enqueued behind a device sleep
  (``chip_smoke.cuda_ms``); ``raw_ms`` the same with ``raw=True`` (the
  projection without the LayerNorm; single projections only), so their
  difference is the LayerNorm's share; ``hot_ms`` on one copy of the words
  (L2-hot).

Then, on o_proj (raw and with the LayerNorm, hot), what
the time is made of: the source built again without its MMAs (``no_mma``:
the copies and the epilogue), without its copies (``no_copy``: the MMAs on
whatever shared memory holds, and the epilogue), without both
(``epilogue``), without the split partials' sum across the cluster
(``no_split_sum``, raw only), and with the LayerNorm's normalisers
stopping once they have the statistics (``no_normalise``); and every case
run with every plan (column tile, splits of K) the kernel takes (the
shards raw, the rest with the LayerNorm). These are timed like ``ms``, on
one copy of the words.

The cases and inputs are chip_smoke.py's (``_case``, seed 0). Prints one
JSON line per case, then the card's name and power limit. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import ctypes
import itertools
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

ITERS = 20


MMA_CALL = ("      mma_row<T, BN>(smem + (warp + kWarps * i) * L::kRowBytes, "
            "gr, tig, acc);\n")
COPY_CALL = ("      stage_row<T, BN>(a, base + j * L::kRowBytes, w_first + j, "
             "n0, m0, seg,\n                       lane);\n")
SPLIT_SUM = "  if (a.splits > 1) {\n"   # the sum still needs its peers
NORMALISE = ("  const int c0 = min(nt, slice * width), c1 = min(nt, c0 + width);"
             "\n")
VARIANTS = {"no_mma": (MMA_CALL,), "no_copy": (COPY_CALL,),
            "epilogue": (MMA_CALL, COPY_CALL),
            "no_split_sum": (SPLIT_SUM,), "no_normalise": (NORMALISE,)}
KEEP = {SPLIT_SUM: "  if (false) {\n",
        NORMALISE: "  const int c0 = nt, c1 = nt;\n"}


def build_variant(name: str) -> ctypes.CDLL:
    """bitlinear_small_m.cu with the lines of VARIANTS[name] taken out (the
    split sum skipped, for ``no_split_sum``)."""
    src = (build.CSRC / "bitlinear_small_m.cu").read_text()
    for line in VARIANTS[name]:
        if line not in src:
            raise RuntimeError(f"{line!r} not in the source")
        src = src.replace(line, KEEP.get(line, "      ;\n"))
    out = build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"bitlinear_small_m_{name}.cu"
    cu.write_text(src)
    lib = out / f"libbitlinear_small_m_{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def launcher(lib: ctypes.CDLL, c: dict, plan: tuple, raw: bool):
    """One call of the small-M kernel from ``lib`` on case ``c`` with
    ``plan`` (block_n, splits, kw, normalizers), as the wrapper makes
    it."""
    fn = lib.onebit_bitlinear_small_m
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 9 + [i] * 13 + [f, p]
    fn.restype = i
    x, g, h, packed = c["x"], c["g"], c["h"], c["packed"]
    (m, k), n, ns, nt = x.shape, packed.shape[1], c["ns"], c["n_true"]
    block_n, splits, kw, normalizers = plan
    tiles = -(-n // block_n)
    z = torch.empty((m, n), device=x.device)
    stats = torch.empty(2 * m * tiles, device=x.device)
    out = torch.empty((ns, m, nt), dtype=x.dtype, device=x.device)
    cnt = torch.zeros(2 * ns * -(-m // 8), dtype=torch.int32,
                      device=x.device)

    def call():
        err = fn(x.data_ptr(), g.data_ptr(), packed.data_ptr(), h.data_ptr(),
                 None, z.data_ptr(), stats.data_ptr(), out.data_ptr(),
                 cnt.data_ptr(), m, k, n, ns, n // ns, nt, 1, int(raw),
                 block_n, splits, kw, normalizers, 1, 1e-5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return call


CASES = {"o_proj": (4096, 4096, 1, 4096), "down_proj": (11008, 4096, 1, 4096),
         "qkv": (4096, 4096, 3, 4096), "gate_up": (4096, 11008, 2, 11008),
         "shard_q": (4096, 2048, 1, 2048),
         "shard_gate": (4096, 5504, 1, 5504),
         "shard_o": (2048, 4096, 1, 4096), "shard_down": (5504, 4096, 1, 4096)}


def parts(dev, gen) -> None:
    libs = {"kernel": build.load("bitlinear_small_m.cu")}
    libs.update({name: build_variant(name) for name in VARIANTS})
    for label, (k, n_true, ns, seg_pad) in CASES.items():
        c = cs._case(gen, 8, k, n_true, ns, seg_pad, dev)
        n = ns * seg_pad
        plan = bc.small_m_plan(8, k, n, ns)
        # the shards run raw (B4), the rest with the LayerNorm (K1, K2)
        raw = label.startswith("shard")
        if label == "o_proj":
            for r in (True, False):
                line = {"case": label, "raw": r, "plan": list(plan)}
                for name, lib in libs.items():
                    if name == ("no_normalise" if r else "no_split_sum"):
                        continue
                    line[name + "_us"] = 1e3 * cs.cuda_ms(
                        launcher(lib, c, plan, r), 50)
                print(json.dumps(line), flush=True)
        nw = k // 32
        for block_n in (64, 128):
            if ns > 1 and seg_pad % block_n:
                continue
            tiles = -(-n // block_n)
            for splits in range(1, bc.SMALL_M_MAX_SPLITS + 1):
                kw = -(-nw // splits)
                if kw > bc.SMALL_M_MAX_WORDS or -(-nw // kw) != splits:
                    continue
                sp = (block_n, splits, kw, min(plan[3], tiles // ns))
                print(json.dumps({
                    "case": label, "raw": raw, "plan": list(sp),
                    "ctas": tiles * splits,
                    "us": 1e3 * cs.cuda_ms(
                        launcher(libs["kernel"], c, sp, raw), 50)}),
                    flush=True)
        del c
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    build.build(["bitlinear_small_m.cu"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d, inter = 4096, 11008
    cases = {"o_proj": (d, d, 1, d), "down_proj": (inter, d, 1, d),
             "qkv": (d, d, 3, d), "gate_up": (d, inter, 2, inter),
             "shard_q": (d, d // 2, 1, d // 2),
             "shard_gate": (d, inter // 2, 1, inter // 2),
             "shard_o": (d // 2, d, 1, d), "shard_down": (inter // 2, d, 1, d)}
    for label, (k, n_true, ns, seg_pad) in cases.items():
        c = cs._case(gen, 8, k, n_true, ns, seg_pad, dev)
        x, g, h, nt = c["x"], c["g"], c["h"], c["n_true"]
        words = itertools.cycle(cs.cold_copies(c["packed"]))
        single = ns == 1

        def call(raw=False, p=None):
            p = next(words) if p is None else p
            if single:
                return bc.small_m(x, p, g[0], h, raw=raw)
            return bc.fused_small_m(x, p, g, h, n_true=nt)

        line = {"case": label, "k": k, "n": ns * seg_pad, "ns": ns,
                "plan": list(bc.small_m_plan(8, k, ns * seg_pad, ns)),
                "ms": cs.cuda_ms(call, ITERS),
                "hot_ms": cs.cuda_ms(lambda: call(p=c["packed"]), ITERS)}
        if single:
            line["raw_ms"] = cs.cuda_ms(lambda: call(raw=True), ITERS)
        print(json.dumps(line), flush=True)
        del c, words
        torch.cuda.empty_cache()
    parts(dev, gen)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
