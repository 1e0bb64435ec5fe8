"""Drive the PyTorch port on one NVIDIA card and hold its kernels against
their plain versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit and PyTorch. It imports nothing of JAX. Phases, one JSON line each:

1. the device (``nvidia-smi`` name and power limit);
2. the build of every CUDA source (one ``nvcc`` each, all in parallel);
3. each BitLinear kernel at llama2-7b shapes against its plain PyTorch
   version, with random g and h (and h = 0 pads), timed with CUDA events
   beside its bound, its plain version and one PyTorch matmul;
4. the slice end to end at full llama2-7b width: random packed weights
   (``host_random_packed_params(seed=0)`` through the converter and
   ``fuse_for_decode``), ``ContinuousBatchingEngine(max_batch=8,
   max_len=256)`` serving 8 greedy requests, four of them with prompts of
   129-200 tokens so that prefill runs the large-M kernel. The first decode
   step's logits on the kernel path are held against ``impl="torch"``. Every
   kernel's launch count from the served run must be above 0.

Then the ``kernels`` line, the card's name and power limit as
``nvidia-smi`` prints them, and a last line ``{"ok": true, "device": ...}``.
Any failure exits nonzero without that line. Needs one card; exits nonzero
when no card is present or the package is not beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak
# bf16 LayerNorm outputs of order 1: two bf16 ulps at |v| < 8
KERNEL_TOL_BF16 = 0.0625
# relative to the largest |logit|: 32 layers of bf16 activations on each
# side, rounded at different places by kernel and plain version
LOGITS_REL_TOL = 5e-2

ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at llama2-7b shapes
# ---------------------------------------------------------------------------

def _case(gen, m, k, n_true, ns, seg_pad, dev):
    """Random bf16 x and g, fp32 h with zeros on the pads, random words."""
    from onebit_tpu_torch.core.packing import unpack_signs_kmajor
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    g = (1 + 0.5 * torch.randn(ns, k, generator=gen, device=dev)
         ).to(torch.bfloat16)
    h = torch.rand(ns, seg_pad, generator=gen, device=dev) + 0.5
    h[:, n_true:] = 0
    packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (k // 32, ns * seg_pad),
                           generator=gen, device=dev, dtype=torch.int64
                           ).to(torch.int32)
    sign = unpack_signs_kmajor(packed, dtype=torch.bfloat16)   # yardstick
    return dict(x=x, g=g, h=h.reshape(-1).contiguous(), packed=packed,
                sign=sign, m=m, k=k, n_true=n_true, ns=ns)


def _bound(c) -> tuple:
    """Least time for one call: inputs read once, outputs written once, or
    its products at the bf16 peak, whichever is larger."""
    m, k, ns, n_cat = c["m"], c["k"], c["ns"], c["packed"].shape[1]
    bytes_ = (c["packed"].numel() * 4 + m * k * 2 + ns * k * 2 + n_cat * 4
              + ns * m * c["n_true"] * 2)
    flops = 2 * m * k * ns * c["n_true"]
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def kernel_checks(dev) -> dict:
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d, inter = 4096, 11008
    # the calls one decode layer (M = 8) or one 8 x 256 prefill (M = 2048)
    # makes to each kernel at llama2-7b; the last K2 case has h = 0 pads
    cases = {
        "bitlinear_small_m": [_case(gen, 8, d, d, 1, d, dev),
                              _case(gen, 8, inter, d, 1, d, dev)],
        "bitlinear_fused_small_m": [_case(gen, 8, d, d, 3, d, dev),
                                    _case(gen, 8, d, inter, 2, inter, dev),
                                    _case(gen, 8, d, 4000, 3, 4096, dev)],
        "bitlinear_large_m": [_case(gen, 2048, d, d, 3, d, dev),
                              _case(gen, 2048, d, d, 1, d, dev),
                              _case(gen, 2048, d, inter, 2, inter, dev),
                              _case(gen, 2048, inter, d, 1, d, dev)],
    }

    def calls(name, c):
        x, p, g, h, nt = c["x"], c["packed"], c["g"], c["h"], c["n_true"]
        if name == "bitlinear_small_m":
            return (lambda: bc.small_m(x, p, g[0], h),
                    lambda: bc.small_m_torch(x, p, g[0], h))
        if name == "bitlinear_fused_small_m":
            return (lambda: bc.fused_small_m(x, p, g, h, n_true=nt),
                    lambda: bc.fused_small_m_torch(x, p, g, h, n_true=nt))
        return (lambda: bc.large_m(x, p, g, h, n_true=nt),
                lambda: bc.large_m_torch(x, p, g, h, n_true=nt))

    results = {}
    for info in bc.KERNELS:
        err = ms = plain_ms = lib_ms = bound_ms = 0.0
        kinds = set()
        for c in cases[info.name]:
            kern, plain = calls(info.name, c)
            got, want = kern().float(), plain().float()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{info.name}: non-finite output")
            e = (got - want).abs().max().item()
            err = max(err, e)
            iters = 3 if c["m"] > 128 else 20
            ms += cuda_ms(kern, iters)
            plain_ms += cuda_ms(plain, 2, warmup=1)
            y, s = c["x"] * c["g"][0], c["sign"]
            lib_ms += cuda_ms(lambda: torch.matmul(y, s.T), iters)
            b, kind = _bound(c)
            bound_ms += b
            kinds.add(kind)
        ok = err <= KERNEL_TOL_BF16
        results[info.name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="operations" if "operations" in kinds else "bytes",
            library_ms=lib_ms)
        emit({"phase": "kernel", "name": info.name, "tol": KERNEL_TOL_BF16,
              "ok": ok, "calls": len(cases[info.name]), "kernel_ms": ms,
              **results[info.name]})
        if not ok:
            raise RuntimeError(f"{info.name}: max_abs_err {err} > "
                               f"{KERNEL_TOL_BF16}")
    return results


# ---------------------------------------------------------------------------
# phase 4: the slice end to end at llama2-7b width
# ---------------------------------------------------------------------------

def smoke_prompts(seed: int = 0):
    """The 8 prompts of the served run: four of 129-200 tokens (one
    4 x 256-row prefill through K3), four under 32 (one 4 x 32-row prefill
    through K1/K2)."""
    rng = np.random.default_rng(seed)
    lengths = [129, 150, 175, 200, 5, 12, 20, 31]
    return [rng.integers(3, 32000, n).tolist() for n in lengths]


def end_to_end(dev) -> None:
    from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                                  fuse_for_decode, host_random_packed_params)
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.model.ragged_decode import ragged_decode_step

    config = BitLlamaConfig.named("llama2-7b")
    t0 = time.perf_counter()
    params = fuse_for_decode(host_random_packed_params(config, seed=0,
                                                       device=dev), config)
    torch.cuda.synchronize()
    emit({"phase": "weights", "config": "llama2-7b", "layers":
          config.num_hidden_layers, "seconds": time.perf_counter() - t0,
          "layers_keys": sorted(params["layers"])})
    prompts, new_tokens = smoke_prompts(), 32

    # the first decode step's logits, kernels against impl="torch"
    eng = ContinuousBatchingEngine(params, config, max_batch=8, max_len=256,
                                   device=dev)
    for p in prompts:
        eng.add_request(p, max_new_tokens=new_tokens)
    eng._admit()
    tokens = torch.from_numpy(eng.next_token[:, None].astype(np.int64)).to(dev)
    active = np.ones(8, bool)
    out = {}
    for impl in ("auto", "torch"):
        cache = type(eng.cache)(eng.cache.k.clone(), eng.cache.v.clone())
        out[impl], _ = ragged_decode_step(params, cache, tokens, eng.row_pos,
                                          active, config, impl=impl)
        del cache
    torch.cuda.synchronize()
    ref_scale = out["torch"].abs().max().item()
    err = (out["auto"] - out["torch"]).abs().max().item()
    agree = (out["auto"].argmax(-1) == out["torch"].argmax(-1)).float()
    check = {"phase": "logits_check", "max_abs_err": err,
             "max_abs_logit": ref_scale, "rel_err": err / ref_scale,
             "rel_tol": LOGITS_REL_TOL, "argmax_agree": agree.mean().item(),
             "finite": bool(torch.isfinite(out["auto"]).all())}
    emit(check)
    if not check["finite"] or check["rel_err"] > LOGITS_REL_TOL:
        raise RuntimeError(f"first-step logits disagree: {check}")
    del eng, out

    # the served run whose launches are counted
    eng = ContinuousBatchingEngine(params, config, max_batch=8, max_len=256,
                                   device=dev)
    torch.cuda.synchronize()
    bc.reset_launch_counts()
    t_start = time.perf_counter()
    uids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    step_s = []
    while eng.has_work():
        t = time.perf_counter()
        eng.step()
        step_s.append(time.perf_counter() - t)
    result = eng.run()
    wall = time.perf_counter() - t_start
    launches = {k.name: k.launches for k in bc.KERNELS}

    got = [result[u] for u in uids]
    if any(len(g) != new_tokens or not all(0 <= t < config.vocab_size
                                           for t in g) for g in got):
        raise RuntimeError(f"bad generations: {[len(g) for g in got]}")
    decode = step_s[1:new_tokens]         # all 8 rows active, no admission
    m = eng.metrics()
    emit({"phase": "serve", "requests": len(prompts),
          "prompt_lengths": [len(p) for p in prompts],
          "new_tokens": new_tokens, "steps": len(step_s),
          "first_step_ms": step_s[0] * 1e3,
          "decode_ms_per_step_median": float(np.median(decode)) * 1e3,
          "decode_tok_per_s": 8 / float(np.median(decode)),
          "ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
          "tpot_p50_s": m["tpot_p50_s"], "wall_s": wall,
          "generated_tokens": m["total_tokens"], "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    zero = [n for n, c in launches.items() if c == 0]
    if zero:
        raise RuntimeError(f"kernels never launched on the main path: {zero}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from onebit_tpu_torch.kernels import bitlinear_cuda as bc
        from onebit_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the onebit_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    per_source = build.build()
    logs = {s: build.library_path(s).with_name(build.library_path(s).name
                                                + ".log")
            for s in build.SOURCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source,
          "ptxas": {s: p.read_text()[-800:] for s, p in logs.items()
                    if p.exists()}})
    results = kernel_checks(dev)
    launches = end_to_end(dev)
    emit({"kernels": [
        {"name": k.name, "route": k.route, "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         **results[k.name]} for k in bc.KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
