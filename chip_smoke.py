"""Drive the PyTorch port on one NVIDIA card and hold its kernels against
their plain versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit and PyTorch. It imports nothing of JAX. Phases, one JSON line each:

1. the device (``nvidia-smi`` name and power limit);
2. the build of every CUDA source (one ``nvcc`` each, all in parallel);
3. each BitLinear kernel (K1-K3) at llama2-7b shapes against its plain
   PyTorch version, with random g and h (and h = 0 pads), timed with CUDA
   events beside its bound, its plain version and one PyTorch matmul; then
   each KV-attention kernel (B5-B8) on full-size llama2-7b int8 and int4
   pools at layer 31 with ragged rows: pools bit-exact with the plain
   version, timed beside its bound, its plain version and one
   ``scaled_dot_product_attention`` on K/V dequantized beforehand;
4. the slice's paths end to end at full llama2-7b width and depth on random
   packed weights (``host_random_packed_params(seed=0)`` and
   ``fuse_for_decode``), each an 8-slot ``ContinuousBatchingEngine``
   serving 8 greedy requests of 32 new tokens:
   * the dense cache at ``max_len=256``, four prompts of 129-200 tokens
     (prefill through K3) and four under 32;
   * ``quantized_kv=True`` (int8 pools) and ``quantized_kv="int4"`` at
     ``max_len=2048``, prompts of 700-1900 tokens (buckets 1024 and 2048).
   Each first holds the first decode step's logits on the kernel path
   against ``impl="torch"``. Then a served run with every launch count set
   to 0 before it: K1-K3 must launch in each, and the fused append+attend
   kernel (B5, B7) exactly 32 times per decode step.

Then the wall time, the ``kernels`` line (each kernel's launches from the
run of its own path; B6 and B8 are on none), the card's name and power
limit as ``nvidia-smi`` prints them, and a last line ``{"ok": true,
"device": ...}``. Any failure exits nonzero without that line. Needs one
card; exits nonzero when no card is present or the package is not beside
this script.
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
# phase 3, continued: the KV-attention kernels at llama2-7b shapes
# ---------------------------------------------------------------------------

KV_SHAPE = (32, 8, 32, 128, 2048)      # L, B, nkv, hd, T: llama2-7b pools
KV_LAYER = 31
# ragged rows: both int4 planes (T/2 = 1024), tile edges, an inactive row
KV_LENGTHS = [2048, 1931, 1500, 1025, 1024, 777, 129, 0]
KV_FROZEN_POS = 700                    # the inactive row's write position
# Scales of 0.5-1.5 units over the integer range (int8 /127, int4 /7) give
# dequantized K/V of order 1, |v| < 1.8; q of std 5 gives scores of std
# about 3, a softmax peaked on a few positions, so ctx, an average of V
# rows, is of order 1 on every row. Kernel and plain version round each
# P * v_scale to bf16 (2**-9 relative) at different softmax maxima, and ctx
# to bf16 (ulp 2**-7 below 2): apart by at most 2**-8 * 1.8 + 2**-7 < 1/64.
# The tolerance is twice that, and each live row's largest |ctx| must be at
# least 8 times it, so that a kernel writing zeros or a wrong average fails.
KV_Q_STD = 5.0
KV_TOL_BF16 = 1 / 32


def _kv_bound(lengths, nkv, g, hd, t, int4, append) -> tuple:
    """Least time for one call: each row's K and V bytes up to its length
    (int4: min(length, T/2) byte columns, two positions a byte) and its
    scales read once, q read, ctx written, and with the append this step's
    K/V and scales read once and written once; or its products (4 per K/V
    element per query head) at the bf16 peak."""
    b = len(lengths)
    bytes_ = 2 * b * nkv * g * hd * 2                      # q in, ctx out
    flops = 0
    for n in lengths:
        cols = min(n, t // 2) if int4 else n
        bytes_ += nkv * (2 * hd * cols + 2 * 4 * n)
        flops += 4 * nkv * g * hd * n
    bytes_ += 4 * b * (2 if append else 1)                 # lengths, pos
    if append:
        bytes_ += 2 * b * nkv * (2 * hd + 2 * 4)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def _dequantized_layer(pools, int4, layer):
    """The layer's K and V in bf16, ``[B, nkv, T, hd]``: the input of the
    library yardstick, made before it is timed."""
    from onebit_tpu_torch.model.kv_cache import unpack_int4_halfplane
    k, ks, v, vs = (x[layer] for x in pools)
    if int4:
        k = unpack_int4_halfplane(k, axis=3)
        v = unpack_int4_halfplane(v, axis=1)
    k = (k.float() * ks[:, :, None, :]).permute(0, 1, 3, 2)
    v = (v.float() * vs[..., None]).permute(0, 2, 1, 3)
    return (k.to(torch.bfloat16).contiguous(),
            v.to(torch.bfloat16).contiguous())


def kv_kernel_checks(dev) -> dict:
    """B5-B8 on full-size llama2-7b pools at layer 31: bf16 q, random
    pools and scales, ragged rows. Pools must be bit-exact with the plain
    version after the call, ctx within KV_TOL_BF16 on the active rows (each
    with a largest |ctx| of at least 8 times it) and finite on the inactive
    one. Timed cycling over the 32 layers, so that
    each launch finds its layer's pools out of the L2 cache, as the decode
    step does."""
    import itertools
    import torch.nn.functional as F
    from onebit_tpu_torch.kernels import kv_attention as ka
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    n_layers, b, nkv, hd, t = KV_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lengths = torch.tensor(KV_LENGTHS, dtype=torch.int32, device=dev)
    pos = torch.tensor([n - 1 if n else KV_FROZEN_POS for n in KV_LENGTHS],
                       dtype=torch.int32, device=dev)
    q = (KV_Q_STD * torch.randn(b, nkv, hd, generator=gen, device=dev)
         ).to(torch.bfloat16)
    live = lengths > 0
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]
            )[:, None, None, :]

    def ints(*shape, lo, hi=128):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*shape, levels):
        return (torch.rand(shape, generator=gen, device=dev) + 0.5) / levels

    results = {}
    for int4 in (False, True):
        tb = t // 2 if int4 else t
        lo, new_lo, new_hi = (-128, -7, 8) if int4 else (-127, -127, 128)
        levels = 7 if int4 else 127
        pools = [ints(n_layers, b, nkv, hd, tb, lo=lo),
                 scales(n_layers, b, nkv, t, levels=levels),
                 ints(n_layers, b, tb, nkv, hd, lo=lo),
                 scales(n_layers, b, t, nkv, levels=levels)]
        new = [ints(b, nkv, hd, lo=new_lo, hi=new_hi),
               scales(b, nkv, levels=levels),
               ints(b, nkv, hd, lo=new_lo, hi=new_hi),
               scales(b, nkv, levels=levels)]
        k_deq, v_deq = _dequantized_layer(pools, int4, KV_LAYER)
        qs = q[:, :, None, :]
        pairs = ((ka.kv_attention_append_kt4, kc.APPEND_KT4, True),
                 (ka.kv_attention_decode_kt4, kc.DECODE_KT4, False)) \
            if int4 else ((ka.kv_attention_append_kt, kc.APPEND_KT, True),
                          (ka.kv_attention_decode_kt, kc.DECODE_KT, False))
        for kern, info, append in pairs:
            args = new if append else []
            extra = (pos,) if append else ()
            plain_pools = [x.clone() for x in pools]
            kern_pools = [x.clone() for x in pools]
            want = ka.PLAIN[kern](q, *args, *plain_pools, lengths, KV_LAYER,
                                  *extra)
            got = kern(q, *args, *kern_pools, lengths, KV_LAYER, *extra)
            torch.cuda.synchronize()
            exact = all(torch.equal(x, y)
                        for x, y in zip(kern_pools, plain_pools))
            finite = bool(torch.isfinite(got).all())
            err = (got[live].float() - want[live].float()).abs().max().item()
            # the smallest over live rows of the row's largest |ctx|
            ctx_scale = want[live].float().abs().amax(dim=(1, 2)).min().item()
            layer_of = itertools.cycle(range(n_layers))
            ms = cuda_ms(lambda: kern(q, *args, *kern_pools, lengths,
                                      next(layer_of), *extra), 32)
            plain_ms = cuda_ms(lambda: ka.PLAIN[kern](
                q, *args, *plain_pools, lengths, KV_LAYER, *extra), 3,
                warmup=1)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, k_deq, v_deq, attn_mask=mask), 32)
            bound_ms, bound_by = _kv_bound(KV_LENGTHS, nkv, 1, hd, t, int4,
                                           append)
            del plain_pools, kern_pools
            results[info.name] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
            ok = (exact and finite and err <= KV_TOL_BF16
                  and ctx_scale >= 8 * KV_TOL_BF16)
            emit({"phase": "kernel", "name": info.name, "tol": KV_TOL_BF16,
                  "ok": ok, "pools_bit_exact": exact, "ctx_finite": finite,
                  "min_row_max_abs_ctx": ctx_scale,
                  "layer": KV_LAYER, "pool_shape": list(KV_SHAPE),
                  "lengths": KV_LENGTHS, **results[info.name]})
            if not ok:
                raise RuntimeError(f"{info.name}: pools exact {exact}, "
                                   f"finite {finite}, max_abs_err {err}, "
                                   f"smallest row max |ctx| {ctx_scale}")
        del pools, new, k_deq, v_deq
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 4: the slice's paths end to end at llama2-7b width
# ---------------------------------------------------------------------------

def smoke_prompts(seed: int = 0):
    """The 8 prompts of the dense run: four of 129-200 tokens (one
    4 x 256-row prefill through K3), four under 32 (one 4 x 32-row prefill
    through K1/K2)."""
    rng = np.random.default_rng(seed)
    lengths = [129, 150, 175, 200, 5, 12, 20, 31]
    return [rng.integers(3, 32000, n).tolist() for n in lengths]


def deep_prompts(seed: int = 1):
    """The 8 prompts of the quantized runs: buckets 2048 and 1024, so
    prefill runs K3 at M = 8192 and 4096."""
    rng = np.random.default_rng(seed)
    lengths = [1900, 1800, 1700, 1500, 1000, 900, 800, 700]
    return [rng.integers(3, 32000, n).tolist() for n in lengths]


def all_kernels():
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    return bc.KERNELS + kc.KERNELS


def check_first_step(params, config, dev, prompts, new_tokens, max_len,
                     quantized_kv) -> None:
    """The first decode step's logits after admission, impl="auto" against
    impl="torch", each on its own copy of the cache."""
    from onebit_tpu_torch import ContinuousBatchingEngine
    from onebit_tpu_torch.model.ragged_decode import ragged_decode_step
    eng = ContinuousBatchingEngine(params, config, max_batch=8,
                                   max_len=max_len, quantized_kv=quantized_kv,
                                   device=dev)
    for p in prompts:
        eng.add_request(p, max_new_tokens=new_tokens)
    eng._admit()
    tokens = torch.from_numpy(eng.next_token[:, None].astype(np.int64)).to(dev)
    active = np.ones(8, bool)
    out = {}
    for impl in ("auto", "torch"):
        cache = type(eng.cache)(*(x.clone() for x in eng.cache))
        out[impl], _ = ragged_decode_step(params, cache, tokens, eng.row_pos,
                                          active, config, impl=impl)
        del cache
    torch.cuda.synchronize()
    ref_scale = out["torch"].abs().max().item()
    err = (out["auto"] - out["torch"]).abs().max().item()
    agree = (out["auto"].argmax(-1) == out["torch"].argmax(-1)).float()
    check = {"phase": "logits_check", "quantized_kv": quantized_kv,
             "max_abs_err": err, "max_abs_logit": ref_scale,
             "rel_err": err / ref_scale, "rel_tol": LOGITS_REL_TOL,
             "argmax_agree": agree.mean().item(),
             "finite": bool(torch.isfinite(out["auto"]).all())}
    emit(check)
    if not check["finite"] or check["rel_err"] > LOGITS_REL_TOL:
        raise RuntimeError(f"first-step logits disagree: {check}")


def served_run(params, config, dev, prompts, new_tokens, max_len,
               quantized_kv) -> dict:
    """One served run whose kernel launches are counted: every count is
    set to 0 just before it and read just after."""
    from onebit_tpu_torch import ContinuousBatchingEngine
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    eng = ContinuousBatchingEngine(params, config, max_batch=8,
                                   max_len=max_len, quantized_kv=quantized_kv,
                                   device=dev)
    pool_bytes = sum(x.numel() * x.element_size() for x in eng.cache)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in all_kernels():
        k.launches = 0
    t_start = time.perf_counter()
    uids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    step_s, decode_steps = [], 0
    while eng.has_work():
        t = time.perf_counter()
        eng._admit()
        decode_steps += any(s is not None for s in eng.slots)
        eng._decode()
        step_s.append(time.perf_counter() - t)
    result = eng.run()
    wall = time.perf_counter() - t_start
    launches = {k.name: k.launches for k in all_kernels()}

    got = [result[u] for u in uids]
    if any(len(g) != new_tokens or not all(0 <= t < config.vocab_size
                                           for t in g) for g in got):
        raise RuntimeError(f"bad generations: {[len(g) for g in got]}")
    decode = step_s[1:new_tokens]         # all 8 rows active, no admission
    m = eng.metrics()
    emit({"phase": "serve", "quantized_kv": quantized_kv,
          "max_len": max_len, "requests": len(prompts),
          "prompt_lengths": [len(p) for p in prompts],
          "new_tokens": new_tokens, "steps": len(step_s),
          "decode_steps": decode_steps, "first_step_ms": step_s[0] * 1e3,
          "decode_ms_per_step_median": float(np.median(decode)) * 1e3,
          "decode_tok_per_s": 8 / float(np.median(decode)),
          "ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
          "tpot_p50_s": m["tpot_p50_s"], "wall_s": wall,
          "generated_tokens": m["total_tokens"], "launches": launches,
          "pool_bytes": pool_bytes,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    bitlinear = [k.name for k in all_kernels()[:3]]
    zero = [n for n in bitlinear if launches[n] == 0]
    if zero:
        raise RuntimeError(f"kernels never launched on the main path: {zero}")
    if quantized_kv:
        fused = kc.APPEND_KT4 if quantized_kv == "int4" else kc.APPEND_KT
        want = config.num_hidden_layers * decode_steps
        if launches[fused.name] != want or decode_steps == 0:
            raise RuntimeError(f"{fused.name} launched "
                               f"{launches[fused.name]} times, not "
                               f"{want} (32 per decode step)")
    return launches


def end_to_end(dev) -> dict:
    """The dense path at max_len 256, then the int8 and the int4
    quantized-KV paths at max_len 2048, all at full llama2-7b width and
    depth on the same random weights. Returns each kernel's launches from
    the run of its own path."""
    from onebit_tpu_torch import (BitLlamaConfig, fuse_for_decode,
                                  host_random_packed_params)
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc

    config = BitLlamaConfig.named("llama2-7b")
    t0 = time.perf_counter()
    params = fuse_for_decode(host_random_packed_params(config, seed=0,
                                                       device=dev), config)
    torch.cuda.synchronize()
    emit({"phase": "weights", "config": "llama2-7b", "layers":
          config.num_hidden_layers, "seconds": time.perf_counter() - t0,
          "layers_keys": sorted(params["layers"])})
    launches = {}
    for prompts, max_len, quantized_kv, path_kernels in (
            (smoke_prompts(), 256, False, all_kernels()[:3]),
            (deep_prompts(), 2048, True, [kc.APPEND_KT]),
            (deep_prompts(), 2048, "int4", [kc.APPEND_KT4])):
        check_first_step(params, config, dev, prompts, 32, max_len,
                         quantized_kv)
        run = served_run(params, config, dev, prompts, 32, max_len,
                         quantized_kv)
        launches.update({k.name: run[k.name] for k in path_kernels})
        torch.cuda.empty_cache()
    # B6 and B8, the read-only variants, are on no path of the port
    return {k.name: launches.get(k.name, 0) for k in all_kernels()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from onebit_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the onebit_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_wall = time.perf_counter()
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
    results.update(kv_kernel_checks(dev))
    launches = end_to_end(dev)
    emit({"phase": "done", "wall_s": time.perf_counter() - t_wall})
    emit({"kernels": [
        {"name": k.name, "route": k.route, "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         **results[k.name]} for k in all_kernels()]})
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
