"""Drive the PyTorch port on one NVIDIA card and hold its kernels against
their plain versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit and PyTorch. It imports nothing of JAX. Phases, one JSON line each:

1. the device (``nvidia-smi`` name and power limit);
2. the build of every CUDA source (one ``nvcc`` each, all in parallel),
   with each kernel's registers and spilled bytes as ``ptxas`` reports them;
3. each BitLinear kernel (K1-K3) at llama2-7b shapes against its plain
   PyTorch version, with random g and h (and h = 0 pads), timed with CUDA
   events beside its bound, its plain version and one PyTorch matmul (K3
   twice: bf16 at the prefill's M = 2048, and its fp32 instance on one eval
   layer's seven projections at M = 8192), and B4, the raw projection of a
   tensor-parallel shard (K1 and K3 with ``raw=True``, counted as their own
   instances), at the four shard shapes of llama2-7b over two ranks (M = 8,
   fp32 z; and M = 2048 on the q and down shards, bf16 z); then
   each KV-attention kernel (B5-B8) on full-size llama2-7b int8 and int4
   pools at layer 31 with ragged rows: pools bit-exact with the plain
   version, timed beside its bound, its plain version and one
   ``scaled_dot_product_attention`` on K/V dequantized beforehand; then B10
   (paged attention) on a full-size llama2-7b page pool, bf16 and int8
   pages, the same way; then B11 (causal flash attention) at the llama2-7b
   eval shape [4, 2048, 32, 128] and a GQA case (nkv 8) in fp32 and bf16,
   beside ``scaled_dot_product_attention(is_causal=True)``; then its
   backward kernels B11-dkv and B11-dq at the same shapes, the gradients
   through B11's autograd rule against autograd through the plain version,
   beside the backward of ``scaled_dot_product_attention``, each kernel
   with its bound share, ``ptxas`` registers and spills, and shared bytes a
   CTA; then B9 (decode
   attention over the flat pools) at layer 31 of full llama2-7b pools
   [32, 8, 2048, 32, 128], int8 with scales, bf16 (and a GQA case, nkv 8)
   and fp32, rows of 1-2048 positions with starts and one empty row, beside
   ``scaled_dot_product_attention`` with a boolean mask; last, each
   kernel's share of its bound (bound_ms / ms; K3's fp32 instance bounded
   by three bf16 tensor-core passes, the arithmetic it runs), none of which
   may pass 1;
4. the slice's paths end to end at full llama2-7b width and depth on random
   packed weights (``host_random_packed_params(seed=0)`` and
   ``fuse_for_decode``), each an 8-slot ``ContinuousBatchingEngine``
   serving 8 greedy requests of 32 new tokens:
   * the dense cache at ``max_len=256``, four prompts of 129-200 tokens
     (prefill through K3) and four under 32;
   * ``quantized_kv=True`` (int8 pools) and ``quantized_kv="int4"`` at
     ``max_len=2048``, prompts of 700-1900 tokens (buckets 1024 and 2048).
   * ``paged=True`` (page_size 16, max_len 2048) with bf16 pages and with
     int8 pages (``quantized_kv=True``), the same deep prompts: decode
     attention through the page tables in B10;
   * ``paged=True, prefix_cache=True``: eight prompts of one shared
     1024-token prefix and distinct suffixes of 100-450 tokens.
   Each but the prefix run first holds the first decode step's logits on
   the kernel path against ``impl="torch"``. Then a served run with every
   launch count set to 0 before it: K1-K3 must launch in each, B9 (dense),
   the fused append+attend kernel (B5, B7) or B10 exactly 32 times per
   decode step,
   every page must be back in the pool (the prefix run: all but those the
   cache holds), and the prefix run must reuse 7 x 64 = 448 pages. Then
   batch generation (:func:`generate_checks`): ``generate`` of the dense
   run's 8 prompts, left-padded, 32 greedy tokens in bf16 (B9 exactly
   32 x 31 times; its first decode step's logits against ``impl="torch"``,
   and a planted fault, one kv head of B9 zeroed in layer 0, that must break
   their limit) and 8 in fp32 (B9's fp32 instance 32 x 7 times); and
   ``decode_step_flat`` on a flat int8 ``QuantKVCache``: a multi-token
   prefill, then 8 one-token steps against ``impl="torch"`` (B9's int8
   instance exactly 256 times); then
   tensor-parallel serving (:func:`tp_checks`): two ranks sharing the card
   over ``gloo`` (NCCL refuses two ranks on one device), each an 8-slot
   engine with ``tp_group`` on the unfused weights at full width and
   depth; the first decode step's logits against the single-device
   engine's and ``impl="torch"``, with a planted fault (rank 1's share of
   layer 0's o_proj all-reduce dropped) that must break their limit; then
   served runs (dense at ``max_len=256``, int8 KV pools, paged int8 pages
   with the prefix cache) in which both ranks emit the same tokens, B4
   launches exactly 7 x 32 times per forward pass, B9, B5 or B10 exactly 32
   times per decode step and K1-K3 never;
5. evaluation at full llama2-7b width and depth on the same weights,
   unfused (:func:`eval_checks`): perplexity of 8 windows of 2048 at batch
   4 in fp32, direct and vocab-chunked, against ``impl="torch"`` per window
   (B11 32 times per batch); the first batch's pre-logits against
   ``impl="torch"``, and a planted fault (one head's B11 context zeroed in
   layer 0) that must break their limit; the uniform model's ppl of 32000;
   ``loglikelihood`` of 16 requests against ``impl="torch"``; ``forward`` in
   bf16; and ``python -m onebit_tpu_torch eval`` on a 2-layer native
   checkpoint of 7B width, its ppl equal to the in-process one; then on that
   checkpoint ``convert --format reference``, ``generate`` from the
   reference directory (the tokens of the in-process ``generate``) and
   ``eval --check-engines dense,kvq,int4,paged`` (``engine_check.ok`` 1);
6. KD training at llama2-7b width, depth cut to 4 layers
   (:func:`train_checks`): a random plain teacher and its SVID start
   student; the first KD step's loss and gradients on the kernel path
   against ``impl="torch"`` in fp32 and bf16, and a planted fault (one
   head's dq zeroed in layer 0) that must break the fp32 limit; three KD
   steps at the reference recipe (batch 4 x 2048, bf16): finite losses, B11
   2 x 4 x 3 and B11-dkv, B11-dq 4 x 3 launches, ms per step, training
   tokens/s, peak memory, device busy share; the trained student packed
   and one fp32 perplexity batch through K3 and B11; then
   ``build-start-ckpt``, ``train --tokens`` and ``convert`` on a 2-layer
   checkpoint of 7B width under ``build/``.

Then the wall time, the ``kernels`` line (each kernel's launches from the
run of its own path; B6 and B8 are on none; B4's from rank 0 of the dense
tensor-parallel run; B9's from the bf16 and fp32
``generate`` runs and the flat int8 run; B10's from the paged bf16 and
int8 runs; K3's fp32 instance's and B11's from the fp32 perplexity run,
B11 bf16's from the bf16 forward, B11-dkv's and B11-dq's fp32 instances'
from the fp32 gradient check of phase 6 and their bf16 instances' from
its three KD steps), the
card's name and power
limit as ``nvidia-smi`` prints them, and a last line ``{"ok": true,
"device": ...}``. Any failure exits nonzero without that line. Needs one
card; exits nonzero when no card is present or the package is not beside
this script.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12          # fp32 on the CUDA cores, no tensor cores
# bf16 LayerNorm outputs of order 1: two bf16 ulps at |v| < 8
KERNEL_TOL_BF16 = 0.0625
# fp32 (K3 in eval): kernel and plain version form the same fp32 y = x * g
# and sum its K = 4096 or 11008 signed terms in another order. Each add
# rounds by half an ulp of a partial sum of order sqrt(K) * |y|, so each
# side's sum strays by a random walk of about sqrt(K) * 2**-24 * |z|, a
# relative 4e-6 or less of the row's spread; the LayerNorm divides by that
# spread, so outputs of order 1 differ by a few 1e-6. The kernel sums the
# exact products of y's three bf16 parts on the tensor cores, whose fp32
# adds round toward zero, over 512 k at a time (then in fp32 registers):
# each such add loses up to a whole ulp, one way, so the largest of the
# 8192 x 11008 outputs lands a few 1e-5 off (rms about 1e-6;
# scripts/torch_large_m_probe.py). The tolerance is 1e-4.
KERNEL_TOL_F32 = 1e-4
# B4 at M <= 128 (fp32 z, no LayerNorm): both sides sum the same bf16-rounded
# y = x * g (|y| < 16) over K <= 5504 signed terms in fp32, in another
# order. Partial sums stay under 512, so each add rounds by at most 1.5e-5,
# and a random walk over 5504 adds strays about 1e-3; times h < 1.5. The
# tolerance is 1e-2; each row's largest |z| is about 250 (3.5 sqrt(K)).
RAW_TOL_F32 = 1e-2
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


def ptxas_summary(log: str) -> dict:
    """Each kernel's registers and spilled bytes from ``nvcc -Xptxas -v``
    output: {mangled name: [registers, spill stores, spill loads]}."""
    out = {}
    for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
            r"(\d+) bytes spill loads.*?Used (\d+) registers", log, re.S):
        out[m.group(1)] = [int(m.group(4)), int(m.group(2)),
                           int(m.group(3))]
    return out


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

def _case(gen, m, k, n_true, ns, seg_pad, dev, dtype=torch.bfloat16):
    """Random x and g in ``dtype``, fp32 h with zeros on the pads, random
    words."""
    from onebit_tpu_torch.core.packing import unpack_signs_kmajor
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    g = (1 + 0.5 * torch.randn(ns, k, generator=gen, device=dev)).to(dtype)
    h = torch.rand(ns, seg_pad, generator=gen, device=dev) + 0.5
    h[:, n_true:] = 0
    packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (k // 32, ns * seg_pad),
                           generator=gen, device=dev, dtype=torch.int64
                           ).to(torch.int32)
    sign = unpack_signs_kmajor(packed, dtype=dtype)            # yardstick
    return dict(x=x, g=g, h=h.reshape(-1).contiguous(), packed=packed,
                sign=sign, m=m, k=k, n_true=n_true, ns=ns)


# K3's fp32 instance multiplies on the bf16 tensor cores in three passes
# (y split into three bf16 parts, each product with the ±1 signs exact)
K3_F32_PASSES = 3


def _bound(c, out_elem=None) -> tuple:
    """Least time for one call: inputs read once, outputs written once
    (``out_elem`` bytes each, x's by default), or its products at the bf16
    tensor-core peak (K3's fp32 instance: three bf16 passes), whichever is
    larger."""
    m, k, ns, n_cat = c["m"], c["k"], c["ns"], c["packed"].shape[1]
    elem = c["x"].element_size()
    bytes_ = (c["packed"].numel() * 4 + m * k * elem + ns * k * elem
              + n_cat * 4 + ns * m * c["n_true"] * (out_elem or elem))
    flops = 2 * m * k * ns * c["n_true"]
    if c["x"].dtype == torch.float32:
        flops *= K3_F32_PASSES
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def kernel_checks(dev) -> dict:
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d, inter = 4096, 11008
    m_eval, f32 = 4 * 2048, torch.float32     # one eval batch, fp32
    # the calls one decode layer (M = 8) or one 8 x 256 prefill (M = 2048)
    # makes to each kernel at llama2-7b; the last K2 case has h = 0 pads;
    # K3's fp32 instance: one eval layer's seven unfused projections
    # (q, k, v, o; gate, up; down) on a 4 x 2048 batch
    # B4 (K1/K3 raw) at the shards of tensor-parallel llama2-7b over two
    # ranks: q/k/v and gate/up column-parallel (K x N/2), o and down
    # row-parallel (K/2 x N; down's 5504 ends in a partial 1024-k chunk),
    # at decode's M = 8; the large-M instance at an admission's M = 2048 on
    # the q and down shards
    cases = {
        "bitlinear_raw_small_m": [_case(gen, 8, d, d // 2, 1, d // 2, dev),
                                  _case(gen, 8, d, inter // 2, 1, inter // 2,
                                        dev),
                                  _case(gen, 8, d // 2, d, 1, d, dev),
                                  _case(gen, 8, inter // 2, d, 1, d, dev)],
        "bitlinear_raw_large_m": [_case(gen, 2048, d, d // 2, 1, d // 2,
                                        dev),
                                  _case(gen, 2048, inter // 2, d, 1, d, dev)],
        "bitlinear_small_m": [_case(gen, 8, d, d, 1, d, dev),
                              _case(gen, 8, inter, d, 1, d, dev)],
        "bitlinear_fused_small_m": [_case(gen, 8, d, d, 3, d, dev),
                                    _case(gen, 8, d, inter, 2, inter, dev),
                                    _case(gen, 8, d, 4000, 3, 4096, dev)],
        "bitlinear_large_m": [_case(gen, 2048, d, d, 3, d, dev),
                              _case(gen, 2048, d, d, 1, d, dev),
                              _case(gen, 2048, d, inter, 2, inter, dev),
                              _case(gen, 2048, inter, d, 1, d, dev)],
        "bitlinear_large_m_f32":
            [_case(gen, m_eval, d, d, 1, d, dev, f32) for _ in range(4)]
            + [_case(gen, m_eval, d, inter, 1, inter, dev, f32)
               for _ in range(2)]
            + [_case(gen, m_eval, inter, d, 1, d, dev, f32)],
    }

    def calls(name, c):
        x, p, g, h, nt = c["x"], c["packed"], c["g"], c["h"], c["n_true"]
        if name == "bitlinear_raw_small_m":
            return (lambda: bc.small_m(x, p, g[0], h, raw=True),
                    lambda: bc.small_m_torch(x, p, g[0], h, raw=True))
        if name == "bitlinear_raw_large_m":
            return (lambda: bc.large_m(x, p, g, h, n_true=nt, raw=True),
                    lambda: bc.large_m_torch(x, p, g, h, n_true=nt,
                                             raw=True))
        if name == "bitlinear_small_m":
            return (lambda: bc.small_m(x, p, g[0], h),
                    lambda: bc.small_m_torch(x, p, g[0], h))
        if name == "bitlinear_fused_small_m":
            return (lambda: bc.fused_small_m(x, p, g, h, n_true=nt),
                    lambda: bc.fused_small_m_torch(x, p, g, h, n_true=nt))
        return (lambda: bc.large_m(x, p, g, h, n_true=nt),
                lambda: bc.large_m_torch(x, p, g, h, n_true=nt))

    def row_tol(name, want):
        """Each row's tolerance: B4's large-M z is stored in bf16, and a z
        near a rounding boundary rounds the other way on the other side:
        one bf16 ulp of the row's largest |z|."""
        if name == "bitlinear_raw_large_m":
            top = want.float().abs().amax(-1, keepdim=True)
            return torch.exp2(torch.floor(torch.log2(top)) - 7)
        if name == "bitlinear_raw_small_m":
            return torch.full_like(want[:, :1], RAW_TOL_F32)
        f32 = want.dtype == torch.float32
        return torch.full_like(want[..., :1], KERNEL_TOL_F32 if f32
                               else KERNEL_TOL_BF16)

    results = {}
    for info in bc.KERNELS:
        err = ms = plain_ms = lib_ms = bound_ms = 0.0
        out_scale, ok = float("inf"), True
        kinds = set()
        dtype = cases[info.name][0]["x"].dtype
        for c in cases[info.name]:
            kern, plain = calls(info.name, c)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{info.name}: non-finite output")
            tol = row_tol(info.name, want)
            got, want = got.float(), want.float()
            diff = (got - want).abs()
            err = max(err, diff.max().item())
            # the smallest row's largest |out|: LayerNorm rows of unit
            # variance, so at least 1 unless the output is wrong; B4's raw z
            # rows reach about 3.5 sqrt(K)
            top = want.abs().amax(dim=-1, keepdim=True)
            out_scale = min(out_scale, top.min().item())
            ok = ok and bool((diff <= tol).all()) and \
                bool((top >= 8 * tol).all())
            # B4 at M <= 128 writes fp32 z
            out_elem = 4 if info.name == "bitlinear_raw_small_m" else None
            del got, want, diff
            iters = 3 if c["m"] > 128 else 20
            ms += cuda_ms(kern, iters)
            plain_ms += cuda_ms(plain, 2, warmup=1)
            y, s = c["x"] * c["g"][0], c["sign"]
            lib_ms += cuda_ms(lambda: torch.matmul(y, s.T), iters)
            b, kind = _bound(c, out_elem)
            bound_ms += b
            kinds.add(kind)
        results[info.name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="operations" if "operations" in kinds else "bytes",
            library_ms=lib_ms)
        basis = results[info.name]["bound_by"] + (
            f", {K3_F32_PASSES} bf16 tensor-core passes"
            if dtype == torch.float32 else "")
        tol = {"bitlinear_raw_large_m": "one bf16 ulp of each row's largest "
                                        "|z|",
               "bitlinear_raw_small_m": RAW_TOL_F32}.get(
            info.name, KERNEL_TOL_F32 if dtype == torch.float32
            else KERNEL_TOL_BF16)
        emit({"phase": "kernel", "name": info.name, "tol": tol, "ok": ok,
              "dtype": str(dtype).replace("torch.", ""),
              "m": [c["m"] for c in cases[info.name]],
              "k_n": [[c["k"], c["n_true"]] for c in cases[info.name]],
              "calls": len(cases[info.name]), "kernel_ms": ms,
              "min_row_max_abs_out": out_scale, "bound_basis": basis,
              **results[info.name]})
        if not ok:
            raise RuntimeError(f"{info.name}: max_abs_err {err} over its "
                               f"tolerance {tol}, or smallest row max |out| "
                               f"{out_scale} under 8 times it")
        del cases[info.name]
        torch.cuda.empty_cache()
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
# phase 3, continued: B10 on a full-size llama2-7b page pool
# ---------------------------------------------------------------------------

# L, P, nkv, ps, hd: the engine's default pool for llama2-7b at max_batch 8
# and max_len 2048 (8 x 128 pages + the null page), 2**31.0003 elements
PAGED_SHAPE = (32, 1025, 32, 16, 128)
PAGED_MP = 128                         # pages per row at max_len 2048
# Float pages of N(0, 1), int8 pages with raw absmax scales of 64/127.5 -
# 191/127.5 (the integer range dequantizes to about +-0.5-1.5), q of std 5:
# a context of order 1 on every live row. Both sides give float32 from the
# same dequantized operands; they round each P = exp(s - m) to bf16 (2**-9
# relative) at different softmax maxima, so they lie at most
# 2 * 2**-9 * max |v| apart. Float pages: under 1/32 for |v| < 8 (N(0, 1)
# over 2**31 samples stays below 6.5). Int8 pages: |v| <= 127/127.5 *
# 191/127.5 < 1.5, under 1/128. Each live row's largest |ctx| must be at
# least 8 times its page kind's tolerance.
PAGED_TOL = {False: 1 / 32, True: 1 / 128}      # by quant


def _paged_bound(lengths, nkv, g, hd, ps, quant) -> tuple:
    """Least time for one call: each row's K and V of its positions below
    its length (int8: with their scales), the page-table entries of its
    pages under the length and its length read once, q read, the float32
    output written; or its products (4 per K/V element per query head) at
    the bf16 peak."""
    b = len(lengths)
    elem = 1 if quant else 2
    bytes_ = b * nkv * g * hd * (2 + 4) + 4 * b
    flops = 0
    for n in lengths:
        bytes_ += 2 * nkv * n * (hd * elem + (4 if quant else 0))
        bytes_ += 4 * -(-n // ps)
        flops += 4 * nkv * g * hd * n
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def paged_kernel_checks(dev) -> dict:
    """B10 at layer 31 of the full pool, each row's table a random
    permutation of pages 1-1024, rows of KV_LENGTHS: the pool untouched,
    the context within PAGED_TOL of the plain version on the live
    rows (each with a largest |ctx| of at least 8 times it), zeros on the
    length-0 row. Timed cycling over the 32 layers, so that each launch
    finds its layer's pages out of the L2 cache, as the decode step does."""
    import itertools
    import torch.nn.functional as F
    from onebit_tpu_torch.kernels import paged_attention as pa
    from onebit_tpu_torch.kernels import paged_attention_cuda as pc
    n_layers, n_pages, nkv, ps, hd = PAGED_SHAPE
    b = len(KV_LENGTHS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    lengths = torch.tensor(KV_LENGTHS, dtype=torch.int32, device=dev)
    tables = torch.stack([
        torch.randperm(n_pages - 1, generator=gen, device=dev)[:PAGED_MP] + 1
        for _ in range(b)]).to(torch.int32)
    q = (KV_Q_STD * torch.randn(b, nkv, hd, generator=gen, device=dev)
         ).to(torch.bfloat16)
    live = lengths > 0
    t = PAGED_MP * ps
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]
            )[:, None, None, :]
    results = {}
    for quant, info in ((False, pc.PAGED), (True, pc.PAGED_INT8)):
        if quant:
            def ints():
                return torch.randint(-127, 128, PAGED_SHAPE, generator=gen,
                                     device=dev, dtype=torch.int8)

            def scales():
                return torch.randint(64, 192, PAGED_SHAPE[:-1] + (1,),
                                     generator=gen, device=dev
                                     ).float() / 127.5
            pool = [ints(), scales(), ints(), scales()]
        else:
            pool = [torch.empty(PAGED_SHAPE, dtype=torch.bfloat16,
                                device=dev).normal_(generator=gen)
                    for _ in range(2)]
        kw = dict(lengths=lengths, page_indices=tables, quant=quant)
        before = [x.clone() for x in pool]
        want = pa.paged_attention_flat_torch(q, *pool, layer=KV_LAYER, **kw)
        got = pa.paged_attention_flat(q, *pool, layer=KV_LAYER, **kw)
        torch.cuda.synchronize()
        untouched = all(torch.equal(x, y) for x, y in zip(pool, before))
        del before
        finite = bool(torch.isfinite(got).all())
        zero_row = bool((got[~live] == 0).all())
        err = (got[live] - want[live]).abs().max().item()
        ctx_scale = want[live].abs().amax(dim=(1, 2)).min().item()
        layer_of = itertools.cycle(range(n_layers))
        ms = cuda_ms(lambda: pa.paged_attention_flat(
            q, *pool, layer=next(layer_of), **kw), 32)
        plain_ms = cuda_ms(lambda: pa.paged_attention_flat_torch(
            q, *pool, layer=KV_LAYER, **kw), 3, warmup=1)
        # the yardstick's input: layer 31's pages gathered and dequantized
        # to bf16 beforehand, [B, nkv, T, hd]
        kv = [pa._gather_seq_kv(x[KV_LAYER], tables) for x in pool]
        if quant:
            kv = [(kv[0].float() * (kv[1] / 127.5)),
                  (kv[2].float() * (kv[3] / 127.5))]
        k_deq, v_deq = (x.to(torch.bfloat16).transpose(1, 2).contiguous()
                        for x in kv)
        del kv
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], k_deq, v_deq, attn_mask=mask), 32)
        bound_ms, bound_by = _paged_bound(KV_LENGTHS, nkv, 1, hd, ps, quant)
        del pool, k_deq, v_deq
        torch.cuda.empty_cache()
        results[info.name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms)
        tol = PAGED_TOL[quant]
        ok = (untouched and finite and zero_row and err <= tol
              and ctx_scale >= 8 * tol)
        emit({"phase": "kernel", "name": info.name, "tol": tol,
              "ok": ok, "pool_untouched": untouched, "ctx_finite": finite,
              "length0_row_zero": zero_row,
              "min_row_max_abs_ctx": ctx_scale, "layer": KV_LAYER,
              "pool_shape": list(PAGED_SHAPE), "page_indices": [b, PAGED_MP],
              "lengths": KV_LENGTHS, **results[info.name]})
        if not ok:
            raise RuntimeError(f"{info.name}: pool untouched {untouched}, "
                               f"finite {finite}, zero row {zero_row}, "
                               f"max_abs_err {err}, smallest row max |ctx| "
                               f"{ctx_scale}")
    return results


# ---------------------------------------------------------------------------
# phase 3, continued: B9 on full-size llama2-7b flat pools
# ---------------------------------------------------------------------------

# L, B, T, nkv, hd: the dense cache of 7B generation at batch 8 and T 2048,
# 2**31 elements per leaf, so layer 31's offsets pass 2**32 bytes
FLAT_SHAPE = (32, 8, 2048, 32, 128)
# rows of 1-2048 positions, some starting past 0 (left-padded prompts), one
# empty; each attends [start, length)
FLAT_LENGTHS = [2048, 1931, 1500, 1025, 777, 129, 1, 0]
FLAT_STARTS = [0, 300, 0, 1000, 5, 64, 0, 0]
# q on a grid of 1/16 (std 5, within +-15.9), float pools on a grid of 1/16
# in +-1.5, int8 pools of integers with scales of 0.5-1.5 units over the
# range (as B5's): every q . k dot is then exact in fp32 in any order, and a
# peaked softmax gives a context of order 1 on every live row. fp32: kernel
# and plain version differ only in the softmax's exponentials and the order
# of the PV sum, a few 2**-24 relative of |v| <= 1.5: under 1e-6, and the
# tolerance is 1e-5. bf16 q: both sides round P (times the V scale of int8
# pools) to bf16 (2**-9 relative) at different softmax scales, at most
# 2**-8 * 1.5 apart (int8: 127 units of scale 1.5/127), then the context to
# bf16 (ulp 2**-7 below 2): under 1/64, and the tolerance is 1/32, as
# B5-B8's. Each live row's largest |ctx| must be at least 8 times its
# dtype's tolerance (8 times 1/32 in both, so that zeros fail), and the
# empty row must be zeros.
FLAT_TOL = {torch.float32: 1e-5, torch.bfloat16: KV_TOL_BF16}


def _flat_bound(nkv, g, hd, pool_elem, quant, q_elem, fp32) -> tuple:
    """Least time for one call: each row's K and V (and int8 scales) of its
    positions in [start, length) read once, q, lengths and starts read,
    ctx written; or its products (4 per K/V element per query head) at the
    peak of their type (fp32 CUDA cores for fp32, bf16 tensor cores)."""
    b = len(FLAT_LENGTHS)
    bytes_ = 2 * b * nkv * g * hd * q_elem + 2 * 4 * b
    flops = 0
    for n, st in zip(FLAT_LENGTHS, FLAT_STARTS):
        cols = max(0, n - st)
        bytes_ += nkv * cols * (2 * hd * pool_elem + (2 * 4 if quant else 0))
        flops += 4 * nkv * g * hd * cols
    peak = FP32_FLOP_PER_S if fp32 else BF16_FLOP_PER_S
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def flat_kernel_checks(dev) -> dict:
    """B9 at layer 31 of full llama2-7b flat pools: int8 with scales and
    bf16 q, bf16 (also at nkv 8, GQA g 4), fp32. The pools untouched, ctx
    within FLAT_TOL of the plain version on the live rows, zeros on the
    empty one; timed cycling over the 32 layers, beside its bound, its plain
    version and one ``scaled_dot_product_attention`` with a boolean mask on
    the layer's K/V (int8: dequantized to bf16; GQA: repeated) made
    beforehand. The ``kernels`` line carries the MHA cases."""
    import itertools
    import torch.nn.functional as F
    from onebit_tpu_torch.kernels import kv_attention as ka
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    n_layers, b, t, nh, hd = FLAT_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    lengths = torch.tensor(FLAT_LENGTHS, dtype=torch.int32, device=dev)
    starts = torch.tensor(FLAT_STARTS, dtype=torch.int32, device=dev)
    live = lengths > starts
    cols = torch.arange(t, device=dev)[None, :]
    mask = ((cols >= starts[:, None]) & (cols < lengths[:, None])
            )[:, None, None, :]

    def grid_pool(shape, dtype):
        """Uniform on the 1/16 grid in [-1.5, 1.5], made in place."""
        x = torch.rand(shape, generator=gen, device=dev)
        return x.mul_(48).round_().sub_(24).div_(16).to(dtype)

    results = {}
    for info, q_dtype, nkv in ((kc.DECODE_INT8, torch.bfloat16, nh),
                               (kc.DECODE_BF16, torch.bfloat16, nh),
                               (kc.DECODE_BF16, torch.bfloat16, FLASH_GQA_NKV),
                               (kc.DECODE_F32, torch.float32, nh)):
        g = nh // nkv
        quant = info is kc.DECODE_INT8
        q = (torch.randn(b, nh, hd, generator=gen, device=dev) * 80).round_(
            ).div_(16).clamp_(-15.9375, 15.9375).to(q_dtype)
        shape = (n_layers, b, t, nkv, hd)
        if quant:
            pools = [torch.randint(-127, 128, shape, generator=gen,
                                   device=dev, dtype=torch.int8),
                     (torch.rand(shape[:-1], generator=gen, device=dev)
                      + 0.5) / 127]
            pools += [torch.randint(-127, 128, shape, generator=gen,
                                    device=dev, dtype=torch.int8),
                      (torch.rand(shape[:-1], generator=gen, device=dev)
                       + 0.5) / 127]
        else:
            pools = [grid_pool(shape, q_dtype), None,
                     grid_pool(shape, q_dtype), None]
        before = [x.clone() for x in pools if x is not None]
        want = ka.kv_attention_decode_torch(q, *pools, lengths, KV_LAYER,
                                            starts=starts)
        got = ka.kv_attention_decode(q, *pools, lengths, KV_LAYER,
                                     starts=starts)
        torch.cuda.synchronize()
        untouched = all(torch.equal(x, y) for x, y in
                        zip([x for x in pools if x is not None], before))
        del before
        finite = bool(torch.isfinite(got).all())
        zero_row = bool((got[~live] == 0).all())
        err = (got[live].float() - want[live].float()).abs().max().item()
        ctx_scale = want[live].float().abs().amax(dim=(1, 2)).min().item()
        layer_of = itertools.cycle(range(n_layers))
        ms = cuda_ms(lambda: ka.kv_attention_decode(
            q, *pools, lengths, next(layer_of), starts=starts), 32)
        plain_ms = cuda_ms(lambda: ka.kv_attention_decode_torch(
            q, *pools, lengths, KV_LAYER, starts=starts), 3, warmup=1)
        # the yardstick's input: layer 31's K/V as [B, nh, T, hd]
        lib_dtype = torch.bfloat16 if quant else q_dtype
        if quant:
            kv = [(pools[i][KV_LAYER].float() * pools[i + 1][KV_LAYER][
                ..., None]).to(lib_dtype) for i in (0, 2)]
        else:
            kv = [pools[i][KV_LAYER] for i in (0, 2)]
        k_lib, v_lib = (x.repeat_interleave(g, dim=2).transpose(1, 2)
                        .contiguous() for x in kv)
        del kv
        q_lib = q.to(lib_dtype)[:, :, None, :]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q_lib, k_lib, v_lib, attn_mask=mask), 32)
        del pools, k_lib, v_lib
        torch.cuda.empty_cache()
        bound_ms, bound_by = _flat_bound(
            nkv, g, hd, 1 if quant else q.element_size(), quant,
            q.element_size(), q_dtype == torch.float32)
        line = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
        if nkv == nh:
            results[info.name] = line
        tol = FLAT_TOL[q_dtype]
        ok = (untouched and finite and zero_row and err <= tol
              and ctx_scale >= 8 * KV_TOL_BF16)
        emit({"phase": "kernel", "name": info.name, "tol": tol, "ok": ok,
              "pools_untouched": untouched, "ctx_finite": finite,
              "empty_row_zero": zero_row, "min_row_max_abs_ctx": ctx_scale,
              "layer": KV_LAYER, "pool_shape": [n_layers, b, t, nkv, hd],
              "nkv": nkv, "q_dtype": str(q_dtype)[6:],
              "lengths": FLAT_LENGTHS, "starts": FLAT_STARTS, **line})
        if not ok:
            raise RuntimeError(f"{info.name} (nkv {nkv}): pools untouched "
                               f"{untouched}, finite {finite}, empty row "
                               f"zero {zero_row}, max_abs_err {err}, "
                               f"smallest row max |ctx| {ctx_scale}")
    return results


# ---------------------------------------------------------------------------
# phase 3, continued: B11 at the llama2-7b eval shape
# ---------------------------------------------------------------------------

FLASH_SHAPE = (4, 2048, 32, 128)   # B, S, nh, hd: one llama2-7b eval batch
FLASH_GQA_NKV = 8                  # the GQA case at 7B width: g = 4
# q of std 5, k and v of N(0, 1): scores of std 5, a softmax peaked on a
# few keys, a context of order 1 on every (row, head). fp32: the kernel
# sums the dots and the PV product in another order than the plain
# version and runs the softmax online, relative errors of a few 2**-24
# over 2048 keys, far under 1e-4 at |v| < 6.5. bf16: both sides round
# P to bf16 (2**-9 relative) at different scales (the kernel exp(s - m) at
# the running max, the plain version the normalized probabilities), so
# their fp32 contexts lie at most 2**-8 * max|v| < 0.026 apart for
# |v| < 6.5 (N(0, 1) over 2**25 samples); each then rounds the context to
# bf16, one ulp apart at most (2**-5 below 8): under 1/16. Each (row,
# head)'s largest |ctx| must be at least 8 times its dtype's tolerance.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 1 / 16}


def _flash_bound(b, s, nh, nkv, hd, dtype) -> tuple:
    """Least time for one call: q, k, v read once and the output written
    once, or the products of the causal half, 4 * B * nh * hd * S(S+1)/2,
    at the dtype's peak: the CUDA cores' fp32 rate for float32 (the kernel
    must not use TF32), the bf16 tensor-core rate for bfloat16."""
    elem = 4 if dtype == torch.float32 else 2
    bytes_ = elem * b * s * hd * (2 * nh + 2 * nkv)
    flops = 4 * b * nh * hd * s * (s + 1) / 2
    peak = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def flash_kernel_checks(dev) -> dict:
    """B11 at [4, 2048, 32, 128] (and the GQA case, nkv = 8) in fp32 and
    bf16 against its plain version, timed beside its bound, its plain
    version and one ``scaled_dot_product_attention(is_causal=True)`` on
    the same tensors in its own [B, H, S, D] layout (K/V repeated for GQA
    beforehand). The ``kernels`` line carries the MHA case."""
    import torch.nn.functional as F
    from onebit_tpu_torch.kernels import attention as ta
    from onebit_tpu_torch.kernels import attention_cuda as fc
    b, s, nh, hd = FLASH_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    results = {}
    for dtype, info in ((torch.float32, fc.FLASH_F32),
                        (torch.bfloat16, fc.FLASH_BF16)):
        for nkv in (nh, FLASH_GQA_NKV):
            g = nh // nkv
            q = (5 * torch.randn(b, s, nh, hd, generator=gen, device=dev)
                 ).to(dtype)
            k, v = (torch.randn(b, s, nkv, hd, generator=gen, device=dev
                                ).to(dtype) for _ in range(2))
            want = ta.flash_causal_attention_torch(q, k, v, num_kv_groups=g)
            got = ta.flash_causal_attention(q, k, v, num_kv_groups=g)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got).all())
            err = (got.float() - want.float()).abs().max().item()
            ctx_scale = want.float().abs().amax(dim=(1, 3)).min().item()
            del got, want
            ms = cuda_ms(lambda: ta.flash_causal_attention(
                q, k, v, num_kv_groups=g), 5)
            plain_ms = cuda_ms(lambda: ta.flash_causal_attention_torch(
                q, k, v, num_kv_groups=g), 2, warmup=1)
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2)
                      .contiguous() for x in (k, v))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 5)
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
            bound_ms, bound_by = _flash_bound(b, s, nh, nkv, hd, dtype)
            line = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=lib_ms)
            if nkv == nh:
                results[info.name] = line
            tol = FLASH_TOL[dtype]
            ok = finite and err <= tol and ctx_scale >= 8 * tol
            emit({"phase": "kernel", "name": info.name, "tol": tol, "ok": ok,
                  "shape": [b, s, nh, hd], "nkv": nkv, "out_finite": finite,
                  "min_row_head_max_abs_ctx": ctx_scale, **line})
            if not ok:
                raise RuntimeError(f"{info.name} (nkv {nkv}): finite "
                                   f"{finite}, max_abs_err {err}, smallest "
                                   f"row-head max |ctx| {ctx_scale}")
    return results


# ---------------------------------------------------------------------------
# phase 3, continued: B11's backward (B11-dkv, B11-dq) at the training shape
# ---------------------------------------------------------------------------

# Each gradient is held, per (row, head), relative to that slice's largest
# |value|, so that a kernel leaving any head's gradient zero fails (relative
# error 1). The inputs of B11's check: q of std 5, k, v and do of N(0, 1),
# gradients of order 1-20. fp32: the kernels sum in another order and
# recompute P = exp(s - lse) from the forward's log-sum-exp, whose exponent
# (scores up to about 25, summed over 128 products) carries an error of a
# few 1e-6, so P, dS and every gradient a relative few 1e-6: 1e-4. bf16:
# each side rounds its gradients to bf16, at most one ulp apart (2**-7 of
# the slice's top binade), after rounding operands at different places
# (the kernels, as the TPU kernel does, round P to bf16 for dV and dS,
# scaled, for dK and dQ, all products of bf16 operands on the tensor cores
# summed in fp32; the plain version rounds P and dP), relative 2**-9 per
# term of sums whose terms peak near the result: 2**-6. The CPU tests
# (tests/test_torch_flash_bwd.py) emulate the kernels' roundings step by
# step: within 7.9e-3 of the Pallas kernels' gradients and 1.2e-2 of the
# plain gradient per (row, head).
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}


def _flash_bwd_bound(b, s, nh, nkv, hd, dtype, kernel: str) -> tuple:
    """Least time for one call of a backward kernel: q, do, k, v, and the
    fp32 lse and di read once, its outputs (dk and dv, or dq) written once;
    or its products of the causal half, 2 * B * nh * hd * S(S+1)/2 flops
    each, at the dtype's peak: B11-dkv forms S, dP, dV and dK (4), B11-dq
    S, dP and dQ (3); the whole backward's five cost 2.5 times B11's two."""
    elem = 4 if dtype == torch.float32 else 2
    bytes_ = elem * b * s * hd * (2 * nh + 2 * nkv) + 2 * 4 * b * nh * s
    bytes_ += elem * b * s * hd * (2 * nkv if kernel == "dkv" else nh)
    products = 4 if kernel == "dkv" else 3
    flops = products * 2 * b * nh * hd * s * (s + 1) / 2
    peak = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def _flash_bwd_resources(kernel: str, hd: int, dtype) -> dict:
    """What one CTA of a backward kernel holds at this head_dim: ``ptxas``'s
    [registers, spill stores, spill loads] (from the build's log) and the
    dynamic shared memory its launcher asks for, in bytes."""
    from onebit_tpu_torch.kernels import build
    source = "flash_attention_bwd.cu"
    bf16 = dtype == torch.bfloat16
    entry = (f"flash_bwd_{kernel}_wgmmaILi{hd}E" if bf16
             else f"flash_bwd_{kernel}IfLi{hd}E")
    path = build.library_path(source)
    log = path.with_name(path.name + ".log")
    found = [v for k, v in ptxas_summary(log.read_text()).items()
             if entry in k] if log.exists() else []
    smem = build.load(source).onebit_flash_bwd_smem_bytes(
        0 if kernel == "dkv" else 1, hd, int(bf16))
    return {"ptxas_regs_spill_stores_loads": found[0] if found else None,
            "smem_bytes": smem}


def _backward_ms(fwd, do, iters: int) -> float:
    """The time of ``fwd()``'s backward on ``do``: forward plus backward,
    less the forward alone (each with autograd recording)."""
    def both():
        fwd().backward(do)

    return cuda_ms(both, iters, warmup=1) - cuda_ms(fwd, iters, warmup=1)


def flash_bwd_kernel_checks(dev) -> dict:
    """B11-dkv and B11-dq at [4, 2048, 32, 128] (and nkv = 8) in fp32 and
    bf16: the gradients of q, k and v through B11's autograd rule against
    autograd through the plain version, per (row, head) within
    FLASH_BWD_TOL. Each kernel timed alone on the forward's residuals,
    beside its bound, the plain version's backward and that of one
    ``scaled_dot_product_attention(is_causal=True)`` on [B, H, S, D]
    copies (K/V repeated for GQA beforehand), each the whole backward (all
    three gradients). The ``kernels`` line carries the MHA case."""
    import torch.nn.functional as F
    from onebit_tpu_torch.kernels import attention as ta
    from onebit_tpu_torch.kernels import attention_cuda as fc
    b, s, nh, hd = FLASH_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    results = {}
    for dtype, dkv_info, dq_info in (
            (torch.float32, fc.FLASH_DKV_F32, fc.FLASH_DQ_F32),
            (torch.bfloat16, fc.FLASH_DKV_BF16, fc.FLASH_DQ_BF16)):
        for nkv in (nh, FLASH_GQA_NKV):
            g = nh // nkv
            q = (5 * torch.randn(b, s, nh, hd, generator=gen, device=dev)
                 ).to(dtype)
            k, v = (torch.randn(b, s, nkv, hd, generator=gen, device=dev
                                ).to(dtype) for _ in range(2))
            do = torch.randn(b, s, nh, hd, generator=gen, device=dev
                             ).to(dtype)
            xs = [x.requires_grad_(True) for x in (q, k, v)]

            def grads(fn):
                for x in xs:
                    x.grad = None
                fn(*xs, num_kv_groups=g).backward(do)
                return [x.grad for x in xs]

            want = grads(ta.flash_causal_attention_torch)
            got = grads(ta.flash_causal_attention)
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(x).all()) for x in got)
            slice_max = [w.float().abs().amax(dim=(1, 3)) for w in want]
            diff = [(a.float() - w.float()).abs().amax(dim=(1, 3))
                    for a, w in zip(got, want)]
            rel = [(d / m).max().item() for d, m in zip(diff, slice_max)]
            abs_err = dict(zip("qkv", (d.max().item() for d in diff)))
            floor = min(m.min().item() for m in slice_max)
            del got, want, slice_max, diff
            for x in xs:
                x.grad = None
            with torch.no_grad():
                out, lse = fc.launch(q, k, v, g, with_lse=True)

                def di_op():
                    return (out.float() * do.float()).sum(-1).transpose(
                        1, 2).contiguous()
                di = di_op()
                ms_dkv = cuda_ms(lambda: fc.launch_bwd_dkv(
                    q, k, v, do, lse, di, g), 3)
                ms_dq = cuda_ms(lambda: fc.launch_bwd_dq(
                    q, k, v, do, lse, di, g), 3)
                ms_di = cuda_ms(di_op, 3)
            del out, lse, di
            plain_ms = _backward_ms(lambda: ta.flash_causal_attention_torch(
                *xs, num_kv_groups=g), do, 2)
            qt = q.detach().transpose(1, 2).contiguous().requires_grad_(True)
            kt, vt = (x.detach().repeat_interleave(g, dim=2).transpose(1, 2)
                      .contiguous().requires_grad_(True) for x in (k, v))
            dot = do.transpose(1, 2).contiguous()
            lib_ms = _backward_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), dot, 3)
            del q, k, v, do, xs, qt, kt, vt, dot
            torch.cuda.empty_cache()
            tol = FLASH_BWD_TOL[dtype]
            ok = finite and max(rel) <= tol
            for info, kernel, ms, err in (
                    (dkv_info, "dkv", ms_dkv, max(abs_err["k"],
                                                  abs_err["v"])),
                    (dq_info, "dq", ms_dq, abs_err["q"])):
                bound_ms, bound_by = _flash_bwd_bound(b, s, nh, nkv, hd,
                                                      dtype, kernel)
                line = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=lib_ms)
                if nkv == nh:
                    results[info.name] = line
                emit({"phase": "kernel", "name": info.name, "tol": tol,
                      "ok": ok, "shape": [b, s, nh, hd], "nkv": nkv,
                      "grads_finite": finite,
                      "max_rel_err_per_row_head": dict(zip("qkv", rel)),
                      "min_row_head_max_abs_grad": floor,
                      "backward_ms": ms_dkv + ms_dq + ms_di, "di_ms": ms_di,
                      "backward_bound_ms": _flash_bound(
                          b, s, nh, nkv, hd, dtype)[0] * 2.5,
                      "bound_share": bound_ms / ms,
                      **_flash_bwd_resources(kernel, hd, dtype),
                      "note": "plain_ms and library_ms: the whole "
                              "backward (dq, dk and dv)", **line})
            if not ok:
                raise RuntimeError(f"B11 backward ({dtype}, nkv {nkv}): "
                                   f"finite {finite}, relative errors {rel}")
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


def prefix_prompts(seed: int = 2):
    """The 8 prompts of the prefix-cache run: one shared 1024-token prefix
    (64 pages of 16) and a distinct suffix of 100-450 tokens each."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, 32000, 1024).tolist()
    return [prefix + rng.integers(3, 32000, n).tolist()
            for n in (100, 150, 200, 250, 300, 350, 400, 450)]


def all_kernels():
    from onebit_tpu_torch.kernels import attention_cuda as fc
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    from onebit_tpu_torch.kernels import paged_attention_cuda as pc
    return bc.KERNELS + kc.KERNELS + pc.KERNELS + fc.KERNELS


def reset_counts() -> None:
    for k in all_kernels():
        k.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {k.name: k.launches for k in all_kernels()}


def _engine(params, config, dev, opts):
    from onebit_tpu_torch import ContinuousBatchingEngine
    return ContinuousBatchingEngine(params, config, max_batch=8, device=dev,
                                    **opts)


def check_first_step(params, config, dev, prompts, new_tokens, opts) -> None:
    """The first decode step's logits after admission, impl="auto" against
    impl="torch", each on its own copy of the cache."""
    from onebit_tpu_torch.engine.paged import paged_decode_step
    from onebit_tpu_torch.model.ragged_decode import ragged_decode_step
    eng = _engine(params, config, dev, opts)
    for p in prompts:
        eng.add_request(p, max_new_tokens=new_tokens)
    eng._admit()
    tokens = torch.from_numpy(eng.next_token[:, None].astype(np.int64)).to(dev)
    out = {}
    for impl in ("auto", "torch"):
        cache = type(eng.cache)(*(x.clone() for x in eng.cache))
        if eng.paged:
            out[impl], _ = paged_decode_step(params, cache, tokens,
                                             eng.row_pos, eng.page_tables,
                                             config, impl=impl)
        else:
            out[impl], _ = ragged_decode_step(params, cache, tokens,
                                              eng.row_pos, np.ones(8, bool),
                                              config, impl=impl)
        del cache
    torch.cuda.synchronize()
    ref_scale = out["torch"].abs().max().item()
    err = (out["auto"] - out["torch"]).abs().max().item()
    agree = (out["auto"].argmax(-1) == out["torch"].argmax(-1)).float()
    check = {"phase": "logits_check", **opts,
             "max_abs_err": err, "max_abs_logit": ref_scale,
             "rel_err": err / ref_scale, "rel_tol": LOGITS_REL_TOL,
             "argmax_agree": agree.mean().item(),
             "finite": bool(torch.isfinite(out["auto"]).all())}
    emit(check)
    if not check["finite"] or check["rel_err"] > LOGITS_REL_TOL:
        raise RuntimeError(f"first-step logits disagree: {check}")


def served_run(params, config, dev, prompts, new_tokens, opts,
               per_step) -> dict:
    """One served run whose kernel launches are counted: every count is
    set to 0 just before it and read just after. ``per_step``: the kernel
    that must launch once per layer of every decode step, or None."""
    eng = _engine(params, config, dev, opts)
    pool_bytes = sum(x.numel() * x.element_size() for x in eng.cache)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_start = time.perf_counter()
    uids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    step_s, decode_steps = [], 0
    while eng.has_work():
        t = time.perf_counter()
        eng._admit()
        decode_steps += any(s is not None for s in eng.slots)
        eng._decode()
        step_s.append(time.perf_counter() - t)
    ttft = [eng.finished[u].t_first_token - eng.finished[u].t_submit
            for u in uids]
    result = eng.run()
    wall = time.perf_counter() - t_start
    launches = {k.name: k.launches for k in all_kernels()}

    got = [result[u] for u in uids]
    if any(len(g) != new_tokens or not all(0 <= t < config.vocab_size
                                           for t in g) for g in got):
        raise RuntimeError(f"bad generations: {[len(g) for g in got]}")
    decode = step_s[1:new_tokens]
    m = eng.metrics()
    line = {"phase": "serve", **opts, "requests": len(prompts),
            "prompt_lengths": [len(p) for p in prompts],
            "new_tokens": new_tokens, "steps": len(step_s),
            "decode_steps": decode_steps, "first_step_ms": step_s[0] * 1e3,
            "decode_ms_per_step_median": float(np.median(decode)) * 1e3,
            "decode_tok_per_s": 8 / float(np.median(decode)),
            "ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
            "ttft_per_request_s": ttft,
            "tpot_p50_s": m["tpot_p50_s"], "wall_s": wall,
            "generated_tokens": m["total_tokens"], "launches": launches,
            "pool_bytes": pool_bytes,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    line.update({k: m[k] for k in ("free_pages", "total_pages",
                                   "prefix_cache_entries",
                                   "prefix_pages_reused") if k in m})
    emit(line)
    bitlinear = [k.name for k in all_kernels()[:3]]
    zero = [n for n in bitlinear if launches[n] == 0]
    if zero:
        raise RuntimeError(f"kernels never launched on the main path: {zero}")
    if per_step is not None:
        want = config.num_hidden_layers * decode_steps
        if launches[per_step.name] != want or decode_steps == 0:
            raise RuntimeError(f"{per_step.name} launched "
                               f"{launches[per_step.name]} times, not "
                               f"{want} (32 per decode step)")
    if eng.paged:
        held = m.get("prefix_cache_entries", 0)
        if m["free_pages"] != m["total_pages"] - held:
            raise RuntimeError(f"pages not returned: {m}")
    if opts.get("prefix_cache"):
        # the same-round deferral admits request 0 alone; the other seven
        # each hit the 64 pages of the shared prefix
        if m["prefix_pages_reused"] != 7 * 64:
            raise RuntimeError(f"prefix pages reused "
                               f"{m['prefix_pages_reused']}, not 448")
    return launches


# ---------------------------------------------------------------------------
# phase 4, continued: batch generation at llama2-7b width and depth
# ---------------------------------------------------------------------------

GEN_NEW = 32          # new tokens of the bf16 run: 31 decode steps
GEN_NEW_F32 = 8       # and of the fp32 run
FLAT_STEPS = 8        # one-token steps on the flat int8 cache


def _zero_kv_head_fault(kc):
    """Install a planted fault in B9's launch wrapper: the context of kv
    head 0 (query heads 0 .. g-1) zeroed in layer 0. Returns the function
    that removes it."""
    real = kc.launch_flat

    def faulty(q, k_pool, k_scale, v_pool, v_scale, lengths, layer, *,
               starts):
        out = real(q, k_pool, k_scale, v_pool, v_scale, lengths, layer,
                   starts=starts)
        if layer == 0:
            out[:, :q.shape[1] // k_pool.shape[3]] = 0
        return out

    kc.launch_flat = faulty

    def remove():
        kc.launch_flat = real
    return remove


def _rel(a, ref) -> float:
    return ((a - ref).abs().max() / ref.abs().max()).item()


def _generate_first_step(params, config, dev, prompts) -> dict:
    """``generate``'s prefill of the left-padded prompts, then its first
    decode step on copies of the cache: impl="auto" against impl="torch",
    and again with :func:`_zero_kv_head_fault`, which must break the
    limit."""
    from onebit_tpu_torch.engine import generate as gm
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    from onebit_tpu_torch.model.bitllama import (KVCache, decode_step,
                                                 init_kv_cache)
    ids, attn = (torch.from_numpy(a).to(dev) for a in gm.left_pad(prompts))
    b, maxp = ids.shape
    plens = attn.sum(1)
    cache = init_kv_cache(config, b, 1 << (maxp + GEN_NEW - 1).bit_length(),
                          device=dev)
    last = gm._prefill(params, cache, ids, attn, config).argmax(-1)[:, None]
    kw = dict(positions=plens[:, None],
              key_start=(maxp - plens).to(torch.int32))
    out = {}
    for key, impl in (("auto", "auto"), ("torch", "torch"),
                      ("fault", "auto")):
        step_cache = KVCache(cache.k.clone(), cache.v.clone())
        remove = _zero_kv_head_fault(kc) if key == "fault" else None
        try:
            out[key], _ = decode_step(params, step_cache, last, maxp,
                                      config, impl=impl, **kw)
        finally:
            if remove:
                remove()
        del step_cache
    torch.cuda.synchronize()
    line = {"phase": "generate_logits_check", "dtype": "bfloat16",
            "rel_err": _rel(out["auto"], out["torch"]),
            "rel_tol": LOGITS_REL_TOL,
            "argmax_agree": (out["auto"].argmax(-1) == out["torch"].argmax(-1)
                             ).float().mean().item(),
            "finite": bool(torch.isfinite(out["auto"]).all()),
            "fault": "B9 context of kv head 0 of layer 0 zeroed",
            "fault_rel_err": _rel(out["fault"], out["torch"])}
    emit(line)
    if not (line["finite"] and line["rel_err"] <= LOGITS_REL_TOL
            and line["fault_rel_err"] > LOGITS_REL_TOL):
        raise RuntimeError(f"generate's first decode step disagrees, or the "
                           f"planted fault passes: {line}")
    return line


def _flat_int8_run(params, config, dev, prompts) -> dict:
    """``decode_step_flat`` on a flat int8 ``QuantKVCache``: the left-padded
    prompts in one multi-token step, then FLAT_STEPS one-token steps, each
    count set to 0 just before the kernel path's run; impl="torch" then
    takes the same tokens, and every step's logits are held to it."""
    from onebit_tpu_torch import decode_step_flat, init_quant_kv_cache
    from onebit_tpu_torch.engine import generate as gm
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    ids, attn = (torch.from_numpy(a).to(dev) for a in gm.left_pad(prompts))
    b, maxp = ids.shape
    plens = attn.sum(1)
    key_start = (maxp - plens).to(torch.int32)
    tokens, logits, counts = [], {}, None
    for impl in ("auto", "torch"):
        cache = init_quant_kv_cache(config, b, 256, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out, cache = decode_step_flat(
            params, cache, ids, 0, config, impl=impl,
            positions=(torch.cumsum(attn, 1) - 1).clamp(min=0),
            key_start=key_start)
        steps = []
        for i in range(FLAT_STEPS):
            if impl == "auto":
                tokens.append(out[:, -1].argmax(-1)[:, None])
            out, cache = decode_step_flat(
                params, cache, tokens[i], maxp + i, config, impl=impl,
                positions=(plens + i)[:, None], key_start=key_start)
            steps.append(out[:, -1])
        torch.cuda.synchronize()
        logits[impl] = torch.stack(steps)
        if impl == "auto":
            wall = time.perf_counter() - t0
            counts = read_counts()
        del cache
    rel = max(_rel(a, r) for a, r in zip(logits["auto"], logits["torch"]))
    want = config.num_hidden_layers * FLAT_STEPS
    line = {"phase": "decode_step_flat_int8", "batch": b, "max_len": 256,
            "prefill_tokens": maxp, "steps": FLAT_STEPS,
            "max_rel_err_vs_torch": rel, "rel_tol": LOGITS_REL_TOL,
            "seconds": wall,
            "launches": {k: v for k, v in counts.items() if v}}
    emit(line)
    if rel > LOGITS_REL_TOL or counts[kc.DECODE_INT8.name] != want:
        raise RuntimeError(f"decode_step_flat (int8): logits disagree or B9 "
                           f"(int8) did not launch {want} times: {line}")
    return counts


def generate_checks(params, config, dev) -> dict:
    """Batch generation at llama2-7b width and depth on the fused params,
    the dense run's 8 prompts left-padded (5-200 tokens):

    (a) the first decode step against impl="torch", with a planted fault
        (:func:`_generate_first_step`);
    (b) ``generate`` of GEN_NEW greedy tokens in bf16 and GEN_NEW_F32 in
        fp32, each counted from 0: B9 (bf16, fp32) exactly 32 per decode
        step, K1, K2 and K3 launched; wall time; then the bf16 decode loop
        alone, timed for ms per step;
    (c) ``decode_step_flat`` on the flat int8 cache (:func:`_flat_int8_run`):
        B9's int8 instance exactly 32 x FLAT_STEPS times.

    Returns B9's launches from (b) and (c)."""
    from onebit_tpu_torch import generate
    from onebit_tpu_torch.engine import generate as gm
    from onebit_tpu_torch.engine.sampler import SamplingConfig
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    from onebit_tpu_torch.model.bitllama import init_kv_cache
    prompts = smoke_prompts()
    n_layers = config.num_hidden_layers
    _generate_first_step(params, config, dev, prompts)
    launches = {}
    for dtype, new, info, k3 in (
            (torch.bfloat16, GEN_NEW, kc.DECODE_BF16, bc.LARGE_M),
            (torch.float32, GEN_NEW_F32, kc.DECODE_F32, bc.LARGE_M_F32)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = generate(params, config, prompts, max_new_tokens=new,
                       compute_dtype=dtype)
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = n_layers * (new - 1)
        line = {"phase": "generate", "dtype": str(dtype)[6:],
                "prompt_lengths": [len(p) for p in prompts],
                "new_tokens": new, "decode_steps": new - 1,
                "generated": [len(r) for r in out], "wall_s": wall,
                "tok_per_s_end_to_end": sum(len(r) for r in out) / wall,
                "launches": {k: v for k, v in counts.items() if v}}
        ok = (counts[info.name] == want
              and all(counts[k.name] for k in (bc.SMALL_M, bc.FUSED_SMALL_M,
                                               k3))
              and all(r and all(0 <= t < config.vocab_size for t in r)
                      for r in out))
        if dtype == torch.bfloat16:
            # the decode loop alone: ms per step, tokens per second
            ids, attn = (torch.from_numpy(a).to(dev)
                         for a in gm.left_pad(prompts))
            b, maxp = ids.shape
            cache = init_kv_cache(config, b, 1 << (maxp + new - 1
                                                   ).bit_length(),
                                  device=dev)
            last = gm._prefill(params, cache, ids, attn, config).argmax(
                -1)[:, None]
            gen = torch.Generator(device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gm._decode_loop(params, cache, last, maxp, attn.sum(1), gen,
                            config, sampling=SamplingConfig(greedy=True),
                            num_steps=new - 1)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / (new - 1) * 1e3
            line.update(decode_ms_per_step=step_ms,
                        decode_tok_per_s=b / step_ms * 1e3)
            del cache
        emit(line)
        if not ok:
            raise RuntimeError(f"generate ({dtype}): {info.name} did not "
                               f"launch {want} times, a BitLinear kernel "
                               f"never launched, or bad tokens: {line}")
        launches[info.name] = counts[info.name]
        torch.cuda.empty_cache()
    counts = _flat_int8_run(params, config, dev, prompts)
    launches[kc.DECODE_INT8.name] = counts[kc.DECODE_INT8.name]
    return launches


# ---------------------------------------------------------------------------
# phase 4, continued: tensor-parallel serving, two ranks on one card
# ---------------------------------------------------------------------------

TP_MP = 2
# the two ranks share cuda:0, which NCCL refuses ("Duplicate GPU detected"):
# their collectives go over gloo, through the host
TP_BACKEND = "gloo"
TP_TIMEOUT = 600          # seconds for the whole phase, every rank
TP_NEW = 32
# (run, engine options, prompts, the attention kernel of every decode
# layer), each at full width and depth
TP_RUNS = (
    ("dense", dict(max_len=256), "smoke", "kv_attention_decode_bf16"),
    ("int8_kt", dict(max_len=2048, quantized_kv=True), "deep",
     "kv_attention_append_kt"),
    ("paged_int8_prefix", dict(max_len=2048, paged=True, page_size=16,
                               quantized_kv=True, prefix_cache=True),
     "prefix", "paged_attention_flat_int8"))
TP_PROMPTS = {"smoke": smoke_prompts, "deep": deep_prompts,
              "prefix": prefix_prompts}
# what the TP path must never launch: K1-K3 (B4 serves every projection)
TP_ZERO = ("bitlinear_small_m", "bitlinear_fused_small_m",
           "bitlinear_large_m", "bitlinear_large_m_f32")


def _drop_rank1_o_proj(td):
    """Install a planted fault in the tensor-parallel layers: rank 1's
    share of layer 0's o_proj all-reduce dropped (its partial product made
    of zeros). Returns the function that removes it."""
    real = td._row_parallel_flat

    def faulty(x_loc, layers, name, i, impl, group, **kw):
        if name == "o_proj" and i == 0 and group.rank == 1:
            x_loc = torch.zeros_like(x_loc)
        return real(x_loc, layers, name, i, impl, group, **kw)

    td._row_parallel_flat = faulty

    def remove():
        td._row_parallel_flat = real
    return remove


def _tp_first_step(group, params, config, next_token):
    """Rank side: the TP engine admits the dense prompts, then its first
    decode step runs on copies of the cache with the single-device
    engine's first tokens ``next_token``: impl="auto", impl="torch", and
    auto with :func:`_drop_rank1_o_proj`. Rank 0 returns the logits."""
    from onebit_tpu_torch.engine.tp_backend import TPServing
    from onebit_tpu_torch.model import tp_decode as td
    eng = _engine(params, config, None, dict(max_len=256, tp_group=group))
    for p in smoke_prompts():
        eng.add_request(p, max_new_tokens=TP_NEW)
    eng._admit()
    tokens = torch.from_numpy(next_token[:, None].astype(np.int64)).to(
        group.device)
    plain = TPServing(group, config, impl="torch")
    out = {}
    for key, serving in (("auto", eng._tp), ("torch", plain),
                         ("fault", eng._tp)):
        cache = type(eng.cache)(*(x.clone() for x in eng.cache))
        remove = _drop_rank1_o_proj(td) if key == "fault" else None
        try:
            logits, _ = serving.step(eng.params, cache, tokens, eng.row_pos,
                                     np.ones(8, bool))
        finally:
            if remove:
                remove()
        if group.rank == 0:
            out[key] = logits[:, 0].cpu().numpy()
        del cache
    return out


def _tp_served_run(group, params, config, prompts, opts) -> dict:
    """Rank side: one served run of the TP engine, every launch count set
    to 0 just before it and read just after; forward passes counted (each
    decode step, and each admission's prefill or chunk-append call)."""
    eng = _engine(params, config, None, dict(opts, tp_group=group))
    calls = {"n": 0}
    for prog in ("prefill_rows", "paged_prefill_rows", "paged_chunk_append"):
        real = getattr(eng._tp, prog)

        def counted(*args, _real=real):
            calls["n"] += 1
            return _real(*args)
        setattr(eng._tp, prog, counted)
    torch.cuda.synchronize()
    reset_counts()
    t_start = time.perf_counter()
    uids = [eng.add_request(p, max_new_tokens=TP_NEW) for p in prompts]
    step_s, decode_steps = [], 0
    while eng.has_work():
        t = time.perf_counter()
        eng._admit()
        decode_steps += any(s is not None for s in eng.slots)
        eng._decode()
        step_s.append(time.perf_counter() - t)
    wall = time.perf_counter() - t_start
    m = eng.metrics()
    return {"tokens": [eng.finished[u].generated for u in uids],
            "launches": read_counts(), "decode_steps": decode_steps,
            "forwards": decode_steps + calls["n"],
            "decode_ms_per_step_median":
                float(np.median(step_s[1:TP_NEW])) * 1e3,
            "wall_s": wall, "pool_bytes": sum(
                x.numel() * x.element_size() for x in eng.cache),
            **{k: m[k] for k in ("free_pages", "total_pages",
                                 "prefix_cache_entries",
                                 "prefix_pages_reused") if k in m}}


def _tp_rank(group, next_token):
    """One rank of the TP phase: random llama2-7b weights from seed 0
    (unfused), the first-step checks, then the runs of TP_RUNS."""
    from onebit_tpu_torch import BitLlamaConfig, host_random_packed_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    config = BitLlamaConfig.named("llama2-7b")
    params = host_random_packed_params(config, seed=0, device=group.device)
    out = {"weights_s": time.perf_counter() - t0,
           "first_step": _tp_first_step(group, params, config, next_token)}
    torch.cuda.empty_cache()
    for name, opts, prompts, _ in TP_RUNS:
        out[name] = _tp_served_run(group, params, config,
                                   TP_PROMPTS[prompts](), opts)
        torch.cuda.empty_cache()
    return out


def tp_checks(unfused, config, dev) -> dict:
    """Tensor-parallel serving at llama2-7b width: two ranks (``spawn_tp``,
    ``gloo``) sharing the card, each an 8-slot ``ContinuousBatchingEngine``
    with ``tp_group`` on unfused ``host_random_packed_params(seed=0)``.

    (a) The first decode step after the dense prompts' admission, fed the
        single-device engine's first tokens: rank 0's logits within
        LOGITS_REL_TOL of the single-device engine's (computed here, on the
        same weights) and of the TP run with impl="torch"; a planted fault
        (rank 1's share of layer 0's o_proj all-reduce dropped) must break
        that limit.
    (b) The runs of TP_RUNS, 8 greedy requests of 32 new tokens each, every
        count set to 0 before each: both ranks emit the same tokens and
        launch the same kernels; B4 (both instances) exactly 7 x L per
        forward pass, the run's attention kernel exactly L per decode step,
        K1-K3 never; pages all returned, and the prefix run reuses 448.

    Returns rank 0's B4 launches from the dense run, the main path."""
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.model.ragged_decode import ragged_decode_step
    from onebit_tpu_torch.parallel.mesh import spawn_tp
    t_phase = time.perf_counter()
    eng = _engine(unfused, config, dev, dict(max_len=256))
    for p in smoke_prompts():
        eng.add_request(p, max_new_tokens=TP_NEW)
    eng._admit()
    next_token = eng.next_token.copy()
    tokens = torch.from_numpy(next_token[:, None].astype(np.int64)).to(dev)
    single, _ = ragged_decode_step(unfused, eng.cache, tokens, eng.row_pos,
                                   np.ones(8, bool), config)
    single = single[:, 0].cpu().numpy()
    del eng
    torch.cuda.empty_cache()

    ranks = spawn_tp(_tp_rank, TP_MP, backend=TP_BACKEND, device="cuda",
                     timeout=TP_TIMEOUT, args=(next_token,))
    first = ranks[0]["first_step"]

    def rel(a, ref):
        return float(np.abs(a - ref).max() / np.abs(ref).max())

    line = {"phase": "tp_logits_check", "mp": TP_MP, "backend": TP_BACKEND,
            "rel_err_vs_single_device": rel(first["auto"], single),
            "rel_err_vs_torch": rel(first["auto"], first["torch"]),
            "rel_tol": LOGITS_REL_TOL,
            "argmax_agree_single_device": float(np.mean(
                first["auto"].argmax(-1) == single.argmax(-1))),
            "argmax_agree_torch": float(np.mean(
                first["auto"].argmax(-1) == first["torch"].argmax(-1))),
            "finite": bool(np.isfinite(first["auto"]).all()),
            "fault": "rank 1's share of layer 0's o_proj all-reduce dropped",
            "fault_rel_err": rel(first["fault"], single),
            "weights_s": ranks[0]["weights_s"]}
    emit(line)
    if not (line["finite"]
            and line["rel_err_vs_single_device"] <= LOGITS_REL_TOL
            and line["rel_err_vs_torch"] <= LOGITS_REL_TOL
            and line["fault_rel_err"] > LOGITS_REL_TOL):
        raise RuntimeError(f"TP first-step logits disagree, or the planted "
                           f"fault passes: {line}")
    raw = (bc.RAW_SMALL_M.name, bc.RAW_LARGE_M.name)
    layers = config.num_hidden_layers
    for name, opts, _, per_step in TP_RUNS:
        r0, r1 = ranks[0][name], ranks[1][name]
        counts = r0["launches"]
        b4 = sum(counts[k] for k in raw)
        line = {"phase": "tp_serve", "run": name, **opts, "mp": TP_MP,
                "backend": TP_BACKEND, "layers": layers,
                "requests": len(r0["tokens"]), "new_tokens": TP_NEW,
                "ranks_tokens_equal": r0["tokens"] == r1["tokens"],
                "ranks_launches_equal": counts == r1["launches"],
                "launches_rank0": {k: v for k, v in counts.items() if v},
                "b4_launches": b4, "b4_want": 7 * layers * r0["forwards"],
                **{k: v for k, v in r0.items()
                   if k not in ("tokens", "launches")}}
        emit(line)
        ok = (line["ranks_tokens_equal"] and line["ranks_launches_equal"]
              and b4 == line["b4_want"] and r0["decode_steps"] > 0
              and counts[per_step] == layers * r0["decode_steps"]
              and not any(counts[k] for k in TP_ZERO)
              and all(len(t) == TP_NEW and all(0 <= x < config.vocab_size
                                               for x in t)
                      for t in r0["tokens"]))
        if "free_pages" in r0:
            ok = ok and r0["free_pages"] == r0["total_pages"] - r0.get(
                "prefix_cache_entries", 0)
        if opts.get("prefix_cache"):
            ok = ok and r0["prefix_pages_reused"] == 7 * 64
        if not ok:
            raise RuntimeError(f"TP run {name}: ranks disagree, a launch "
                               f"count is off, or bad tokens: {line}")
    emit({"phase": "tp", "wall_s": time.perf_counter() - t_phase,
          "launches_reported": "rank 0 of the dense TP run"})
    dense = ranks[0]["dense"]["launches"]
    return {k: dense[k] for k in raw}


def generate_cli_checks(dev) -> None:
    """The command lines on the 2-layer native checkpoint of 7B width that
    :func:`eval_checks` wrote under ``build/smoke_ckpt``: ``convert
    --format reference``; ``generate`` from the reference directory, whose
    tokens must equal the in-process ``generate`` of the checkpoint it
    loads; ``eval --check-engines dense,kvq,int4,paged`` with a pinned
    ``engine_check.ok`` of 1. The reference directory is removed after."""
    import shutil

    from onebit_tpu_torch import generate, load_reference_checkpoint
    from onebit_tpu_torch.engine.sampler import SamplingConfig
    ckpt = os.path.join(ROOT, "build", "smoke_ckpt")
    ref = os.path.join(ROOT, "build", "smoke_ref")
    seconds = {}

    def cli(*args):
        t = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "onebit_tpu_torch",
                              *args], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        seconds[args[0]] = time.perf_counter() - t
        if run.returncode != 0:
            raise RuntimeError(f"{args[0]} failed:\n{run.stdout[-2000:]}\n"
                               f"{run.stderr[-3000:]}")
        return run.stdout.strip().splitlines()

    try:
        cli("convert", ckpt, ref, "--format", "reference")
        tokens = cli("generate", "--ckpt", ref, "--prompt", "1,2,3",
                     "--greedy", "--device", "cuda")[-1]
        loaded = load_reference_checkpoint(ref, device=dev)
        want = generate(loaded["params"], loaded["config"], [[1, 2, 3]],
                        sampling=SamplingConfig(greedy=True))[0]
        del loaded
        spec = os.path.join(ref, "expect.json")
        with open(spec, "w") as f:
            json.dump({"engine_check.ok": {"value": 1.0, "atol": 0.0}}, f)
        out = cli("eval", "--ckpt", ref, "--check-engines",
                  "dense,kvq,int4,paged", "--expect", spec)
        result = json.loads([ln for ln in out if ln.startswith("{")][-1])
        line = {"phase": "generate_cli", "ckpt_layers": 2,
                "cli_tokens": tokens,
                "in_process_tokens": ",".join(map(str, want)),
                "engine_check": result["engine_check"],
                "engine_lines": [ln for ln in out if "engine check" in ln],
                "seconds": seconds}
        emit(line)
        if tokens != line["in_process_tokens"] or \
                result["engine_check"]["ok"] != 1.0:
            raise RuntimeError(f"the generate and eval command lines: {line}")
    finally:
        shutil.rmtree(ref, ignore_errors=True)


def end_to_end(dev) -> dict:
    """The dense path at max_len 256, then the int8 and the int4
    quantized-KV paths and the paged paths (bf16 pages, int8 pages, bf16
    pages with prefix caching) at max_len 2048, batch generation
    (:func:`generate_checks`), then evaluation (:func:`eval_checks`), all
    at full llama2-7b width and depth on the same random weights; the
    generate and eval command lines (:func:`generate_cli_checks`); and KD
    training (:func:`train_checks`). Returns each kernel's launches from the
    run of its own path."""
    from onebit_tpu_torch import (BitLlamaConfig, fuse_for_decode,
                                  host_random_packed_params)
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    from onebit_tpu_torch.kernels import paged_attention_cuda as pc

    config = BitLlamaConfig.named("llama2-7b")
    t0 = time.perf_counter()
    unfused = host_random_packed_params(config, seed=0, device=dev)
    params = fuse_for_decode(unfused, config)
    torch.cuda.synchronize()
    emit({"phase": "weights", "config": "llama2-7b", "layers":
          config.num_hidden_layers, "seconds": time.perf_counter() - t0,
          "layers_keys": sorted(params["layers"])})
    paged = dict(max_len=2048, paged=True, page_size=16)
    launches = {}
    # (prompts, engine options, per-step kernel, kernels of this path,
    # first-step check)
    for prompts, opts, per_step, path_kernels, check in (
            (smoke_prompts(), dict(max_len=256), kc.DECODE_BF16,
             all_kernels()[:3], True),
            (deep_prompts(), dict(max_len=2048, quantized_kv=True),
             kc.APPEND_KT, [kc.APPEND_KT], True),
            (deep_prompts(), dict(max_len=2048, quantized_kv="int4"),
             kc.APPEND_KT4, [kc.APPEND_KT4], True),
            (deep_prompts(), paged, pc.PAGED, [pc.PAGED], True),
            (deep_prompts(), dict(paged, quantized_kv=True), pc.PAGED_INT8,
             [pc.PAGED_INT8], True),
            (prefix_prompts(), dict(paged, prefix_cache=True), pc.PAGED, [],
             False)):
        if check:
            check_first_step(params, config, dev, prompts, 32, opts)
        run = served_run(params, config, dev, prompts, 32, opts, per_step)
        launches.update({k.name: run[k.name] for k in path_kernels})
        torch.cuda.empty_cache()
    launches.update(generate_checks(params, config, dev))
    # the serving runs' memory goes before tensor-parallel serving and
    # evaluation, which read the projections unfused, as a checkpoint loads
    # them
    del params
    torch.cuda.empty_cache()
    launches.update(tp_checks(unfused, config, dev))
    launches.update(eval_checks(unfused, config, dev))
    del unfused
    torch.cuda.empty_cache()
    generate_cli_checks(dev)
    launches.update(train_checks(dev))
    # B6 and B8, the read-only variants, are on no path of the port
    return {k.name: launches.get(k.name, 0) for k in all_kernels()}


# ---------------------------------------------------------------------------
# phase 5: evaluation at full llama2-7b width and depth
# ---------------------------------------------------------------------------

EVAL_SEQLEN, EVAL_BATCH, EVAL_WINDOWS = 2048, 4, 8
# fp32 everywhere: the kernel path and impl="torch" differ only in the
# summation order of K3's and B11's sums, a few 2**-24 relative per call
# (KERNEL_TOL_F32, FLASH_TOL). Pre-logits: held relative to their largest
# |value|; 32 layers of such errors, even grown tenfold, stay under 1e-5,
# and the limit is 1e-4. It has teeth: a bf16 forward lands about 2e-2
# away, and the planted fault below (B11's context of one head of one
# layer zeroed) must land beyond it.
EVAL_PRELOGITS_REL_TOL = 1e-4
# A window's nll sums 2047 positions' CE (about 2048 x 10.4); each moves by
# at most twice its largest logit difference, and the signed differences
# mostly cancel in the sum. The limit is 1e-6 relative. The chunked CE sums
# the same logits in another order: the same limit.
EVAL_NLL_REL_TOL = 1e-6
EVAL_CHUNK_REL_TOL = 1e-6
# a request's log-likelihood (up to 20 tokens) by the same reasoning; the
# greedy flags must agree unless a continuation position's top-2 log-prob
# gap lies under EVAL_GAP_TOL, far above the two paths' logit differences
EVAL_LL_TOL = 1e-4
EVAL_GAP_TOL = 1e-3


def _eval_requests(params, config, dev):
    """16 (context, continuation) requests: contexts of 100-1500 tokens,
    continuations of 1-20; the four shortest contexts continue with their
    greedy token on the kernel path (one batched, right-padded forward),
    so that both values of ``is_greedy`` occur."""
    from onebit_tpu_torch.model.bitllama import forward
    rng = np.random.default_rng(5)
    ctx_lens = np.linspace(100, 1500, 16).astype(int)
    reqs = [(rng.integers(3, config.vocab_size, n).tolist(),
             rng.integers(3, config.vocab_size,
                          int(rng.integers(1, 21))).tolist())
            for n in ctx_lens]
    short = ctx_lens[:4]
    ids = torch.zeros(4, int(short.max()), dtype=torch.long, device=dev)
    mask = torch.zeros_like(ids)
    for r in range(4):
        ids[r, :short[r]] = torch.tensor(reqs[r][0])
        mask[r, :short[r]] = 1
    logits = forward(params, ids, config, attention_mask=mask,
                     compute_dtype=torch.float32)
    for r in range(4):
        reqs[r] = (reqs[r][0], [int(logits[r, short[r] - 1].argmax())])
    return reqs


def _top2_gap(params, config, dev, req) -> float:
    """The smallest top-2 log-prob gap over a request's continuation
    positions on the plain path: where the two paths' greedy flags may
    differ."""
    from onebit_tpu_torch.model.bitllama import forward
    ctx, cont = req
    toks = torch.tensor(ctx + cont, device=dev)[None]
    logits = forward(params, toks[:, :-1], config, impl="torch",
                     compute_dtype=torch.float32)[0, -len(cont):]
    top2 = torch.log_softmax(logits, -1).topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).min().item()


def _zero_head_fault(bl, n_layers: int):
    """Install a planted fault in ``forward``'s B11: the context of head 0
    of the first of each forward's ``n_layers`` layers zeroed. Returns the
    function that removes it."""
    real = bl.flash_causal_attention
    calls = []

    def faulty(q, k, v, *, num_kv_groups):
        ctx = real(q, k, v, num_kv_groups=num_kv_groups)
        if len(calls) % n_layers == 0:
            ctx[:, :, 0] = 0
        calls.append(1)
        return ctx

    bl.flash_causal_attention = faulty

    def remove():
        bl.flash_causal_attention = real
    return remove


def prelogits_checks(params, config, dev, tokens, nll_ref) -> dict:
    """The first eval batch's fp32 pre-logits on the kernel path against
    ``impl="torch"`` (relative to their largest |value|), the spread of its
    logits, and the same comparison with the planted fault of
    :func:`_zero_head_fault`, which must break the limit; its window nlls'
    distance from ``nll_ref`` (the batch's ``impl="torch"`` nlls) is
    reported beside EVAL_NLL_REL_TOL."""
    from onebit_tpu_torch.eval import ppl as ppl_mod
    from onebit_tpu_torch.model import bitllama as bl
    ids = torch.from_numpy(tokens[:EVAL_BATCH * EVAL_SEQLEN].reshape(
        EVAL_BATCH, EVAL_SEQLEN)).to(dev)
    f32 = dict(compute_dtype=torch.float32, return_prelogits=True)
    ref = bl.forward(params, ids, config, impl="torch", **f32)
    scale = ref.abs().max().item()
    got = bl.forward(params, ids, config, **f32)
    rel = (got - ref).abs().max().item() / scale
    logits = bl._lm_head(got, params, torch.float32)
    spread = {"max_abs_logit": logits.abs().max().item(),
              "logit_std_mean": logits.std(dim=-1).mean().item(),
              "top1_prob_mean": torch.softmax(logits, -1).amax(-1).mean()
              .item()}
    del got, logits
    remove = _zero_head_fault(bl, config.num_hidden_layers)
    try:
        faulty = bl.forward(params, ids, config, **f32)
        nll_fault = ppl_mod.window_nlls(params, config, tokens,
                                        seqlen=EVAL_SEQLEN,
                                        batch_size=EVAL_BATCH,
                                        limit=EVAL_BATCH)
    finally:
        remove()
    rel_fault = (faulty - ref).abs().max().item() / scale
    del faulty, ref
    nll_rel_fault = float((np.abs(nll_fault - nll_ref) / nll_ref).max())
    line = {"phase": "eval_prelogits", "shape": [EVAL_BATCH, EVAL_SEQLEN],
            "max_abs_prelogit": scale, "rel_err_vs_torch": rel,
            "rel_tol": EVAL_PRELOGITS_REL_TOL, **spread,
            "fault": "B11 context of head 0 of layer 0 zeroed",
            "fault_prelogits_rel_err": rel_fault,
            "fault_window_nll_max_rel_err": nll_rel_fault,
            "nll_rel_tol": EVAL_NLL_REL_TOL}
    emit(line)
    if not (rel <= EVAL_PRELOGITS_REL_TOL
            and rel_fault > EVAL_PRELOGITS_REL_TOL):
        raise RuntimeError(f"pre-logits disagree, or the planted fault "
                           f"passes: {line}")
    return line


def eval_checks(params, config, dev) -> dict:
    """Evaluation on the unfused llama2-7b params, each run counted with
    every launch count set to 0 just before it:

    (a) ``window_nlls`` (what ``perplexity`` sums) of 8 windows of 2048 at
        batch 4 in fp32 on the kernel path, direct and vocab-chunked CE,
        against ``impl="torch"`` per window; K3 (fp32) launches, B11
        exactly 32 times per batch; then the first batch's pre-logits
        against ``impl="torch"``, with and without a planted fault
        (:func:`prelogits_checks`);
    (b) with ``lm_head`` zeroed ppl is 32000 (``limit=1``);
    (c) ``loglikelihood`` of 16 requests at batch 8 (masked, so B11 never
        launches) against ``impl="torch"``, greedy flags equal;
    (d) ``forward`` in bf16, its default dtype, on one eval batch against
        ``impl="torch"``: B11's bf16 instance, 32 launches;
    (e) ``python -m onebit_tpu_torch eval`` on a 2-layer native checkpoint
        of 7B width written by ``save_native``: its ppl equals the
        in-process ``perplexity`` of the loaded params.

    Returns the launches of K3's fp32 instance and B11's instances from
    runs (a) and (d)."""
    from onebit_tpu_torch import (loglikelihood, load_native, perplexity,
                                  save_native)
    from onebit_tpu_torch.eval import ppl as ppl_mod
    from onebit_tpu_torch.kernels import attention_cuda as fc
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.model.bitllama import forward
    n_layers, nb = config.num_hidden_layers, EVAL_WINDOWS // EVAL_BATCH
    tokens = np.random.default_rng(4).integers(
        3, config.vocab_size, EVAL_WINDOWS * EVAL_SEQLEN)
    kw = dict(seqlen=EVAL_SEQLEN, batch_size=EVAL_BATCH)

    # (a) perplexity, kernel path against impl="torch"
    nlls, walls, counts = {}, {}, {}
    for key, impl, chunk in (("kernel", "auto", None),
                             ("kernel_chunked", "auto", 4096),
                             ("torch", "torch", None)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        nlls[key] = ppl_mod.window_nlls(params, config, tokens, impl=impl,
                                        vocab_chunk=chunk, **kw)
        walls[key] = time.perf_counter() - t0
        counts[key] = read_counts()
    rel = np.abs(nlls["kernel"] - nlls["torch"]) / np.abs(nlls["torch"])
    rel_chunk = (np.abs(nlls["kernel_chunked"] - nlls["kernel"])
                 / np.abs(nlls["kernel"]))
    launches = counts["kernel"]
    line = {"phase": "eval_ppl", "windows": EVAL_WINDOWS, **kw,
            "dtype": "float32", "batches": nb,
            "ppl": ppl_mod.ppl_from_nlls(nlls["kernel"], EVAL_SEQLEN),
            "ppl_chunked": ppl_mod.ppl_from_nlls(nlls["kernel_chunked"],
                                                 EVAL_SEQLEN),
            "ppl_torch": ppl_mod.ppl_from_nlls(nlls["torch"], EVAL_SEQLEN),
            "window_nll": nlls["kernel"].tolist(),
            "max_rel_err_vs_torch": float(rel.max()),
            "rel_tol": EVAL_NLL_REL_TOL,
            "max_rel_err_chunked": float(rel_chunk.max()),
            "s_per_batch": walls["kernel"] / nb,
            "s_per_batch_chunked": walls["kernel_chunked"] / nb,
            "s_per_batch_torch": walls["torch"] / nb,
            "eval_tok_per_s": EVAL_WINDOWS * EVAL_SEQLEN / walls["kernel"],
            "launches": {k: v for k, v in launches.items() if v},
            "launches_chunked": {k: v for k, v in
                                 counts["kernel_chunked"].items() if v},
            "launches_torch": {k: v for k, v in counts["torch"].items()
                               if v}}
    emit(line)
    if not (np.isfinite(nlls["kernel"]).all()
            and rel.max() <= EVAL_NLL_REL_TOL
            and rel_chunk.max() <= EVAL_CHUNK_REL_TOL):
        raise RuntimeError(f"perplexity disagrees: {line}")
    for key in ("kernel", "kernel_chunked"):
        if counts[key][fc.FLASH_F32.name] != n_layers * nb or \
                counts[key][bc.LARGE_M_F32.name] == 0:
            raise RuntimeError(f"eval ({key}) launched {counts[key]}, not "
                               f"B11 {n_layers} times per batch and K3")
    if any(counts["torch"].values()):
        raise RuntimeError(f"impl='torch' launched {counts['torch']}")
    prelogits_checks(params, config, dev, tokens,
                     nll_ref=nlls["torch"][:EVAL_BATCH])

    # (b) the uniform model
    uniform = dict(params, lm_head=torch.zeros_like(params["lm_head"]))
    ppl_u = perplexity(uniform, config, tokens, seqlen=EVAL_SEQLEN,
                       batch_size=1, limit=1)
    del uniform
    emit({"phase": "eval_uniform", "ppl": ppl_u,
          "vocab_size": config.vocab_size, "rel_tol": 1e-4})
    if abs(ppl_u / config.vocab_size - 1) > 1e-4:
        raise RuntimeError(f"uniform-model ppl {ppl_u}, not "
                           f"{config.vocab_size}")

    # (c) loglikelihood: masked batches, B11 never launches
    reqs = _eval_requests(params, config, dev)
    out = {}
    for impl in ("auto", "torch"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out[impl] = loglikelihood(params, config, reqs, batch_size=8,
                                  impl=impl)
        out[impl + "_s"] = time.perf_counter() - t0
        out[impl + "_launches"] = read_counts()
    lls = np.array([[a[0], b[0]] for a, b in zip(out["auto"],
                                                 out["torch"])])
    ll_err = np.abs(lls[:, 0] - lls[:, 1])
    ll_ok = bool((ll_err <= EVAL_LL_TOL * (1 + np.abs(lls[:, 1]))).all())
    flips = [i for i, (a, b) in enumerate(zip(out["auto"], out["torch"]))
             if a[1] != b[1]]
    gaps = {i: _top2_gap(params, config, dev, reqs[i]) for i in flips}
    k_launch = out["auto_launches"]
    emit({"phase": "eval_loglikelihood", "requests": len(reqs),
          "batch_size": 8, "context_lengths": [len(c) for c, _ in reqs],
          "continuation_lengths": [len(c) for _, c in reqs],
          "ll": lls[:, 0].tolist(), "max_abs_err_vs_torch":
          float(ll_err.max()), "tol": EVAL_LL_TOL,
          "is_greedy": [a[1] for a in out["auto"]],
          "greedy_flips": {str(i): g for i, g in gaps.items()},
          "seconds": out["auto_s"], "seconds_torch": out["torch_s"],
          "launches": {k: v for k, v in k_launch.items() if v}})
    if not ll_ok or any(g > EVAL_GAP_TOL for g in gaps.values()) or \
            not any(a[1] for a in out["auto"]):
        raise RuntimeError("loglikelihood disagrees with impl='torch'")
    if any(k_launch[k.name] for k in fc.KERNELS) or \
            k_launch[bc.LARGE_M_F32.name] == 0:
        raise RuntimeError(f"loglikelihood launched {k_launch}")

    # (d) forward in bf16 on one eval batch: B11's bf16 instance
    ids = torch.from_numpy(tokens[:EVAL_BATCH * EVAL_SEQLEN].reshape(
        EVAL_BATCH, EVAL_SEQLEN)).to(dev)
    bf16 = {}
    for impl in ("auto", "torch"):
        torch.cuda.synchronize()
        reset_counts()
        bf16[impl] = forward(params, ids, config, impl=impl)
        bf16[impl + "_launches"] = read_counts()
    ref = bf16["torch"].abs().max().item()
    err = (bf16["auto"] - bf16["torch"]).abs().max().item()
    agree = (bf16["auto"].argmax(-1) == bf16["torch"].argmax(-1)).float()
    f_launch = bf16["auto_launches"]
    emit({"phase": "eval_forward_bf16", "shape": [EVAL_BATCH, EVAL_SEQLEN],
          "max_abs_err": err, "max_abs_logit": ref, "rel_err": err / ref,
          "rel_tol": LOGITS_REL_TOL, "argmax_agree": agree.mean().item(),
          "launches": {k: v for k, v in f_launch.items() if v}})
    del bf16
    if not err / ref <= LOGITS_REL_TOL or \
            f_launch[fc.FLASH_BF16.name] != n_layers:
        raise RuntimeError("bf16 forward disagrees or B11 (bf16) did not "
                           f"launch {n_layers} times: {f_launch}")
    launches[fc.FLASH_BF16.name] = f_launch[fc.FLASH_BF16.name]

    # (e) the command line on a 2-layer native checkpoint of 7B width
    from onebit_tpu_torch import BitLlamaConfig, host_random_packed_params
    small = BitLlamaConfig.named("llama2-7b", num_hidden_layers=2)
    ckpt = os.path.join(ROOT, "build", "smoke_ckpt")
    save_native(ckpt, small, host_random_packed_params(small, seed=1,
                                                       device=dev))
    np.save(os.path.join(ckpt, "tokens.npy"), tokens)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "onebit_tpu_torch", "eval", "--ckpt", ckpt,
         "--tokens", os.path.join(ckpt, "tokens.npy"), "--seqlen",
         str(EVAL_SEQLEN), "--limit", "2"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"the eval command failed:\n{run.stderr[-3000:]}")
    cli_ppl = json.loads(run.stdout.strip().splitlines()[-1])["ppl"]
    loaded = load_native(ckpt, device=dev)
    want = perplexity(loaded["params"], loaded["config"], tokens,
                      seqlen=EVAL_SEQLEN, limit=2)
    emit({"phase": "eval_cli", "ckpt_layers": 2, "cli_ppl": cli_ppl,
          "in_process_ppl": want, "rel_tol": 1e-5, "cli_seconds": cli_s})
    if abs(cli_ppl / want - 1) > 1e-5:
        raise RuntimeError(f"the eval command's ppl {cli_ppl} is not the "
                           f"in-process {want}")
    return {k.name: launches[k.name] for k in (bc.LARGE_M_F32, *fc.KERNELS)}


# ---------------------------------------------------------------------------
# phase 6: KD training at full llama2-7b width, depth cut to 4 layers
# ---------------------------------------------------------------------------

# Depth only is cut: at 7B width a layer holds its fp32 latent weights,
# their gradients and two Adam moments (3.2 GB), its share of the fp32
# teacher (0.8 GB) and some 9 GB of activations at 4 x 2048 tokens (the
# latent projections keep fp32 copies for their products), so 4 layers fit
# one 80 GB card beside the embeddings and the [4, 2048, 32000] logits of
# the KL; the 32 of llama2-7b need a sharded model (ROADMAP.md §1 item 8).
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQLEN, TRAIN_STEPS = 4, 4, 2048, 3
# The first KD step's loss and each trainable leaf's gradient on the kernel
# path against impl="torch", relative to the leaf's largest |gradient|.
# fp32: the two paths differ only in B11's and its backward's summation
# order and in P recomputed from the log-sum-exp, a few 1e-6 relative
# (FLASH_BWD_TOL) carried through 4 layers into sums over 8192 tokens:
# 1e-4, the eval pre-logits' limit. bf16: both paths round activations to
# bf16 at different places, each a relative 2**-8, through 4 layers: 5e-2,
# the logits' limit (LOGITS_REL_TOL). The planted fault (layer 0's dq of
# head 0 zeroed) removes one of 32 heads' share of layer 0's q_proj
# gradient and must break the fp32 limit.
TRAIN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: LOGITS_REL_TOL}


def _zero_dq_head_fault(fc, n_layers: int):
    """Install a planted fault in B11-dq: head 0 of its output zeroed in
    layer 0 of each backward pass (the backward walks the layers last to
    first, so layer 0 is the last of each ``n_layers`` calls). Returns the
    function that removes it."""
    real = fc.launch_bwd_dq
    calls = []

    def faulty(*args, **kw):
        dq = real(*args, **kw)
        if len(calls) % n_layers == n_layers - 1:
            dq[:, :, 0] = 0
        calls.append(1)
        return dq

    fc.launch_bwd_dq = faulty

    def remove():
        fc.launch_bwd_dq = real
    return remove


def _kd_grads(config, kd_cfg, params, teacher, batch, dtype, impl):
    """One remat micro-step of the KD loss (no update), every count set to
    0 just before it: ``(loss, [grad per trainable leaf], counts)``."""
    from onebit_tpu_torch.train import trainer as tt
    loss_fn, teacher_fwd = tt._build_loss(config, kd_cfg,
                                          tt.TrainConfig(remat=True), dtype,
                                          impl)
    leaves = tt.trainable_leaves(params)
    for p in leaves:
        p.grad = None
    torch.cuda.synchronize()
    reset_counts()
    loss, _ = loss_fn(params, teacher_fwd(teacher, batch), batch)
    loss.backward()
    counts = read_counts()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return loss.item(), grads, counts


def _grad_rel(grads, ref) -> float:
    """The largest over leaves of max |g - g_ref| / max |g_ref|."""
    return max(((g - r).abs().max() / r.abs().max()).item()
               for g, r in zip(grads, ref))


def _device_ms(prof) -> tuple:
    """The profiled window's device time (ms, summed over kernels) and its
    ten largest kernels by device time."""
    from torch.autograd import DeviceType
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, name):
                kernels[evt.key[:80]] = float(getattr(evt, name)) / 1e3
                break
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return sum(kernels.values()), [{"name": k, "ms": v} for k, v in top]


def train_checks(dev) -> dict:
    """KD training at llama2-7b width, 4 layers (TRAIN_LAYERS):

    (a) a random plain teacher (``init_params`` mode "linear", fp32,
        ``torch.Generator`` seed 0) and its SVID start student
        (``build_start_params``);
    (b) the first KD step's loss and gradients at batch 4 x 2048 with
        remat, kernel path against impl="torch", in fp32 and in bf16
        (TRAIN_GRAD_TOL); B11 launches 3 times a layer (student, its
        recomputation, teacher), B11-dkv and B11-dq once;
    (c) the fp32 step again with a planted fault in B11-dq
        (:func:`_zero_dq_head_fault`), which must break the limit;
    (d) three KD steps (``make_train_step``) at the reference recipe
        (kd_alpha 1, kd_beta 1, kd_loss_scale 0.01, kd_gamma 0; bf16
        compute; AdamW (0.9, 0.98), wd 0.01, cosine with warmup 1), no
        remat, every count set to 0 before them: finite losses, B11 (bf16)
        exactly 2 x 4 x 3 launches, B11-dkv and B11-dq 4 x 3; ms per step,
        training tokens/s, peak memory, the device busy share (the third
        step profiled);
    (e) ``pack_model_params`` of the trained student, then one fp32
        perplexity batch on the kernel path (K3, B11) against impl="torch".

    Returns the backward kernels' launches: fp32 from (b), bf16 from (d)."""
    from torch.profiler import ProfilerActivity, profile

    from onebit_tpu_torch import BitLlamaConfig
    from onebit_tpu_torch.core.build_start import build_start_params
    from onebit_tpu_torch.eval import ppl as ppl_mod
    from onebit_tpu_torch.kernels import attention_cuda as fc
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.model.bitllama import init_params, pack_model_params
    from onebit_tpu_torch.train.data import batch_iterator
    from onebit_tpu_torch.train.losses import KDConfig
    from onebit_tpu_torch.train.trainer import (TrainConfig,
                                                init_train_state,
                                                make_train_step)
    L = TRAIN_LAYERS
    config = BitLlamaConfig.named("llama2-7b", num_hidden_layers=L)
    emit({"phase": "train_config", "config": "llama2-7b", "layers": L,
          "full_depth": 32, "batch": [TRAIN_BATCH, TRAIN_SEQLEN],
          "reduced": "depth 32 -> 4: at 7B width a layer's fp32 latent "
                     "weights, gradients, Adam moments, teacher share and "
                     "activations take about 13 GB; 32 layers need a "
                     "sharded model (ROADMAP.md §1 item 8)"})
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    teacher = init_params(config, gen, mode="linear", device=dev)
    student = build_start_params(teacher)
    torch.cuda.synchronize()
    emit({"phase": "train_start", "seconds": time.perf_counter() - t0,
          "teacher": "linear fp32, torch.Generator seed 0",
          "student_h_finite": all(
              bool(torch.isfinite(student["layers"][n].weight_scale).all())
              for n in ("q_proj", "down_proj"))})
    kd_cfg = KDConfig(kd_alpha=1.0, kd_beta=1.0, kd_gamma=0.0,
                      kd_loss_scale=0.01)
    rng = np.random.default_rng(7)
    blocks = rng.integers(3, config.vocab_size,
                          (TRAIN_STEPS * TRAIN_BATCH, TRAIN_SEQLEN)
                          ).astype(np.int32)
    first = {k: torch.from_numpy(blocks[:TRAIN_BATCH]).long().to(dev)
             for k in ("input_ids", "labels")}
    launches = {}

    # (b), (c): the first step's gradients, kernel path against impl="torch"
    for dtype, fwd, dkv, dq in (
            (torch.float32, fc.FLASH_F32, fc.FLASH_DKV_F32, fc.FLASH_DQ_F32),
            (torch.bfloat16, fc.FLASH_BF16, fc.FLASH_DKV_BF16,
             fc.FLASH_DQ_BF16)):
        loss_k, g_k, counts = _kd_grads(config, kd_cfg, student, teacher,
                                        first, dtype, "auto")
        loss_t, g_t, counts_t = _kd_grads(config, kd_cfg, student, teacher,
                                          first, dtype, "torch")
        rel = _grad_rel(g_k, g_t)
        loss_rel = abs(loss_k - loss_t) / abs(loss_t)
        del g_k
        tol = TRAIN_GRAD_TOL[dtype]
        line = {"phase": "train_grads", "dtype": str(dtype)[6:],
                "remat": True, "loss": loss_k, "loss_torch": loss_t,
                "loss_rel_err": loss_rel, "grad_max_rel_err": rel,
                "rel_tol": tol,
                "launches": {k: v for k, v in counts.items() if v},
                "launches_torch": {k: v for k, v in counts_t.items() if v}}
        want = {fwd.name: 3 * L, dkv.name: L, dq.name: L}
        counted = {k: v for k, v in counts.items() if v and "flash" in k}
        ok = (math.isfinite(loss_k) and rel <= tol and loss_rel <= tol
              and counted == want and not any(counts_t.values()))
        if dtype == torch.float32:
            launches.update({dkv.name: counts[dkv.name],
                             dq.name: counts[dq.name]})
            remove = _zero_dq_head_fault(fc, L)
            try:
                _, g_f, _ = _kd_grads(config, kd_cfg, student, teacher,
                                      first, dtype, "auto")
            finally:
                remove()
            line["fault"] = "B11-dq of head 0 of layer 0 zeroed"
            line["fault_grad_max_rel_err"] = _grad_rel(g_f, g_t)
            ok = ok and line["fault_grad_max_rel_err"] > tol
            del g_f
        del g_t
        torch.cuda.empty_cache()
        emit(line)
        if not ok:
            raise RuntimeError(f"train gradients disagree, launches are not "
                               f"{want}, or the planted fault passes: {line}")

    # (d) three KD steps at the reference recipe
    train_cfg = TrainConfig(warmup_steps=1, total_steps=TRAIN_STEPS)
    state = init_train_state(student, train_cfg)
    step = make_train_step(config, kd_cfg, train_cfg,
                           compute_dtype=torch.bfloat16)
    batches = batch_iterator(blocks, TRAIN_BATCH, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_s, metrics = [], []
    for i in range(TRAIN_STEPS):
        batch = next(batches)
        t = time.perf_counter()
        if i == TRAIN_STEPS - 1:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, m = step(state, teacher, batch)
                torch.cuda.synchronize()
        else:
            state, m = step(state, teacher, batch)
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        metrics.append({k: v.item() for k, v in m.items()})
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    device_ms, top = _device_ms(prof)
    steady_s = step_s[1]
    want = {fc.FLASH_BF16.name: 2 * L * TRAIN_STEPS,
            fc.FLASH_DKV_BF16.name: L * TRAIN_STEPS,
            fc.FLASH_DQ_BF16.name: L * TRAIN_STEPS}
    counted = {k: v for k, v in counts.items() if v and "flash" in k}
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    line = {"phase": "train", "steps": TRAIN_STEPS, "layers": L,
            "batch": [TRAIN_BATCH, TRAIN_SEQLEN], "dtype": "bfloat16",
            "recipe": "kd_alpha 1, kd_beta 1, kd_loss_scale 0.01, kd_gamma "
                      "0; AdamW (0.9, 0.98), wd 0.01, lr 4e-4, cosine, "
                      "warmup 1, clip 1.0",
            "metrics": metrics, "step_s": step_s,
            "ms_per_step": steady_s * 1e3,
            "train_tok_per_s": TRAIN_BATCH * TRAIN_SEQLEN / steady_s,
            "peak_mem_gb": peak_gb,
            "profiled_step_device_ms": device_ms,
            "device_busy_share": device_ms / (steady_s * 1e3),
            "profiled_step_top_kernels": top,
            "launches": {k: v for k, v in counts.items() if v}}
    emit(line)
    if not finite or counted != want:
        raise RuntimeError(f"KD steps: non-finite metrics or launches not "
                           f"{want}: {line}")
    launches.update({k: counts[k] for k in (fc.FLASH_DKV_BF16.name,
                                            fc.FLASH_DQ_BF16.name)})
    del teacher
    torch.cuda.empty_cache()

    # (e) pack the trained student, one fp32 perplexity batch
    packed = pack_model_params(state.params)
    del state, student
    torch.cuda.empty_cache()
    tokens = blocks[:TRAIN_BATCH].reshape(-1)
    nlls, counts = {}, {}
    for impl in ("auto", "torch"):
        torch.cuda.synchronize()
        reset_counts()
        nlls[impl] = ppl_mod.window_nlls(packed, config, tokens,
                                         seqlen=TRAIN_SEQLEN,
                                         batch_size=TRAIN_BATCH, impl=impl)
        counts[impl] = read_counts()
    rel = float((np.abs(nlls["auto"] - nlls["torch"])
                 / np.abs(nlls["torch"])).max())
    k = counts["auto"]
    line = {"phase": "train_packed_ppl", "window_nll": nlls["auto"].tolist(),
            "ppl": ppl_mod.ppl_from_nlls(nlls["auto"], TRAIN_SEQLEN),
            "max_rel_err_vs_torch": rel, "rel_tol": EVAL_NLL_REL_TOL,
            "launches": {n: v for n, v in k.items() if v}}
    emit(line)
    if not (np.isfinite(nlls["auto"]).all() and rel <= EVAL_NLL_REL_TOL
            and k[fc.FLASH_F32.name] == L and k[bc.LARGE_M_F32.name] > 0
            and not any(counts["torch"].values())):
        raise RuntimeError(f"the packed student's perplexity: {line}")
    del packed
    torch.cuda.empty_cache()
    train_cli_check(dev)
    return launches


def train_cli_check(dev) -> None:
    """The command line on a 2-layer checkpoint of 7B width under
    ``build/smoke_train``: ``build-start-ckpt`` from a bf16 plain teacher,
    ``train --tokens`` (2 steps at 4 x 2048, warmup 1), ``convert``. The
    logged final loss must equal two in-process steps of ``run_kd``'s
    train step on the same checkpoints and batches, and the packed
    checkpoint's signs those of the trained latent weights. The directory
    (some 10 GB) is removed after."""
    import shutil

    from onebit_tpu_torch import BitLlamaConfig, load_native, save_native
    from onebit_tpu_torch.model.bitllama import init_params, pack_model_params
    from onebit_tpu_torch.train.data import batch_iterator
    from onebit_tpu_torch.train.losses import KDConfig
    from onebit_tpu_torch.train.run_kd import KDRunConfig
    from onebit_tpu_torch.train.trainer import (TrainConfig, clone_params,
                                                init_train_state,
                                                make_train_step)
    small = BitLlamaConfig.named("llama2-7b", num_hidden_layers=2)
    root = os.path.join(ROOT, "build", "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    save_native(os.path.join(root, "teacher"), small,
                init_params(small, gen, mode="linear", dtype=torch.bfloat16,
                            device=dev))
    blocks = np.random.default_rng(8).integers(
        3, small.vocab_size, (2 * TRAIN_BATCH, TRAIN_SEQLEN)).astype(np.int32)
    np.save(os.path.join(root, "blocks.npy"), blocks)
    seconds = {}

    def cli(*args):
        t = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "onebit_tpu_torch",
                              *args], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        seconds[args[0]] = time.perf_counter() - t
        if run.returncode != 0:
            raise RuntimeError(f"{args[0]} failed:\n{run.stderr[-3000:]}")

    try:
        cli("build-start-ckpt", os.path.join(root, "teacher"),
            os.path.join(root, "start"))
        cli("train", "--student", os.path.join(root, "start"), "--teacher",
            os.path.join(root, "teacher"), "--tokens",
            os.path.join(root, "blocks.npy"), "--batch-size",
            str(TRAIN_BATCH), "--max-steps", "2", "--warmup-steps", "1",
            "--save-total-limit", "1", "--output-dir",
            os.path.join(root, "out"))
        cli("convert", os.path.join(root, "out", "final"),
            os.path.join(root, "packed"))
        with open(os.path.join(root, "out", "trainer_log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        start = load_native(os.path.join(root, "start"), device=dev)
        teacher = load_native(os.path.join(root, "teacher"), device=dev)
        # what run_kd does for these flags: 2 steps of warmup 1 (the CLI's
        # --warmup-steps 1 < total 2 is kept), seed 42's batches
        run_cfg = KDRunConfig()
        train_cfg = TrainConfig(warmup_steps=1, total_steps=2)
        kd_cfg = KDConfig(kd_alpha=1.0, kd_beta=1.0, kd_gamma=0.0,
                          kd_loss_scale=0.01)
        state = init_train_state(clone_params(start["params"]), train_cfg)
        del start
        step = make_train_step(small, kd_cfg, train_cfg,
                               compute_dtype=run_cfg.compute_dtype)
        it = batch_iterator(blocks, TRAIN_BATCH, seed=run_cfg.seed)
        for _ in range(2):
            state, m = step(state, teacher["params"], next(it))
        loss = m["loss"].item()
        del teacher
        final = load_native(os.path.join(root, "out", "final"), device=dev)
        packed = load_native(os.path.join(root, "packed"), device=dev)
        want = pack_model_params(final["params"])
        same_signs = all(torch.equal(packed["params"]["layers"][n].packed,
                                     want["layers"][n].packed)
                         for n in ("q_proj", "k_proj", "v_proj", "o_proj",
                                   "gate_proj", "up_proj", "down_proj"))
        line = {"phase": "train_cli", "ckpt_layers": 2,
                "cli_final_loss": log[-1]["loss"], "in_process_loss": loss,
                "rel_tol": 1e-5, "log_steps": [e["current_steps"]
                                              for e in log],
                "checkpoints": sorted(os.listdir(os.path.join(root, "out"))),
                "packed_signs_equal": same_signs, "seconds": seconds}
        emit(line)
        if not (abs(log[-1]["loss"] / loss - 1) <= 1e-5 and same_signs):
            raise RuntimeError(f"the train command line: {line}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
          "ptxas": {s: ptxas_summary(p.read_text()) for s, p in logs.items()
                    if p.exists()}})
    results = kernel_checks(dev)
    results.update(kv_kernel_checks(dev))
    results.update(paged_kernel_checks(dev))
    results.update(flash_kernel_checks(dev))
    results.update(flash_bwd_kernel_checks(dev))
    results.update(flat_kernel_checks(dev))
    shares = {name: r["bound_ms"] / r["ms"] for name, r in results.items()}
    emit({"phase": "kernel", "bound_share": shares})
    if max(shares.values()) > 1:
        raise RuntimeError(f"a kernel ran faster than its bound: {shares}")
    launches = end_to_end(dev)
    emit({"phase": "done", "wall_s": time.perf_counter() - t_wall})
    emit({"kernels": [
        {"name": k.name, "route": k.route, "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         **results[k.name],
         **({"launches_of": "rank 0 of the dense tensor-parallel run"}
            if k.name.startswith("bitlinear_raw") else {})}
        for k in all_kernels()]})
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
