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
   events (every timed run enqueued behind a device sleep, so that the
   events time the device, not the host's launches; K1, K2 and B4's
   small-M instance cold, cycling over copies of their words past 64 MB, as
   decode reads them, and their matmul yardstick over copies of its sign
   matrix) beside its bound, its plain version and one PyTorch matmul (K3
   twice: bf16 at the prefill's M = 2048, and its fp32 instance on one eval
   layer's seven projections at M = 8192), and B4, the raw projection of a
   tensor-parallel shard (K1 and K3 with ``raw=True``, counted as their own
   instances), at the four shard shapes of llama2-7b over two ranks (M = 8,
   fp32 z; and M = 2048 on the q and down shards, bf16 z); then
   each KV-attention kernel (B5-B8) on full-size llama2-7b int8 and int4
   pools at layer 31 with ragged rows, and on GQA pools of the same width
   (nkv 8, g 4): pools bit-exact with the plain version, timed beside its
   bound, its plain version and one ``scaled_dot_product_attention`` on
   K/V dequantized beforehand, with ``ptxas`` registers and spills and
   shared bytes a CTA; then B10
   (paged attention) on a full-size llama2-7b page pool, bf16, int8 and
   fp8 e4m3 pages, the same way, and the same bits from a second call (fp8
   with a planted fault, kv head 0's context zeroed, that must fail); then
   B11
   (causal flash attention) at the llama2-7b eval shape [4, 2048, 32, 128]
   and a GQA case (nkv 8) in fp32 and bf16, beside
   ``scaled_dot_product_attention(is_causal=True)``; B10 and B11 fp32 with
   ``ptxas`` registers and spills and shared bytes a CTA; then its
   backward kernels B11-dkv and B11-dq at the same shapes, the gradients
   through B11's autograd rule against autograd through the plain version,
   beside the backward of ``scaled_dot_product_attention``, each kernel
   with its bound share, ``ptxas`` registers and spills, and shared bytes a
   CTA; then B9 (decode
   attention over the flat pools) at layer 31 of full llama2-7b pools
   [32, 8, 2048, 32, 128], int8 with scales, bf16 (and a GQA case, nkv 8),
   fp32 and fp8 e4m3 (bf16 q; with the planted fault of B10 fp8), rows of
   1-2048 positions with starts and one empty row, beside
   ``scaled_dot_product_attention`` with a boolean mask (on K/V made in
   bf16 before the timed window); last, each
   kernel's share of its bound (bound_ms / ms; K3's fp32 instance bounded
   by three bf16 tensor-core passes, B11's by twelve bf16 products and
   B11-dkv's and B11-dq's by six bf16 products an fp32 product, the
   arithmetic they run), none of which may pass 1;
4. the slice's paths end to end at full llama2-7b width and depth on random
   packed weights (``host_random_packed_params(seed=0)`` and
   ``fuse_for_decode``), each an 8-slot ``ContinuousBatchingEngine``
   serving 8 greedy requests of 32 new tokens:
   * the dense cache at ``max_len=256``, four prompts of 129-200 tokens
     (prefill through K3) and four under 32;
   * ``quantized_kv=True`` (int8 pools) and ``quantized_kv="int4"`` at
     ``max_len=2048``, prompts of 700-1900 tokens (buckets 1024 and 2048).
   * ``paged=True`` (page_size 16, max_len 2048) with bf16 pages, with
     int8 pages (``quantized_kv=True``) and with fp8 e4m3 pages
     (``quantized_kv="fp8"``), the same deep prompts: decode attention
     through the page tables in B10;
   * ``paged=True, prefix_cache=True``: eight prompts of one shared
     1024-token prefix and distinct suffixes of 100-450 tokens.
   Each but the prefix run first holds the first decode step's logits on
   the kernel path against ``impl="torch"``. Then a served run with every
   launch count set to 0 before it: K1-K3 must launch in each, B9 (dense),
   the fused append+attend kernel (B5, B7) or B10 exactly 32 times per
   decode step,
   every page must be back in the pool (the prefix run: all but those the
   cache holds), and the prefix run must reuse 7 x 64 = 448 pages. After
   each served run the same prompts go through an engine with
   ``block_steps=8, pipeline_blocks=True`` (:func:`block_run`): each block
   one CUDA graph, captured in ``warmup`` and replayed; its tokens must be
   the served run's, token for token, the per-step kernel must launch
   exactly 32 times a step the replays ran (all inside the graph), K1 and
   K2 inside it too, pages as above; each line gives the capture and
   instantiate seconds, the graph pool's bytes, ms per token-step (a
   replaying engine iteration's wall over 8, and a replay's device time
   over 8), host ms per block, decode tok/s and the busy share of one
   profiled block (its kernels' device time over its wall; the profiler's
   count of the port's kernels in that block must be what the graph
   recorded a replay). A dense block captured with one kv head of B9
   zeroed in layer 0 must give other tokens (:func:`block_fault_check`).
   Then the serving surface (:func:`serve_surface_checks`, phase
   ``serve_surface``): dense chunked prefill (chunks of 64 at max_len
   256, K1/K2; chunks of 256 on int8 pools at 2048, K3 bf16), tokens equal
   to the served runs' off near-ties, first-chunk logits against
   ``impl="torch"``; speculative decoding with ``build_draft``'s 2-layer
   spread draft, 4 proposals a round, on the dense, int8 and paged bf16
   targets (tokens equal to the served runs' off near-ties, launches
   exactly 84 K1, 84 K2 and 10 B9 a round, rounds, tokens a round and ms
   a token beside the plain engine's), a request that fills max_len and a
   sampled engine; ``beam_generate`` against ``impl="torch"`` (B9
   exactly 32 x 15). Then
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
   engine with ``tp_group`` on the unfused weights at full width; the
   first decode step's logits at full depth against the single-device
   engine's and ``impl="torch"``, with a planted fault (rank 1's share of
   layer 0's o_proj all-reduce dropped) that must break their limit; then
   served runs on the first 4 of the 32 layers (``TP_RUN_LAYERS``, to
   keep the script under 11 minutes: dense at ``max_len=256``, the same in
   eager decode blocks of 8, whose tokens must be the dense run's, int8 KV
   pools, paged int8 pages with the prefix cache, paged fp8 pages (16 new
   tokens)) in which both ranks emit the same tokens, B4 launches exactly
   7 x 4 times per forward pass, B9, B5 or B10 exactly 4 times per decode
   step and K1-K3 never; then the greedy speculative round under TP (16
   new tokens) on the dense and int8 targets with the 2-layer spread draft
   whole on each rank: the ranks' tokens equal, each round exactly B4
   7 x 4, K1 and K2 20 and B9 10, nothing else;
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
   reference directory (the tokens of the in-process ``generate``),
   ``eval --check-engines all`` (``engine_check.ok`` 1), ``serve
   --block-steps 8 --pipeline-blocks`` on stdin lines of ids and ``serve
   --http 0`` (one POST /generate, one GET /metrics), each with the tokens
   of an engine in this process; and ``build-draft``, ``serve --draft``,
   ``generate --num-beams``, then ``serve --tp 2 --tp-backend gloo`` with
   the draft on stdin and with ``--http 0`` (:func:`serve_surface_cli`);
6. KD training at llama2-7b width, depth cut to 4 layers
   (:func:`train_checks`): a random plain teacher and its SVID start
   student; the first KD step's loss and gradients on the kernel path
   against ``impl="torch"`` in fp32 and bf16, and a planted fault (one
   head's dq zeroed in layer 0) that must break the fp32 limit, and each
   dtype's micro-step again under the profiler for its device ms; three KD
   steps at the reference recipe (batch 4 x 2048, bf16): finite losses, B11
   2 x 4 x 3 and B11-dkv, B11-dq 4 x 3 launches, ms per step, training
   tokens/s, peak memory, device busy share; the trained student packed
   and one fp32 perplexity batch through K3 and B11; then
   ``build-start-ckpt``, ``train --tokens`` and ``convert`` on a 2-layer
   checkpoint of 7B width under ``build/``;
7. the zero-shot task harness (:func:`tasks_checks`) on phase 5's
   weights, made again from their seed: PIQA, ARC-Easy, ARC-Challenge, BoolQ,
   HellaSwag, Winogrande, LAMBADA and an MMLU subject, 8 synthetic docs
   each in their published schemas, through ``evaluate_tasks`` in a byte
   tokenizer, zero-shot and (HellaSwag) one-shot, on the kernel path and
   with impl="torch": every request's log-likelihood within EVAL_LL_TOL x
   (1 + |ll|), greedy flags and acc/acc_norm equal but at near-ties, K3
   fp32 launched and B11 never; the per-task table; then one greedy-until
   batch through the harness (K1, K2, B9 exactly 32 x 15 launches) whose
   texts must be ``generate``'s, and whose tokens may part from
   impl="torch"'s only at bf16 near-ties; then the task registry
   (:func:`registry_checks`) on the same weights, fused: the count of
   its names, and one task of each module whose metric needs no package
   beyond numpy (RTE, COPA, OpenBookQA, TriviaQA, GSM8K, MATH algebra, a
   BLiMP paradigm, a pile subset, arithmetic, LAMBADA cloze, WikiText), 4
   synthetic docs each, zero-shot at the command line's batch of 4, on the
   kernel path, with impl="torch" (log-likelihoods, greedy flags, rolling
   sums and generated texts held as above) and through ``lm=NativeLM``
   (the kernel path's results and requests exactly); K3 fp32, K1, K2 and
   B9 launched; the janitor's C core built here and its n-grams against
   the Python scan's; one ``{"text": ...}`` request to an
   ``EngineServer`` holding a byte tokenizer, answered as the
   ``{"prompt": ...}`` request of its bytes; and neither
   ``transformers``, ``sklearn``, ``sacrebleu`` nor ``zstandard``
   imported;
8. SFT at llama2-7b width, 4 layers (:func:`sft_checks`): ``run_sft`` of
   16 pairs (alpaca template, cutoff 512, batch 4, bf16) for 3 steps on
   the kernel path and with impl="torch": finite losses, the first step's
   loss and grad norm within 1e-3, ms per step, peak memory; then
   ``save_predictions`` of the trained student, packed and fused, on 4
   prompts (K1, K2, B9 launched; its jsonl and metrics files);
9. between training and the task harness, the ``parallel`` phase
   (:func:`parallel_checks`): fully sharded KD training at llama2-7b
   width, 2 layers, on two gloo ranks sharing the card, after its memory
   plan (``parallel/memplan.py``): the sharded step's loss and gradients
   against the single-device step's on the same global batch 4 x 2048, a
   planted reduce-scatter fault, 2 steps with exact B11 launches, each
   rank's ms a step, tokens/s and peak memory beside the plan, a sharded
   train state saved and read back bit for bit; then tensor-parallel KD
   training (``tp_train``) on the same two ranks as the mesh (1, 2), each
   rank 16 heads and the model shard of every projection: its plan, the
   step's loss and gradients against the same single-device step, a
   planted fault in the backward of the LayerNorm statistics'
   all-reduce, 3 steps with exact B11 launches, ms a step, tokens/s and
   peak memory beside the plan; and, with the command lines of phase 6,
   ``serve --tp 2`` as the two processes of a multi-host launch
   (``--coordinator``).

Then the wall time, the ``kernels`` line (each kernel's launches from the
run of its own path, and ``graph_launches``, those that the graph replays
of its path's block run made; B6 and B8 are on none; B4's from rank 0 of
the dense tensor-parallel run; B9's from the bf16 and fp32
``generate`` runs and the flat int8 run, B9 fp8's none (on no path);
B10's from the paged bf16, int8 and fp8 runs; K3's fp32 instance's and
B11's from the fp32 perplexity run, B11 bf16's from the bf16 forward, B11-dkv's and B11-dq's fp32 instances'
from the fp32 gradient check of phase 6 and their bf16 instances' from
its three KD steps; the bf16 ones also as ``parallel_launches``, rank
0's in the sharded steps, and ``tp_train_launches``, rank 0's in the
tensor-parallel steps), the
card's name and power
limit as ``nvidia-smi`` prints them, and a last line ``{"ok": true,
"device": ...}``. Any failure exits nonzero without that line. Needs one
card; exits nonzero when no card is present or the package is not beside
this script.
"""

from __future__ import annotations

import contextlib
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
_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line gets ``t_s``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _START)
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
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls
    enqueued behind a device-side sleep that outlasts their enqueue (twice
    the warm-up's host time a call), so that the events time the calls back
    to back, never the host's gaps between launches of a kernel faster
    than its Python wrapper."""
    t = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t) / max(warmup, 1)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2 * iters * host_s + 1e-3, 0.2) * 2e9))
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


# the small-M kernels (K1, K2, B4 small-M) are timed cycling over copies of
# each case's packed words whose total passes this, as decode reads each
# layer's words once, cold, from HBM (the L2 holds 50 MB); the matmul
# yardstick cycles over copies of its dense sign matrix the same way
COLD_BYTES = 64 * 2 ** 20


def cold_copies(t: torch.Tensor, at_least: int = 1) -> list:
    """``t`` and clones of it, together past ``COLD_BYTES``."""
    n = max(at_least, COLD_BYTES // (t.numel() * t.element_size()) + 1)
    return [t] + [t.clone() for _ in range(n - 1)]


def small_m_launch(bc, c):
    """The small-M kernel's plan for case ``c``: block_n, splits, kw, CTAs
    and dynamic shared bytes a CTA (the layout of
    ``csrc/bitlinear_small_m.cu``); None for a checkout without the plan."""
    if not hasattr(bc, "small_m_plan"):
        return None
    m, k, n, ns = c["m"], c["k"], c["packed"].shape[1], c["ns"]
    bn, splits, kw, _ = bc.small_m_plan(
        m, k, n, ns, torch.cuda.get_device_properties(0).multi_processor_count)
    elem = c["x"].element_size()
    row = bn * 4 + 9 * 32 * elem                 # words, 8 x rows, g
    red = 8 * 8 * (bn + 4) * 4 + 8 * bn * 4      # warps' sums, z tile
    ctas = -(-n // bn) * splits * -(-m // 8)
    return [bn, splits, kw, ctas, max(kw * row, red)]


def kernel_checks(dev) -> dict:
    import itertools
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

    def calls(name, c, p=None):
        x, g, h, nt = c["x"], c["g"], c["h"], c["n_true"]
        p = c["packed"] if p is None else p
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
            y = c["x"] * c["g"][0]
            if c["m"] <= bc.SMALL_M_MAX:
                words = itertools.cycle(cold_copies(c["packed"]))
                signs = itertools.cycle(cold_copies(c["sign"], 2))
                ms += cuda_ms(lambda: calls(info.name, c, next(words))[0](),
                              iters)
                lib_ms += cuda_ms(lambda: torch.matmul(y, next(signs).T),
                                  iters)
                del words, signs
            else:
                ms += cuda_ms(kern, iters)
                lib_ms += cuda_ms(lambda: torch.matmul(y, c["sign"].T),
                                  iters)
            plain_ms += cuda_ms(plain, 2, warmup=1)
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
        plans = [small_m_launch(bc, c) for c in cases[info.name]
                 if c["m"] <= bc.SMALL_M_MAX]
        emit({"phase": "kernel", "name": info.name, "tol": tol, "ok": ok,
              "dtype": str(dtype).replace("torch.", ""),
              "m": [c["m"] for c in cases[info.name]],
              "k_n": [[c["k"], c["n_true"]] for c in cases[info.name]],
              **({"cold_copies_past_bytes": COLD_BYTES,
                  "plans_block_n_splits_kw_ctas_smem": plans}
                 if plans else {}),
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

KV_SHAPE = (32, 8, 32, 128, 2048)      # L, B, nh, hd, T: llama2-7b pools
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
    """B5-B8 on full-size llama2-7b pools at layer 31 (nkv 32), and on the
    GQA pools of the same width (nkv 8, g 4): bf16 q, random pools and
    scales, ragged rows. Pools must be bit-exact with the plain version
    after the call, ctx within KV_TOL_BF16 on the active rows (each with a
    largest |ctx| of at least 8 times it) and finite on the inactive one.
    Timed cycling over the 32 layers, so that each launch finds its layer's
    pools out of the L2 cache, as the decode step does; beside its bound,
    its plain version and one ``scaled_dot_product_attention`` on the
    layer's K/V dequantized beforehand (GQA: repeated), each row with its
    bound share, ``ptxas`` registers and spills and shared bytes a CTA. The
    ``kernels`` line carries the nkv 32 rows."""
    import itertools
    import torch.nn.functional as F
    from onebit_tpu_torch.kernels import kv_attention as ka
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    n_layers, b, nh, hd, t = KV_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lengths = torch.tensor(KV_LENGTHS, dtype=torch.int32, device=dev)
    pos = torch.tensor([n - 1 if n else KV_FROZEN_POS for n in KV_LENGTHS],
                       dtype=torch.int32, device=dev)
    q = (KV_Q_STD * torch.randn(b, nh, hd, generator=gen, device=dev)
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
    for int4, nkv in itertools.product((False, True), (nh, FLASH_GQA_NKV)):
        g = nh // nkv
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
        k_deq, v_deq = (x.repeat_interleave(g, dim=1) for x in
                        _dequantized_layer(pools, int4, KV_LAYER))
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
            bound_ms, bound_by = _kv_bound(KV_LENGTHS, nkv, g, hd, t, int4,
                                           append)
            del plain_pools, kern_pools
            line = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=lib_ms)
            if nkv == nh:
                results[info.name] = line
            # the bf16-q instance's mangled name: HD, G, APPEND, INT4
            resources = {
                "ptxas_regs_spill_stores_loads": _ptxas_of(
                    info.library, "15kv_attention_ktI13__nv_bfloat16",
                    f"Li{hd}ELi{g}ELb{int(append)}ELb{int(int4)}E"),
                "smem_bytes": _smem_bytes(kc, info, torch.bfloat16, hd, g)}
            ok = (exact and finite and err <= KV_TOL_BF16
                  and ctx_scale >= 8 * KV_TOL_BF16)
            emit({"phase": "kernel", "name": info.name, "tol": KV_TOL_BF16,
                  "ok": ok, "pools_bit_exact": exact, "ctx_finite": finite,
                  "min_row_max_abs_ctx": ctx_scale,
                  "layer": KV_LAYER,
                  "pool_shape": [n_layers, b, nkv, hd, t], "nkv": nkv,
                  "g": g, "lengths": KV_LENGTHS,
                  "bound_share": bound_ms / ms, **resources, **line})
            if not ok:
                raise RuntimeError(f"{info.name} (nkv {nkv}): pools exact "
                                   f"{exact}, finite {finite}, max_abs_err "
                                   f"{err}, smallest row max |ctx| "
                                   f"{ctx_scale}")
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
    its length (int8, ``quant`` True: with their scales; int8 and fp8 one
    byte an element, bf16 two), the page-table entries of its pages under
    the length and its length read once, q read, the float32 output
    written; or its products (4 per K/V element per query head) at the
    bf16 peak."""
    b = len(lengths)
    elem = 1 if quant else 2
    scales = 4 if quant is True else 0
    bytes_ = b * nkv * g * hd * (2 + 4) + 4 * b
    flops = 0
    for n in lengths:
        bytes_ += 2 * nkv * n * (hd * elem + scales)
        bytes_ += 4 * -(-n // ps)
        flops += 4 * nkv * g * hd * n
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def paged_kernel_checks(dev) -> dict:
    """B10 at layer 31 of the full pool, each row's table a random
    permutation of pages 1-1024, rows of KV_LENGTHS, bf16, int8 and fp8
    e4m3 pages: the pool untouched, the context within PAGED_TOL of the
    plain version on the live rows (each with a largest |ctx| of at least
    8 times it), zeros on the length-0 row, the same bits from a second
    call; for fp8 pages a planted fault (kv head 0's context zeroed) that
    must break the tolerance; its row with its bound share, ``ptxas``
    registers and spills and shared bytes a CTA. Timed cycling over the 32
    layers, so that each launch finds its layer's pages out of the L2
    cache, as the decode step does. The yardstick is SDPA over the layer's
    pages gathered and cast to bf16 before the timed window (int8:
    dequantized there)."""
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
    for quant, info in ((False, pc.PAGED), (True, pc.PAGED_INT8),
                        ("fp8", pc.PAGED_FP8)):
        if quant is True:
            def ints():
                return torch.randint(-127, 128, PAGED_SHAPE, generator=gen,
                                     device=dev, dtype=torch.int8)

            def scales():
                return torch.randint(64, 192, PAGED_SHAPE[:-1] + (1,),
                                     generator=gen, device=dev
                                     ).float() / 127.5
            pool = [ints(), scales(), ints(), scales()]
        else:
            page = torch.float8_e4m3fn if quant else torch.bfloat16
            pool = [torch.empty(PAGED_SHAPE, dtype=torch.bfloat16,
                                device=dev).normal_(generator=gen).to(page)
                    for _ in range(2)]
        kw = dict(lengths=lengths, page_indices=tables, quant=quant is True)
        before = [x.clone() for x in pool]
        want = pa.paged_attention_flat_torch(q, *pool, layer=KV_LAYER, **kw)
        got = pa.paged_attention_flat(q, *pool, layer=KV_LAYER, **kw)
        same_bits = torch.equal(got, pa.paged_attention_flat(
            q, *pool, layer=KV_LAYER, **kw))
        torch.cuda.synchronize()
        untouched = all(_same_bits(x, y) for x, y in zip(pool, before))
        del before
        fault = None
        if quant == "fp8":
            remove = _head_fault(pc, "launch", KV_LAYER, 4,
                                 lambda a: a[1][0].shape[2])
            try:
                bad = pa.paged_attention_flat(q, *pool, layer=KV_LAYER, **kw)
            finally:
                remove()
            fault = (bad[live] - want[live]).abs().max().item()
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
        if quant is True:
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
        # the bf16-q instance's mangled name: its page type (int8 'a', fp8
        # '13__nv_fp8_e4m3', or bf16 by substitution '..._'), then HD and G
        page_name = {True: "a", "fp8": "13__nv_fp8_e4m3"}.get(quant, "_")
        resources = {
            "ptxas_regs_spill_stores_loads": _ptxas_of(
                "paged_attention.cu", "15paged_attentionI13__nv_bfloat16",
                page_name + f"Li{hd}ELi1E"),
            "smem_bytes": _smem_bytes(pc, torch.bfloat16,
                                      {True: 1, "fp8": 2}.get(quant, 0),
                                      hd, 1)}
        tol = PAGED_TOL[quant is True]
        ok = (untouched and finite and zero_row and same_bits
              and err <= tol and ctx_scale >= 8 * tol
              and (fault is None or fault > tol))
        emit({"phase": "kernel", "name": info.name, "tol": tol,
              "ok": ok, "pool_untouched": untouched, "ctx_finite": finite,
              "length0_row_zero": zero_row,
              "min_row_max_abs_ctx": ctx_scale, "layer": KV_LAYER,
              "pool_shape": list(PAGED_SHAPE), "page_indices": [b, PAGED_MP],
              "lengths": KV_LENGTHS, "bound_share": bound_ms / ms,
              "same_bits_twice": same_bits, **resources,
              **({"fault": "kv head 0's context zeroed",
                  "fault_max_abs_err": fault} if fault is not None else {}),
              "library_input": "pages gathered and cast to bf16 (int8: "
                               "dequantized) before the timed window",
              **results[info.name]})
        if not ok:
            raise RuntimeError(f"{info.name}: pool untouched {untouched}, "
                               f"finite {finite}, zero row {zero_row}, "
                               f"same bits twice {same_bits}, "
                               f"max_abs_err {err}, smallest row max |ctx| "
                               f"{ctx_scale}, planted fault's error {fault}")
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
    bf16 q, bf16 (also at nkv 8, GQA g 4), fp32, fp8 e4m3 with bf16 q. The
    pools untouched, ctx within FLAT_TOL of the plain version on the live
    rows, zeros on the empty one; for fp8 pools a planted fault (kv head
    0's context zeroed) that must break the tolerance; timed cycling over
    the 32 layers, beside its bound, its plain version and one
    ``scaled_dot_product_attention`` with a boolean mask on the layer's K/V
    (int8: dequantized to bf16; fp8: cast to bf16; GQA: repeated) made
    before the timed window. The ``kernels`` line carries the MHA cases."""
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
                               (kc.DECODE_F32, torch.float32, nh),
                               (kc.DECODE_FP8, torch.bfloat16, nh)):
        g = nh // nkv
        quant = info is kc.DECODE_INT8
        fp8 = info is kc.DECODE_FP8
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
            pool_dtype = torch.float8_e4m3fn if fp8 else q_dtype
            pools = [grid_pool(shape, pool_dtype), None,
                     grid_pool(shape, pool_dtype), None]
        before = [x.clone() for x in pools if x is not None]
        want = ka.kv_attention_decode_torch(q, *pools, lengths, KV_LAYER,
                                            starts=starts)
        got = ka.kv_attention_decode(q, *pools, lengths, KV_LAYER,
                                     starts=starts)
        torch.cuda.synchronize()
        untouched = all(_same_bits(x, y) for x, y in
                        zip([x for x in pools if x is not None], before))
        del before
        fault = None
        if fp8:
            remove = _zero_kv_head_fault(kc, KV_LAYER)
            try:
                bad = ka.kv_attention_decode(q, *pools, lengths, KV_LAYER,
                                             starts=starts)
            finally:
                remove()
            fault = (bad[live].float() - want[live].float()).abs().max(
                ).item()
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
        lib_dtype = torch.bfloat16 if quant or fp8 else q_dtype
        if quant:
            kv = [(pools[i][KV_LAYER].float() * pools[i + 1][KV_LAYER][
                ..., None]).to(lib_dtype) for i in (0, 2)]
        else:
            kv = [pools[i][KV_LAYER].to(lib_dtype) for i in (0, 2)]
        k_lib, v_lib = (x.repeat_interleave(g, dim=2).transpose(1, 2)
                        .contiguous() for x in kv)
        del kv
        q_lib = q.to(lib_dtype)[:, :, None, :]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q_lib, k_lib, v_lib, attn_mask=mask), 32)
        del pools, k_lib, v_lib
        torch.cuda.empty_cache()
        bound_ms, bound_by = _flat_bound(
            nkv, g, hd, 1 if quant or fp8 else q.element_size(), quant,
            q.element_size(), q_dtype == torch.float32)
        line = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
        if nkv == nh:
            results[info.name] = line
        tol = FLAT_TOL[q_dtype]
        ok = (untouched and finite and zero_row and err <= tol
              and ctx_scale >= 8 * KV_TOL_BF16
              and (fault is None or fault > tol))
        emit({"phase": "kernel", "name": info.name, "tol": tol, "ok": ok,
              "pools_untouched": untouched, "ctx_finite": finite,
              "empty_row_zero": zero_row, "min_row_max_abs_ctx": ctx_scale,
              "layer": KV_LAYER, "pool_shape": [n_layers, b, t, nkv, hd],
              "nkv": nkv, "q_dtype": str(q_dtype)[6:],
              "pool_dtype": "float8_e4m3fn" if fp8 else (
                  "int8" if quant else str(q_dtype)[6:]),
              **({"fault": "kv head 0's context zeroed",
                  "fault_max_abs_err": fault} if fault is not None else {}),
              "library_input": "the layer's K/V in bf16 (or q's dtype), "
                               "made before the timed window",
              "lengths": FLAT_LENGTHS, "starts": FLAT_STARTS, **line})
        if not ok:
            raise RuntimeError(f"{info.name} (nkv {nkv}): pools untouched "
                               f"{untouched}, finite {finite}, empty row "
                               f"zero {zero_row}, max_abs_err {err}, "
                               f"smallest row max |ctx| {ctx_scale}, "
                               f"planted fault's error {fault}")
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


# B11's fp32 instance multiplies on the bf16 tensor cores: six products of
# split bf16 parts for S = Q Kᵀ and six for P V (csrc/flash_attention.cu)
FLASH_F32_PRODUCTS = 12


def _flash_bound(b, s, nh, nkv, hd, dtype, cuda_cores=False) -> tuple:
    """Least time for one call: q, k, v read once and the output written
    once, or the products of the causal half, 4 * B * nh * hd * S(S+1)/2
    (two products), at the rate of the arithmetic the kernel runs: for
    bfloat16 the bf16 tensor-core peak; for float32 FLASH_F32_PRODUCTS bf16
    products at that peak, or with ``cuda_cores`` the two fp32 products at
    the CUDA cores' fp32 rate (the first fp32 kernel's basis)."""
    elem = 4 if dtype == torch.float32 else 2
    bytes_ = elem * b * s * hd * (2 * nh + 2 * nkv)
    flops = 4 * b * nh * hd * s * (s + 1) / 2
    peak = BF16_FLOP_PER_S
    if dtype == torch.float32:
        if cuda_cores:
            peak = FP32_FLOP_PER_S
        else:
            flops *= FLASH_F32_PRODUCTS / 2
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def _smem_bytes(binding, *args):
    """The dynamic shared bytes a CTA of a kernel asks for, from its
    binding's ``smem_bytes`` (None for a checkout without one, as
    ``scripts/torch_kernel_ab.py`` may drive)."""
    fn = getattr(binding, "smem_bytes", None)
    return fn(*args) if fn is not None else None


def _ptxas_of(source: str, *parts: str):
    """``ptxas``'s [registers, spill stores, spill loads] of the kernel
    built from ``source`` whose mangled name holds every one of ``parts``,
    from the build's log; None when not found."""
    from onebit_tpu_torch.kernels import build
    path = build.library_path(source)
    log = path.with_name(path.name + ".log")
    if not log.exists():
        return None
    for name, v in ptxas_summary(log.read_text()).items():
        if all(x in name for x in parts):
            return v
    return None


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
            extra = {}
            if dtype == torch.float32:
                extra = {"bound_ms_fp32_cuda_cores": _flash_bound(
                    b, s, nh, nkv, hd, dtype, cuda_cores=True)[0],
                    "ptxas_regs_spill_stores_loads": _ptxas_of(
                        "flash_attention.cu", f"flash_causal_splitILi{hd}E"),
                    "smem_bytes": _smem_bytes(fc, dtype, hd)}
            tol = FLASH_TOL[dtype]
            ok = finite and err <= tol and ctx_scale >= 8 * tol
            emit({"phase": "kernel", "name": info.name, "tol": tol, "ok": ok,
                  "shape": [b, s, nh, hd], "nkv": nkv, "out_finite": finite,
                  "min_row_head_max_abs_ctx": ctx_scale,
                  "bound_share": bound_ms / ms, **extra, **line})
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
# B11-dkv's and B11-dq's fp32 instances multiply on the bf16 tensor cores:
# six products of split bf16 parts for each fp32 product
# (csrc/flash_attention_bwd.cu)
FLASH_BWD_F32_PRODUCTS = 6


def _flash_bwd_bound(b, s, nh, nkv, hd, dtype, kernel: str,
                     cuda_cores=False) -> tuple:
    """Least time for one call of a backward kernel: q, do, k, v, and the
    fp32 lse and di read once, its outputs (dk and dv, or dq) written once;
    or its products of the causal half, 2 * B * nh * hd * S(S+1)/2 flops
    each, at the rate of the arithmetic the kernel runs: B11-dkv forms S,
    dP, dV and dK (4), B11-dq S, dP and dQ (3); the whole backward's five
    cost 2.5 times B11's two. bfloat16 at the bf16 tensor-core peak;
    float32 as FLASH_BWD_F32_PRODUCTS bf16 products at that peak, or with
    ``cuda_cores`` at the CUDA cores' fp32 rate (the first fp32 kernels'
    basis)."""
    elem = 4 if dtype == torch.float32 else 2
    bytes_ = elem * b * s * hd * (2 * nh + 2 * nkv) + 2 * 4 * b * nh * s
    bytes_ += elem * b * s * hd * (2 * nkv if kernel == "dkv" else nh)
    products = 4 if kernel == "dkv" else 3
    flops = products * 2 * b * nh * hd * s * (s + 1) / 2
    peak = BF16_FLOP_PER_S
    if dtype == torch.float32:
        if cuda_cores:
            peak = FP32_FLOP_PER_S
        else:
            flops *= FLASH_BWD_F32_PRODUCTS
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
    entry = f"flash_bwd_{kernel}_{'wgmma' if bf16 else 'split'}ILi{hd}E"
    smem = build.load(source).onebit_flash_bwd_smem_bytes(
        0 if kernel == "dkv" else 1, hd, int(bf16))
    return {"ptxas_regs_spill_stores_loads": _ptxas_of(source, entry),
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
                extra = {}
                if dtype == torch.float32:
                    extra = {
                        "bound_ms_fp32_cuda_cores": _flash_bwd_bound(
                            b, s, nh, nkv, hd, dtype, kernel,
                            cuda_cores=True)[0],
                        "backward_bound_ms_fp32_cuda_cores": _flash_bound(
                            b, s, nh, nkv, hd, dtype,
                            cuda_cores=True)[0] * 2.5}
                emit({"phase": "kernel", "name": info.name, "tol": tol,
                      "ok": ok, "shape": [b, s, nh, hd], "nkv": nkv,
                      "grads_finite": finite,
                      "max_rel_err_per_row_head": dict(zip("qkv", rel)),
                      "min_row_head_max_abs_grad": floor,
                      "backward_ms": ms_dkv + ms_dq + ms_di, "di_ms": ms_di,
                      "backward_bound_ms": _flash_bound(
                          b, s, nh, nkv, hd, dtype)[0] * 2.5,
                      "bound_share": bound_ms / ms, **extra,
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
        k.launches = k.graph_launches = 0


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
    that must launch once per layer of every decode step, or None. Returns
    the launches and each request's tokens."""
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
    return launches, got, line


BLOCK_STEPS = 8       # decode steps a block (one CUDA graph) in block runs


def _serve_blocks(eng, prompts, new_tokens, profile=False):
    """Serve ``prompts`` through ``eng`` (decode blocks on CUDA graphs),
    an engine iteration at a time. Each replay is timed on the device by
    CUDA events around it; each iteration that replays a block and admits
    nothing by the host clock, whole (wall ms) and with the time it waits
    for the block before taken out (host ms). With ``profile``, the first
    such iteration whose block chains from one in flight runs alone (the
    device idle before it) under ``torch.profiler``, and is left out of
    the timings; the profiler also counts the port's kernels it ran.
    Returns the requests' tokens and the timings."""
    from onebit_tpu_torch.engine.block_graph import BlockOut
    graph = eng._graph
    waits, events = [], []
    real_fetch, real_replay = BlockOut.fetch, graph.graph.replay

    def timed_fetch(out):
        t = time.perf_counter()
        got = real_fetch(out)
        waits.append(time.perf_counter() - t)
        return got

    def timed_replay():
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        real_replay()
        pair[1].record()
        events.append(pair)

    BlockOut.fetch = timed_fetch
    graph.graph.replay = timed_replay
    iters, walls, profiled, t_decode = [], [], None, None
    try:
        uids = [eng.add_request(p, max_new_tokens=new_tokens)
                for p in prompts]
        while eng.has_work():
            t, n_wait, replays = time.perf_counter(), len(waits), \
                graph.replays
            admitting = bool(eng.waiting)
            eng._admit()
            if profile and profiled is None and not admitting \
                    and eng._pending is not None:
                torch.cuda.synchronize()
                before = graph.replays
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    eng._decode()
                    torch.cuda.synchronize()
                device_ms, top = _device_ms(prof)
                replay_ms = events[-1][0].elapsed_time(events[-1][1])
                profiled = {"replay_ms": replay_ms, "kernel_ms": device_ms,
                            "busy_share": device_ms / replay_ms,
                            "replays": graph.replays - before,
                            "port_kernels": _port_kernel_count(prof),
                            "kernel_ms_per_step": [
                                dict(k, ms=k["ms"] / BLOCK_STEPS)
                                for k in top]}
                events.pop()
                continue
            if t_decode is None and not eng.waiting:
                # after the last admission: the decode phase
                t_decode, tokens0 = time.perf_counter(), eng.total_tokens
            eng._decode()
            if graph.replays > replays and not admitting:
                wall = time.perf_counter() - t
                walls.append(wall)
                iters.append(wall - sum(waits[n_wait:]))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t_decode
    finally:
        BlockOut.fetch = real_fetch
        graph.graph.replay = real_replay
    return [eng.finished[u].generated for u in uids], {
        "replay_ms": [a.elapsed_time(b) for a, b in events],
        "host_ms": [h * 1e3 for h in iters],
        "wall_ms": [w * 1e3 for w in walls], "decode_s": decode_s,
        "decode_tokens": eng.total_tokens - tokens0,
        "profiled_block": profiled}


def block_run(params, config, dev, prompts, new_tokens, opts, per_step,
              want) -> dict:
    """The served run's prompts again through an engine with
    ``block_steps=8, pipeline_blocks=True``: each block one captured CUDA
    graph, replayed (captured in ``warmup``, before the counts are set to
    0). Its tokens must be the eager run's ``want``, token for token; the
    per-step kernel must launch exactly L times a step the replays ran
    (8 a replay), K1 and K2 inside the graph; pages come back, and the
    prefix run reuses 448. Timed by :func:`_serve_blocks`: ms per
    token-step is the median wall of an engine iteration that replays a
    block over 8 (``wall_ms_per_token_step``; pipelined, it waits for the
    block before) and a replay's device time over 8
    (``device_ms_per_token_step``); decode tok/s the tokens emitted after
    the last admission over the wall from then to the last token. Then
    the same requests again, one block of them profiled: its kernels'
    device time over its replay's is the busy share, and the profiler's
    count of the port's kernels must be what the capture recorded a
    replay (``graph_launches`` is that record times the replays). Returns
    each kernel's launches, and those from the graph."""
    eng = _engine(params, config, dev, dict(opts, block_steps=BLOCK_STEPS,
                                            pipeline_blocks=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    graph = eng._graph
    reset_counts()
    t_start = time.perf_counter()
    got, timing = _serve_blocks(eng, prompts, new_tokens)
    wall = time.perf_counter() - t_start
    launches = read_counts()
    graph_launches = {k.name: k.graph_launches for k in all_kernels()}
    m = eng.metrics()
    layers = config.num_hidden_layers
    replays, steps = graph.replays, graph.replays * BLOCK_STEPS
    _, again = _serve_blocks(eng, prompts, new_tokens, profile=True)
    block_ms = float(np.median(timing["replay_ms"]))
    line = {"phase": "serve_blocks", **opts, "block_steps": BLOCK_STEPS,
            "pipeline_blocks": True, "requests": len(prompts),
            "new_tokens": new_tokens, "replays": replays,
            "block_steps_run": steps, "warmup_s": warmup_s,
            "capture_s": graph.capture_s,
            "instantiate_s": graph.instantiate_s,
            "graph_pool_bytes": graph.pool_bytes,
            "replay_ms": timing["replay_ms"],
            "wall_ms_per_token_step": (
                float(np.median(timing["wall_ms"])) / BLOCK_STEPS
                if timing["wall_ms"] else None),
            "device_ms_per_token_step": block_ms / BLOCK_STEPS,
            "host_ms_per_block": (float(np.median(timing["host_ms"]))
                                  if timing["host_ms"] else None),
            "host_ms_per_block_all": timing["host_ms"],
            "decode_s": timing["decode_s"],
            "decode_tokens": timing["decode_tokens"],
            "decode_tok_per_s": timing["decode_tokens"] / timing["decode_s"],
            "decode_tok_per_s_replay": len(prompts) * 1e3 / (
                block_ms / BLOCK_STEPS),
            "profiled_block": again["profiled_block"],
            "wall_s": wall, "tokens_equal_eager": got == want,
            "launches": {k: v for k, v in launches.items() if v},
            "graph_launches": {k: v for k, v in graph_launches.items()
                               if v}}
    line.update({k: m[k] for k in ("free_pages", "total_pages",
                                   "prefix_cache_entries",
                                   "prefix_pages_reused") if k in m})
    emit(line)
    if not line["tokens_equal_eager"]:
        raise RuntimeError(f"block run tokens differ from the eager run's: "
                           f"{[g == w for g, w in zip(got, want)]}")
    if launches[per_step.name] != layers * steps or steps == 0 or \
            graph_launches[per_step.name] != launches[per_step.name]:
        raise RuntimeError(f"{per_step.name} launched "
                           f"{launches[per_step.name]} times "
                           f"({graph_launches[per_step.name]} in graphs), "
                           f"not {layers * steps} (L a replayed step)")
    seen = again["profiled_block"]
    recorded = sum(graph.per_replay.values())
    if seen is None or seen["port_kernels"] != seen["replays"] * recorded \
            or seen["replays"] != 1:
        raise RuntimeError(f"the profiled block: {seen}; not one replay "
                           f"of the {recorded} kernels the capture "
                           f"recorded")
    k1k2 = [k.name for k in all_kernels()[:2]]
    if not all(graph_launches[n] > 0 for n in k1k2):
        raise RuntimeError(f"K1/K2 not launched inside the graph: "
                           f"{graph_launches}")
    if eng.paged and m["free_pages"] != m["total_pages"] - m.get(
            "prefix_cache_entries", 0):
        raise RuntimeError(f"pages not returned: {m}")
    if opts.get("prefix_cache") and m["prefix_pages_reused"] != 7 * 64:
        raise RuntimeError(f"prefix pages reused "
                           f"{m['prefix_pages_reused']}, not 448")
    del eng, graph
    torch.cuda.empty_cache()
    return launches, graph_launches


def block_fault_check(params, config, dev, prompts, new_tokens,
                      want) -> None:
    """A dense block captured with :func:`_zero_kv_head_fault` installed
    (kv head 0 of B9 zeroed in layer 0): the graph keeps the fault after
    the wrapper is restored, and its tokens must differ from the eager
    run's ``want``, which shows that the comparison reads the graph's
    output."""
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    eng = _engine(params, config, dev, dict(max_len=256,
                                            block_steps=BLOCK_STEPS,
                                            pipeline_blocks=True))
    remove = _zero_kv_head_fault(kc)
    try:
        eng.warmup()
    finally:
        remove()
    uids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    out = eng.run()
    got = [out[u] for u in uids]
    line = {"phase": "serve_blocks_fault",
            "fault": "kv head 0 of B9 zeroed in layer 0, captured",
            "replays": eng._graph.replays,
            "rows_differing": sum(g != w for g, w in zip(got, want))}
    emit(line)
    if line["rows_differing"] == 0:
        raise RuntimeError(f"the planted fault in the captured block left "
                           f"every token equal: {line}")
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4, continued: the serving surface at llama2-7b width and depth
# (dense chunked prefill, speculative decoding, beam search)
# ---------------------------------------------------------------------------

SURFACE_NEW = 32          # new tokens a request, as the served runs
# (name, engine options, chunk size, prompts): 64-token chunks run K1/K2
# (M = 64), 256-token chunks K3 bf16 (M = 256)
CHUNK_RUNS = (("dense", dict(max_len=256), 64, smoke_prompts),
              ("int8", dict(max_len=2048, quantized_kv=True), 256,
               deep_prompts))
# the draft: build_draft's spread slice (layers 0 and 31), 4 proposals a
# round; the targets of the served runs
SPEC_DRAFT_LAYERS, SPEC_N_DRAFT = 2, 4
SPEC_RUNS = (("dense", dict(max_len=256), smoke_prompts),
             ("int8", dict(max_len=2048, quantized_kv=True), deep_prompts),
             ("paged", dict(max_len=2048, paged=True, page_size=16),
              deep_prompts))
SPEC_TEMPERATURE = 0.9
BEAM_K, BEAM_NEW = 4, 16
# a beam's score (its mean log-probability) on the kernel path against
# impl="torch": each log-probability moves with the logits, whose bf16
# error is held to LOGITS_REL_TOL of their largest |logit|. Two searches
# part where two hypotheses' scores lie that close: the near-tie rule of
# a beam is that the kernel path's best, scored by impl="torch", is
# within this of impl="torch"'s best
BEAM_SCORE_REL_TOL = LOGITS_REL_TOL
SURFACE_CLI_NEW = 16


def _drive(eng, prompts, new_tokens) -> tuple:
    """Serve ``prompts`` through ``eng`` an iteration at a time: its
    tokens, and of its decode calls (steps or speculative rounds) the
    count, the wall seconds (each call ends in the device's read of its
    tokens), the tokens they emitted and the launches they made."""
    uids = [eng.add_request(p, max_new_tokens=n)
            for p, n in zip(prompts, new_tokens)]
    calls, wall, emitted = 0, 0.0, 0
    launched = {k.name: 0 for k in all_kernels()}
    while eng.has_work():
        eng._admit()
        if not any(s is not None for s in eng.slots):
            continue
        torch.cuda.synchronize()
        before = {k.name: k.launches for k in all_kernels()}
        tokens0, t = eng.total_tokens, time.perf_counter()
        eng._decode()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t
        calls += 1
        emitted += eng.total_tokens - tokens0
        for k in all_kernels():
            launched[k.name] += k.launches - before[k.name]
    out = eng.run()
    return [out[u] for u in uids], {
        "calls": calls, "wall_s": wall, "emitted": emitted,
        "launches": {k: v for k, v in launched.items() if v}}


def _partings(params, config, dev, prompts, got, want) -> dict:
    """Where each request's tokens part from ``want``'s (a plain run's),
    with the plain path's top-2 gap there (:func:`_divergence_gap`):
    {row: {"step", "gap"}}. A parting is allowed only at a near-tie, a gap
    under LOGITS_REL_TOL."""
    parted = {}
    for r, (g, w) in enumerate(zip(got, want)):
        step = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                    None)
        if step is not None:
            parted[r] = {"step": step, "gap": _divergence_gap(
                params, config, dev, prompts[r], w, step)}
        elif len(g) != len(w):
            parted[r] = {"step": min(len(g), len(w)), "gap": float("inf")}
    return parted


def _parted_badly(parted) -> bool:
    return any(v["gap"] > LOGITS_REL_TOL for v in parted.values())


def _first_chunk_check(params, config, dev, opts, chunk, prompt) -> dict:
    """The first chunk of ``prompt`` through ``chunk_append_row`` on an
    empty one-row cache of the run's kind, impl="auto" (K1/K2 or K3)
    against impl="torch": logits within LOGITS_REL_TOL of the largest
    |logit|."""
    from onebit_tpu_torch.model.bitllama import init_kv_cache
    from onebit_tpu_torch.model.kv_cache import init_quant_kv_cache_kt
    from onebit_tpu_torch.model.ragged_decode import chunk_append_row
    init = (init_quant_kv_cache_kt if opts.get("quantized_kv")
            else init_kv_cache)
    ids = np.zeros(chunk, np.int64)
    n = min(chunk, len(prompt))
    ids[:n] = prompt[:n]
    out = {}
    for impl in ("auto", "torch"):
        cache = init(config, 1, opts["max_len"], device=dev)
        out[impl], _ = chunk_append_row(params, cache, ids, 0, n, 0, config,
                                        impl=impl)
        del cache
    scale = out["torch"].abs().max().item()
    err = (out["auto"] - out["torch"]).abs().max().item()
    return {"max_abs_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "rel_tol": LOGITS_REL_TOL,
            "finite": bool(torch.isfinite(out["auto"]).all())}


def _chunked_run(params, config, dev, card, name, opts, chunk, prompts,
                 want) -> None:
    """The run's prompts through an engine with ``prefill_chunk_size``
    and no pages, every count set to 0 just before it: tokens equal to the
    bucketed run's ``want`` off near-ties, the per-step kernel (B9 or B5)
    exactly 32 times a decode step, and the chunks through K1/K2 (64) or
    K3 (256) only."""
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    first = _first_chunk_check(params, config, dev, opts, chunk, prompts[0])
    eng = _engine(params, config, dev, dict(opts, prefill_chunk_size=chunk))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got, dec = _drive(eng, prompts, [SURFACE_NEW] * len(prompts))
    wall = time.perf_counter() - t0
    launches = read_counts()
    del eng
    torch.cuda.empty_cache()
    parted = _partings(params, config, dev, prompts, got, want)
    per_step = kc.APPEND_KT if opts.get("quantized_kv") else kc.DECODE_BF16
    chunks = sum(-(-len(p) // chunk) for p in prompts)
    large = chunk > bc.SMALL_M_MAX
    line = {"phase": "serve_surface", "part": "chunked_prefill",
            "cache": name, **opts, "prefill_chunk_size": chunk,
            "requests": len(prompts), "chunks": chunks,
            "new_tokens": SURFACE_NEW, "decode_steps": dec["calls"],
            "wall_s": wall, "first_chunk_logits": first,
            "tokens_equal_bucketed": got == want,
            "parted_from_bucketed": {str(r): v for r, v in parted.items()},
            "gap_rel_tol": LOGITS_REL_TOL,
            "launches": {k: v for k, v in launches.items() if v},
            "card": card}
    emit(line)
    want_step = config.num_hidden_layers * dec["calls"]
    chunk_kernels = [bc.LARGE_M] if large else [bc.SMALL_M,
                                                 bc.FUSED_SMALL_M]
    if not first["finite"] or first["rel_err"] > LOGITS_REL_TOL or \
            _parted_badly(parted) or \
            launches[per_step.name] != want_step or \
            not all(launches[k.name] for k in chunk_kernels) or \
            (not large and launches[bc.LARGE_M.name]):
        raise RuntimeError(f"chunked prefill ({name}): {line}")


def _spec_per_round(config, d_config) -> dict:
    """The launches of one greedy round: n_draft + 1 draft steps of the
    draft's layers (each layer K2 twice, fused q/k/v and gate/up, K1
    twice, o and down, B9 once), then the target's window (K1 and K2
    twice a layer at M = 8 x 5)."""
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    steps = (SPEC_N_DRAFT + 1) * d_config.num_hidden_layers
    proj = 2 * steps + 2 * config.num_hidden_layers
    return {bc.SMALL_M.name: proj, bc.FUSED_SMALL_M.name: proj,
            kc.DECODE_BF16.name: steps}


def _spec_run(params, draft, config, dev, card, name, opts, prompts, want,
              plain_ms_per_token) -> None:
    """The run's prompts through a greedy engine with the draft, every
    count set to 0 just before it: tokens equal to the plain engine's
    ``want`` off near-ties; each round's launches exactly
    :func:`_spec_per_round` (no other kernel in a round); rounds, tokens a
    round and wall ms per emitted token beside the plain engine's."""
    d_config, d_params = draft
    eng = _engine(params, config, dev, dict(
        opts, draft_params=d_params, draft_config=d_config,
        n_draft=SPEC_N_DRAFT))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got, dec = _drive(eng, prompts, [SURFACE_NEW] * len(prompts))
    wall = time.perf_counter() - t0
    launches = read_counts()
    m = eng.metrics()
    del eng
    torch.cuda.empty_cache()
    parted = _partings(params, config, dev, prompts, got, want)
    rounds = dec["calls"]
    per_round = _spec_per_round(config, d_config)
    want_round = {k: v * rounds for k, v in per_round.items()}
    line = {"phase": "serve_surface", "part": "speculative", "target": name,
            **opts, "draft_layers": d_config.num_hidden_layers,
            "n_draft": SPEC_N_DRAFT, "requests": len(prompts),
            "new_tokens": SURFACE_NEW, "rounds": rounds,
            "round_tokens": dec["emitted"],
            "tokens_per_round": dec["emitted"] / rounds,
            "tokens_per_row_round": dec["emitted"] / rounds / len(prompts),
            "wall_ms_per_token": dec["wall_s"] * 1e3 / dec["emitted"],
            "plain_wall_ms_per_token": plain_ms_per_token,
            "wall_s": wall, "tokens_equal_plain": got == want,
            "parted_from_plain": {str(r): v for r, v in parted.items()},
            "gap_rel_tol": LOGITS_REL_TOL,
            "launches_per_round": per_round,
            "round_launches": dec["launches"],
            "launches": {k: v for k, v in launches.items() if v},
            "card": card}
    line.update({k: m[k] for k in ("free_pages", "total_pages") if k in m})
    emit(line)
    if _parted_badly(parted) or dec["launches"] != want_round or \
            m.get("free_pages") != m.get("total_pages"):
        raise RuntimeError(f"speculative decoding ({name}): {line}")


def _spec_edges(params, draft, config, dev, card) -> None:
    """A request that fills max_len exactly (224 + 32 = 256 on the dense
    target; its last rounds propose past the cache, whose writes are
    dropped), against the plain engine; then a sampled engine
    (temperature 0.9) over the dense run's prompts, whose rows end at
    their budget or at EOS."""
    from onebit_tpu_torch import SamplingConfig
    d_config, d_params = draft
    spec = dict(draft_params=d_params, draft_config=d_config,
                n_draft=SPEC_N_DRAFT)
    prompt = np.random.default_rng(5).integers(3, 32000, 256 - SURFACE_NEW
                                               ).tolist()
    want, _ = _drive(_engine(params, config, dev, dict(max_len=256)),
                     [prompt], [SURFACE_NEW])
    reset_counts()
    got, dec = _drive(_engine(params, config, dev, dict(max_len=256, **spec)),
                      [prompt], [SURFACE_NEW])
    full = read_counts()
    parted = _partings(params, config, dev, [prompt], got, want)
    prompts = smoke_prompts()
    reset_counts()
    sampled, sdec = _drive(_engine(params, config, dev, dict(
        max_len=256, sampling=SamplingConfig(temperature=SPEC_TEMPERATURE),
        seed=3, **spec)), prompts, [SURFACE_NEW] * len(prompts))
    s_launch = read_counts()
    eos = config.eos_token_id
    ended = [0 < len(t) and eos not in t[:-1]
             and (len(t) == SURFACE_NEW or t[-1] == eos) for t in sampled]
    line = {"phase": "serve_surface", "part": "speculative_edges",
            "full_row": {"prompt": len(prompt), "new_tokens": SURFACE_NEW,
                         "max_len": 256, "rounds": dec["calls"],
                         "tokens": len(got[0]),
                         "tokens_equal_plain": got == want,
                         "parted_from_plain": {str(r): v for r, v in
                                               parted.items()},
                         "launches": {k: v for k, v in full.items() if v}},
            "sampled": {"temperature": SPEC_TEMPERATURE,
                        "requests": len(prompts), "rounds": sdec["calls"],
                        "tokens_per_round": sdec["emitted"] / sdec["calls"],
                        "lengths": [len(t) for t in sampled],
                        "ended_at_budget_or_eos": ended,
                        "launches": {k: v for k, v in s_launch.items()
                                     if v}},
            "card": card}
    emit(line)
    if _parted_badly(parted) or len(got[0]) != SURFACE_NEW or \
            not all(ended) or not all(0 <= t < config.vocab_size
                                      for r in sampled for t in r):
        raise RuntimeError(f"speculative edges: {line}")
    torch.cuda.empty_cache()


def _plain_score(params, config, dev, prompt, seq) -> float:
    """The mean log-probability of ``seq`` after ``prompt`` on the plain
    path (a bf16 forward with impl="torch"): a beam's score at length
    penalty 1."""
    from onebit_tpu_torch.model.bitllama import forward
    ids = torch.tensor(prompt + seq, device=dev)[None]
    logits = forward(params, ids, config, impl="torch")[0].float()
    logp = torch.log_softmax(logits[len(prompt) - 1:-1], dim=-1)
    return logp.gather(1, ids[0, len(prompt):, None]).mean().item()


def _beam_check(params, config, dev, card) -> None:
    """``beam_generate`` of two short prompts, 4 beams, 16 new tokens,
    every count set to 0 just before it: B9 exactly 32 x 15 times, K1 and
    K2 launched; against impl="torch", each prompt's best sequence and
    its score. Where the two bests part, the kernel path's best, scored
    by the plain path (:func:`_plain_score`), must be within
    BEAM_SCORE_REL_TOL of the plain best's score: the two searches parted
    at a near-tie of hypotheses. Where they are equal, the kernel path's
    score must be within BEAM_SCORE_REL_TOL of the plain one."""
    from onebit_tpu_torch import beam_generate
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    prompts = smoke_prompts()[4:6]
    kw = dict(num_beams=BEAM_K, max_new_tokens=BEAM_NEW,
              num_return_sequences=BEAM_K)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = beam_generate(params, config, prompts, **kw)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    plain = beam_generate(params, config, prompts, impl="torch", **kw)
    best, want = [r[0][0] for r in got], [r[0][0] for r in plain]
    parted = {}
    for r, (g, w) in enumerate(zip(best, want)):
        if g != w:
            rescored = _plain_score(params, config, dev, prompts[r], g)
            parted[r] = {"step": next(i for i, (a, b) in enumerate(zip(g, w))
                                      if a != b),
                         "plain_score_of_best": rescored,
                         "plain_best_score": plain[r][0][1],
                         "gap": abs(rescored - plain[r][0][1])
                         / abs(plain[r][0][1])}
    score_err = [abs(g[0][1] - p[0][1]) / abs(p[0][1])
                 for r, (g, p) in enumerate(zip(got, plain))
                 if r not in parted]
    steps = config.num_hidden_layers * (BEAM_NEW - 1)
    line = {"phase": "serve_surface", "part": "beam", "prompts": len(prompts),
            "prompt_lengths": [len(p) for p in prompts], "num_beams": BEAM_K,
            "new_tokens": BEAM_NEW, "seconds": seconds,
            "best_equal_plain": best == want,
            "sequences_equal_plain": [[s for s, _ in r] for r in got] ==
            [[s for s, _ in r] for r in plain],
            "parted_from_plain": {str(r): v for r, v in parted.items()},
            "parting_rel_tol": BEAM_SCORE_REL_TOL,
            "scores": [[x for _, x in r] for r in got],
            "plain_scores": [[x for _, x in r] for r in plain],
            "best_score_rel_err": score_err,
            "score_rel_tol": BEAM_SCORE_REL_TOL,
            "launches": {k: v for k, v in launches.items() if v},
            "card": card}
    emit(line)
    if any(v["gap"] > BEAM_SCORE_REL_TOL for v in parted.values()) or \
            any(e > BEAM_SCORE_REL_TOL for e in score_err) or \
            launches[kc.DECODE_BF16.name] != steps or \
            not launches[bc.SMALL_M.name] or \
            not launches[bc.FUSED_SMALL_M.name]:
        raise RuntimeError(f"beam search: {line}")


def serve_surface_checks(params, config, dev, served=None) -> None:
    """Phase ``serve_surface`` at full llama2-7b width and depth on the
    serving runs' fused weights and prompts, 8-slot greedy engines:
    dense chunked prefill (:func:`_chunked_run`), speculative decoding
    with a 2-layer spread draft on dense, int8 KT and paged targets
    (:func:`_spec_run`), a full row and a sampled engine
    (:func:`_spec_edges`), and beam search (:func:`_beam_check`).
    ``served``: the served runs' ``(tokens, line)`` by cache name (dense,
    int8, paged); a missing one is run here. Each run prints its launches
    on its line."""
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    from onebit_tpu_torch.kernels import paged_attention_cuda as pc
    from onebit_tpu_torch.train.draft import build_draft
    served = dict(served or {})
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    per_step = {"dense": kc.DECODE_BF16, "int8": kc.APPEND_KT,
                "paged": pc.PAGED}
    for name, opts, prompts in SPEC_RUNS:
        if name not in served:
            _, tokens, line = served_run(params, config, dev, prompts(),
                                         SURFACE_NEW, opts, per_step[name])
            served[name] = tokens, line
    for name, opts, chunk, prompts in CHUNK_RUNS:
        _chunked_run(params, config, dev, card, name, opts, chunk, prompts(),
                     served[name][0])
    draft = build_draft(params, config, SPEC_DRAFT_LAYERS)
    for name, opts, prompts in SPEC_RUNS:
        tokens, line = served[name]
        _spec_run(params, draft, config, dev, card, name, opts, prompts(),
                  tokens, line["decode_ms_per_step_median"] / len(tokens))
    _spec_edges(params, draft, config, dev, card)
    del draft
    _beam_check(params, config, dev, card)
    emit({"phase": "serve_surface", "part": "done",
          "seconds": time.perf_counter() - t0, "card": card})


def start_cli(*args, stdin=None) -> tuple:
    """Start ``python -m onebit_tpu_torch ARGS`` in a process of its own,
    its standard input (``stdin``) written and closed at once, so that
    several commands run together; :func:`finish_cli` collects it."""
    proc = subprocess.Popen([sys.executable, "-m", "onebit_tpu_torch", *args],
                            cwd=ROOT, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    proc.stdin.write(stdin or "")
    proc.stdin.close()
    proc.stdin = None           # communicate() must not flush it again
    return proc, time.perf_counter(), args[0]


def finish_cli(seconds: dict, started: tuple, name=None) -> list:
    """A started command's stdout lines; its wall seconds go to
    ``seconds`` under ``name`` (the command's by default). A failed
    command raises with the ends of its output."""
    proc, t, command = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        _end([started])
    seconds[name or command] = time.perf_counter() - t
    if proc.returncode != 0:
        raise RuntimeError(f"{command} failed:\n{out[-2000:]}\n"
                           f"{err[-3000:]}")
    return out.strip().splitlines()


def _end(started) -> None:
    """Kill the started commands still running (after a failure)."""
    for proc, _, _ in started:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_cli(seconds: dict, *args, stdin=None, name=None) -> list:
    """``python -m onebit_tpu_torch ARGS`` in a process of its own, to its
    end: :func:`finish_cli` of :func:`start_cli`."""
    return finish_cli(seconds, start_cli(*args, stdin=stdin), name)


def _free_port() -> int:
    """A TCP port free on this host now (the multi-host launches' store)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def small_ckpt(dev) -> str:
    """The 2-layer native checkpoint of 7B width under ``build/smoke_ckpt``
    (random packed weights of seed 1), which :func:`eval_checks` writes;
    written here when it is not there."""
    from onebit_tpu_torch import (BitLlamaConfig, host_random_packed_params,
                                  save_native)
    ckpt = os.path.join(ROOT, "build", "smoke_ckpt")
    if not os.path.exists(os.path.join(ckpt, "params.npz")):
        small = BitLlamaConfig.named("llama2-7b", num_hidden_layers=2)
        save_native(ckpt, small, host_random_packed_params(small, seed=1,
                                                           device=dev))
    return ckpt


def serve_surface_cli(dev) -> None:
    """The serving surface's command lines on :func:`small_ckpt`:
    ``build-draft --num-layers 1`` (its checkpoint holds ``build_draft``'s
    slice), ``serve --draft --n-draft 3`` over stdin lines of ids (the
    tokens of the engine with that draft in this process, which are the
    plain engine's off near-ties) and ``generate --num-beams 2`` (the best
    beam of ``beam_generate`` in this process); then ``serve --tp 2
    --tp-backend gloo`` (two ranks sharing the card behind rank 0): with
    the draft on stdin lines (the single-device ``serve --draft``'s tokens
    off near-ties), and ``--http 0`` with one POST /generate (the tokens of
    an engine serving that prompt alone in this process, off near-ties),
    stopped by SIGINT with exit code 0; and ``serve --tp 2`` as the two
    processes of a multi-host launch (``--coordinator 127.0.0.1:PORT
    --num-processes 2 --process-id i``, rank 0 on stdin, rank 1 printing
    nothing): the single-device engine's tokens off near-ties. After
    ``build-draft`` the commands run together, ``serve --tp --http``
    driven while the others run, so their seconds overlap. The draft is
    removed after."""
    import shutil

    from onebit_tpu_torch import (ContinuousBatchingEngine, SamplingConfig,
                                  beam_generate, load_native)
    from onebit_tpu_torch.train.draft import build_draft
    ckpt = small_ckpt(dev)
    out = os.path.join(ROOT, "build", "smoke_draft")
    seconds = {}
    flags = ("--max-batch", "2", "--max-len", "256", "--max-new-tokens",
             str(SURFACE_CLI_NEW), "--greedy")
    lines = "\n".join(",".join(map(str, p)) for p in SERVE_PROMPTS) + "\n"
    tp = ("--tp", "2", "--tp-backend", "gloo")
    started = []
    try:
        run_cli(seconds, "build-draft", ckpt, out, "--num-layers", "1")
        # the other commands together (their seconds overlap): serve
        # --draft, generate --num-beams, serve --tp with the draft, while
        # this process drives serve --tp --http
        started = [
            start_cli("serve", "--ckpt", ckpt, "--draft", out, "--n-draft",
                      "3", *flags, stdin=lines),
            start_cli("generate", "--ckpt", ckpt, "--prompt", "1,2,3",
                      "--num-beams", "2", "--max-new-tokens",
                      str(SURFACE_CLI_NEW)),
            start_cli("serve", "--ckpt", ckpt, "--draft", out, "--n-draft",
                      "3", *flags, *tp, stdin=lines)]
        # (the parallel phase's f) serve --tp 2 as two processes of a
        # multi-host launch, rank 0 on stdin
        coordinator = f"127.0.0.1:{_free_port()}"
        started += [
            start_cli("serve", "--ckpt", ckpt, *flags, *tp, "--coordinator",
                      coordinator, "--num-processes", "2", "--process-id",
                      str(i), stdin=lines if i == 0 else "")
            for i in range(2)]
        t = time.perf_counter()
        http_tp = _serve_http(ckpt, SERVE_PROMPTS[1], (*flags, *tp),
                              SURFACE_CLI_NEW)
        seconds["serve --tp --http"] = time.perf_counter() - t

        def completions(got):
            return [[int(x) for x in json.loads(ln)["completion"].split(",")]
                    for ln in got if ln.startswith("{")]
        served = completions(finish_cli(seconds, started[0]))
        beams = finish_cli(seconds, started[1])[-1]
        served_tp = completions(finish_cli(seconds, started[2],
                                           "serve --tp"))
        multi_host = completions(finish_cli(
            seconds, started[3], "serve --tp --coordinator (rank 0)"))
        multi_host_rank1 = finish_cli(
            seconds, started[4], "serve --tp --coordinator (rank 1)")
        loaded, draft = load_native(ckpt, device=dev), load_native(out,
                                                                   device=dev)
        config = loaded["config"]
        d_config, d_params = build_draft(loaded["params"], config, 1)
        same_draft = draft["config"] == d_config and all(
            torch.equal(a, b) for a, b in zip(
                _tensors(draft["params"]), _tensors(d_params)))
        want = {}
        for name, spec in (("spec", dict(draft_params=draft["params"],
                                         draft_config=draft["config"],
                                         n_draft=3)), ("plain", {})):
            eng = ContinuousBatchingEngine(
                loaded["params"], config, max_batch=2, max_len=256,
                sampling=SamplingConfig(greedy=True), device=dev, **spec)
            uids = [eng.add_request(p, max_new_tokens=SURFACE_CLI_NEW)
                    for p in SERVE_PROMPTS]
            res = eng.run()
            want[name] = [res[u] for u in uids]
        parted = _partings(loaded["params"], config, dev, SERVE_PROMPTS,
                           want["spec"], want["plain"])
        parted_tp = _partings(loaded["params"], config, dev, SERVE_PROMPTS,
                              served_tp, served)
        parted_mh = _partings(loaded["params"], config, dev, SERVE_PROMPTS,
                              multi_host, want["plain"])
        eng = ContinuousBatchingEngine(
            loaded["params"], config, max_batch=2, max_len=256,
            sampling=SamplingConfig(greedy=True), device=dev)
        uid = eng.add_request(SERVE_PROMPTS[1],
                              max_new_tokens=SURFACE_CLI_NEW)
        http_want = eng.run()[uid]
        del eng
        parted_http = _partings(loaded["params"], config, dev,
                                SERVE_PROMPTS[1:2], [http_tp["tokens"]],
                                [http_want])
        beam_want = beam_generate(loaded["params"], config, [[1, 2, 3]],
                                  num_beams=2,
                                  max_new_tokens=SURFACE_CLI_NEW)[0][0][0]
        line = {"phase": "serve_surface", "part": "cli", "ckpt_layers": 2,
                "draft_layers": draft["config"].num_hidden_layers,
                "draft_is_build_draft": same_draft,
                "serve_draft": served, "serve_in_process": want["spec"],
                "in_process_plain": want["plain"],
                "spec_parted_from_plain": {str(r): v
                                           for r, v in parted.items()},
                "generate_beams": beams,
                "beam_in_process": ",".join(map(str, beam_want)),
                "serve_tp_draft": served_tp,
                "serve_tp_parted_from_serve_draft": {
                    str(r): v for r, v in parted_tp.items()},
                "serve_tp_http_tokens": http_tp["tokens"],
                "serve_tp_http_in_process": http_want,
                "serve_tp_http_parted": {str(r): v for r, v in
                                         parted_http.items()},
                "serve_tp_http_request_s": http_tp["request_s"],
                "serve_tp_http_exit_code": http_tp["exit_code"],
                "serve_tp_http_metrics": http_tp["metrics"],
                "serve_tp_multi_host": multi_host,
                "serve_tp_multi_host_equals_single_device":
                    multi_host == want["plain"],
                "serve_tp_multi_host_parted": {str(r): v for r, v in
                                               parted_mh.items()},
                "serve_tp_multi_host_rank1_lines": len(multi_host_rank1),
                "seconds": seconds}
        emit(line)
        if not same_draft or served != want["spec"] or \
                _parted_badly(parted) or beams != line["beam_in_process"] \
                or _parted_badly(parted_tp) or _parted_badly(parted_http) \
                or len(served_tp) != len(SERVE_PROMPTS) \
                or http_tp["exit_code"] != 0 \
                or http_tp["metrics"]["completed_requests"] != 1 \
                or len(multi_host) != len(SERVE_PROMPTS) \
                or _parted_badly(parted_mh) or multi_host_rank1:
            raise RuntimeError(f"build-draft, serve --draft, generate "
                               f"--num-beams, serve --tp: {line}")
    finally:
        _end(started)
        shutil.rmtree(out, ignore_errors=True)


def _tensors(params) -> list:
    """Every tensor of a params tree, in a fixed order."""
    out = [params[k] for k in ("embed_tokens", "lm_head", "final_norm")]
    for name in sorted(params["layers"]):
        w = params["layers"][name]
        out += [a for a in w if a is not None] if isinstance(w, tuple) \
            else [w]
    return out


# ---------------------------------------------------------------------------
# phase 4, continued: batch generation at llama2-7b width and depth
# ---------------------------------------------------------------------------

GEN_NEW = 32          # new tokens of the bf16 run: 31 decode steps
GEN_NEW_F32 = 8       # and of the fp32 run
FLAT_STEPS = 8        # one-token steps on the flat int8 cache


def _head_fault(module, attr: str, layer: int, layer_arg: int, nkv_of):
    """Install a planted fault in the launch wrapper ``module.attr``: the
    context of kv head 0 (query heads 0 .. g-1) zeroed in ``layer``, the
    call's ``layer_arg``-th argument; ``nkv_of(args)`` gives its kv heads.
    Returns the function that removes it."""
    real = getattr(module, attr)

    def faulty(*args, **kw):
        out = real(*args, **kw)
        if args[layer_arg] == layer:
            out[:, :args[0].shape[1] // nkv_of(args)] = 0
        return out

    setattr(module, attr, faulty)

    def remove():
        setattr(module, attr, real)
    return remove


def _zero_kv_head_fault(kc, layer: int = 0):
    """:func:`_head_fault` in B9's launch wrapper (``launch_flat``)."""
    return _head_fault(kc, "launch_flat", layer, 6, lambda a: a[1].shape[3])


def _same_bits(a, b) -> bool:
    """``a`` and ``b`` equal bit for bit (fp8 through ``uint8`` views:
    few operators take fp8)."""
    if a.dtype == torch.float8_e4m3fn:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


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
# the new tokens a request of the paged fp8 and speculative runs: their
# checks are per step and per round
TP_NEW_SHORT = 16
# the served runs' depth: the first 4 layers of the 7B weights (full
# width); each decode step makes 130 host all-reduces over gloo at 32
# layers, which made the TP phase the script's longest (at 16 layers the
# fp8 and speculative runs took the script past its time, and at 8 the
# sharded-training phase did on a slower host)
TP_RUN_LAYERS = 4
# (run, engine options, prompts, the attention kernel of every decode
# layer), each at full width and TP_RUN_LAYERS deep
TP_RUNS = (
    ("dense", dict(max_len=256), "smoke", "kv_attention_decode_bf16"),
    # the same in decode blocks, eager over gloo (no CUDA graph captures
    # gloo's host all-reduce): the dense run's tokens
    ("dense_blocks", dict(max_len=256, block_steps=BLOCK_STEPS), "smoke",
     "kv_attention_decode_bf16"),
    ("int8_kt", dict(max_len=2048, quantized_kv=True), "deep",
     "kv_attention_append_kt"),
    ("paged_int8_prefix", dict(max_len=2048, paged=True, page_size=16,
                               quantized_kv=True, prefix_cache=True),
     "prefix", "paged_attention_flat_int8"),
    ("paged_fp8", dict(max_len=2048, paged=True, page_size=16,
                       quantized_kv="fp8"), "deep",
     "paged_attention_flat_fp8"))
TP_PROMPTS = {"smoke": smoke_prompts, "deep": deep_prompts,
              "prefix": prefix_prompts}
# the greedy speculative round under TP (TPServing.spec_round): the
# serving surface's 2-layer spread draft of the TP_RUN_LAYERS target, fused
# and whole on each rank, SPEC_N_DRAFT proposals a round; (run, engine
# options, prompts, the TP run whose tokens it should give)
TP_SPEC_RUNS = (("dense_spec", dict(max_len=256), "smoke", "dense"),
                ("int8_kt_spec", dict(max_len=2048, quantized_kv=True),
                 "deep", "int8_kt"))
# what the TP path must never launch: K1-K3 (B4 serves every projection)
TP_ZERO = ("bitlinear_small_m", "bitlinear_fused_small_m",
           "bitlinear_large_m", "bitlinear_large_m_f32")


def _tp_new(run: str) -> int:
    """The new tokens a request of a TP_RUNS run."""
    return TP_NEW_SHORT if run == "paged_fp8" else TP_NEW


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


def _tp_served_run(group, params, config, prompts, opts,
                   new_tokens: int) -> dict:
    """Rank side: one served run of the TP engine, every launch count set
    to 0 just before it and read just after; forward passes counted (each
    decode step, a block's ``block_steps``, and each admission's prefill or
    chunk-append call)."""
    eng = _engine(params, config, None, dict(opts, tp_group=group))
    calls = {"decode": 0, "prefill": 0}
    for prog, kind, n in (
            ("prefill_rows", "prefill", 1),
            ("paged_prefill_rows", "prefill", 1),
            ("paged_chunk_append", "prefill", 1),
            ("step", "decode", 1), ("greedy_step", "decode", 1),
            ("paged_step", "decode", 1), ("paged_greedy_step", "decode", 1),
            ("block", "decode", eng.block_steps),
            ("paged_block", "decode", eng.block_steps)):
        real = getattr(eng._tp, prog)

        def counted(*args, _real=real, _kind=kind, _n=n):
            calls[_kind] += _n
            return _real(*args)
        setattr(eng._tp, prog, counted)
    torch.cuda.synchronize()
    reset_counts()
    t_start = time.perf_counter()
    uids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    step_s = []
    while eng.has_work():
        t = time.perf_counter()
        before = calls["decode"]
        eng.step()
        if calls["decode"] > before:
            step_s.append((time.perf_counter() - t)
                          / (calls["decode"] - before))
    wall = time.perf_counter() - t_start
    m = eng.metrics()
    return {"tokens": [eng.finished[u].generated for u in uids],
            "launches": read_counts(), "decode_steps": calls["decode"],
            "forwards": calls["decode"] + calls["prefill"],
            "decode_ms_per_step_median":
                float(np.median(step_s[1:])) * 1e3,
            "wall_s": wall, "pool_bytes": sum(
                x.numel() * x.element_size() for x in eng.cache),
            **{k: m[k] for k in ("free_pages", "total_pages",
                                 "prefix_cache_entries",
                                 "prefix_pages_reused") if k in m}}


def _tp_spec_run(group, params, config, draft, prompts, opts) -> dict:
    """Rank side: one greedy speculative run of the TP engine with
    ``draft`` whole on the rank, every count set to 0 just before it; the
    launches of its rounds (:func:`_drive`), apart from admission's."""
    d_config, d_params = draft
    eng = _engine(params, config, None, dict(
        opts, tp_group=group, draft_params=d_params, draft_config=d_config,
        n_draft=SPEC_N_DRAFT))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tokens, dec = _drive(eng, prompts, [TP_NEW_SHORT] * len(prompts))
    return {"tokens": tokens, "rounds": dec["calls"],
            "round_tokens": dec["emitted"], "round_launches": dec["launches"],
            "wall_ms_per_token": dec["wall_s"] * 1e3 / dec["emitted"],
            "wall_s": time.perf_counter() - t0, "launches": read_counts()}


def _tp_rank(group, next_token):
    """One rank of the TP phase: random llama2-7b weights from seed 0
    (unfused), the first-step checks, then the runs of TP_RUNS and
    TP_SPEC_RUNS on their first TP_RUN_LAYERS layers."""
    from onebit_tpu_torch import (BitLlamaConfig, fuse_for_decode,
                                  host_random_packed_params)
    from onebit_tpu_torch.train.draft import (build_draft, draft_config,
                                              slice_draft_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    config = BitLlamaConfig.named("llama2-7b")
    params = host_random_packed_params(config, seed=0, device=group.device)
    out = {"weights_s": time.perf_counter() - t0,
           "first_step": _tp_first_step(group, params, config, next_token)}
    params = slice_draft_params(params, range(TP_RUN_LAYERS))
    config = draft_config(config, TP_RUN_LAYERS)
    torch.cuda.empty_cache()
    for name, opts, prompts, _ in TP_RUNS:
        out[name] = _tp_served_run(group, params, config,
                                   TP_PROMPTS[prompts](), opts,
                                   _tp_new(name))
        torch.cuda.empty_cache()
    d_config, d_params = build_draft(params, config, SPEC_DRAFT_LAYERS)
    draft = d_config, fuse_for_decode(d_params, d_config)
    for name, opts, prompts, _ in TP_SPEC_RUNS:
        out[name] = _tp_spec_run(group, params, config, draft,
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
    (b) The runs of TP_RUNS on the first L = TP_RUN_LAYERS layers, 8
        greedy requests of 32 new tokens each, every count set to 0 before
        each: both ranks emit the same tokens and launch the same kernels;
        B4 (both instances) exactly 7 x L per forward pass, the run's
        attention kernel exactly L per decode step, K1-K3 never; pages all
        returned, and the prefix run reuses 448. The runs include fp8 pages
        (B10 fp8 L a step).
    (c) The runs of TP_SPEC_RUNS, the greedy speculative round with the
        2-layer spread draft (fused) whole on each rank: both ranks emit
        the same tokens and launch the same kernels; each round launches
        exactly B4 7 x L (the window), K1 and K2 2 x 5 x 2 and B9 bf16
        5 x 2 (the draft's steps), and nothing else (K3 never).

    Returns rank 0's B4 launches from the dense run, the main path."""
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
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
    layers = TP_RUN_LAYERS
    for name, opts, _, per_step in TP_RUNS:
        r0, r1 = ranks[0][name], ranks[1][name]
        counts = r0["launches"]
        b4 = sum(counts[k] for k in raw)
        line = {"phase": "tp_serve", "run": name, **opts, "mp": TP_MP,
                "backend": TP_BACKEND, "layers": layers,
                "requests": len(r0["tokens"]), "new_tokens": _tp_new(name),
                "ranks_tokens_equal": r0["tokens"] == r1["tokens"],
                "ranks_launches_equal": counts == r1["launches"],
                "launches_rank0": {k: v for k, v in counts.items() if v},
                "b4_launches": b4, "b4_want": 7 * layers * r0["forwards"],
                **({"tokens_equal_eager_tp_run":
                    r0["tokens"] == ranks[0]["dense"]["tokens"]}
                   if opts.get("block_steps") else {}),
                **{k: v for k, v in r0.items()
                   if k not in ("tokens", "launches")}}
        emit(line)
        ok = (line["ranks_tokens_equal"] and line["ranks_launches_equal"]
              and b4 == line["b4_want"] and r0["decode_steps"] > 0
              and counts[per_step] == layers * r0["decode_steps"]
              and not any(counts[k] for k in TP_ZERO)
              and all(len(t) == _tp_new(name)
                      and all(0 <= x < config.vocab_size for x in t)
                      for t in r0["tokens"]))
        if "free_pages" in r0:
            ok = ok and r0["free_pages"] == r0["total_pages"] - r0.get(
                "prefix_cache_entries", 0)
        if opts.get("prefix_cache"):
            ok = ok and r0["prefix_pages_reused"] == 7 * 64
        if opts.get("block_steps"):
            ok = ok and line["tokens_equal_eager_tp_run"]
        if not ok:
            raise RuntimeError(f"TP run {name}: ranks disagree, a launch "
                               f"count is off, or bad tokens: {line}")
    # the speculative runs: per round the target's window (B4, 7 a layer)
    # and the draft's n + 1 steps (K1, K2 twice a layer, B9 once), no other
    # kernel
    steps = (SPEC_N_DRAFT + 1) * SPEC_DRAFT_LAYERS
    per_round = {bc.RAW_SMALL_M.name: 7 * layers, bc.SMALL_M.name: 2 * steps,
                 bc.FUSED_SMALL_M.name: 2 * steps,
                 kc.DECODE_BF16.name: steps}
    for name, opts, _, plain in TP_SPEC_RUNS:
        r0, r1 = ranks[0][name], ranks[1][name]
        rounds = r0["rounds"]
        want = {k: v * rounds for k, v in per_round.items()}
        plain_tokens = ranks[0][plain]["tokens"]
        line = {"phase": "tp_serve", "run": name, **opts, "mp": TP_MP,
                "backend": TP_BACKEND, "layers": layers,
                "draft_layers": SPEC_DRAFT_LAYERS, "n_draft": SPEC_N_DRAFT,
                "requests": len(r0["tokens"]), "new_tokens": TP_NEW_SHORT,
                "rounds": rounds, "round_tokens": r0["round_tokens"],
                "tokens_per_round": r0["round_tokens"] / max(rounds, 1),
                "wall_ms_per_token": r0["wall_ms_per_token"],
                "wall_s": r0["wall_s"],
                "ranks_tokens_equal": r0["tokens"] == r1["tokens"],
                "ranks_round_launches_equal":
                    r0["round_launches"] == r1["round_launches"],
                "launches_per_round": per_round,
                "round_launches_rank0": r0["round_launches"],
                "launches_rank0": {k: v for k, v in r0["launches"].items()
                                   if v},
                "rows_equal_tp_plain_run": sum(
                    a == b[:len(a)] for a, b in zip(r0["tokens"],
                                                    plain_tokens))}
        emit(line)
        ok = (line["ranks_tokens_equal"]
              and line["ranks_round_launches_equal"] and rounds > 0
              and r0["round_launches"] == want
              and all(len(t) == TP_NEW_SHORT
                      and all(0 <= x < config.vocab_size for x in t)
                      for t in r0["tokens"]))
        if not ok:
            raise RuntimeError(f"TP speculative run {name}: ranks disagree "
                               f"or a round's launches are off: {line}")
    emit({"phase": "tp", "wall_s": time.perf_counter() - t_phase,
          "launches_reported": "rank 0 of the dense TP run"})
    dense = ranks[0]["dense"]["launches"]
    return {k: dense[k] for k in raw}


SERVE_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10]]
SERVE_NEW = 16
SERVE_FLAGS = ("--max-batch", "2", "--max-len", "256", "--max-new-tokens",
               str(SERVE_NEW), "--greedy", "--block-steps", str(BLOCK_STEPS),
               "--pipeline-blocks")


def _in_process_serve(loaded, dev, prompts) -> list:
    """The tokens an eager engine (one step a call) of the ``serve``
    flags gives ``prompts`` in this process."""
    from onebit_tpu_torch import ContinuousBatchingEngine
    from onebit_tpu_torch.engine.sampler import SamplingConfig
    eng = ContinuousBatchingEngine(
        loaded["params"], loaded["config"], max_batch=2, max_len=256,
        sampling=SamplingConfig(greedy=True), device=dev)
    uids = [eng.add_request(p, max_new_tokens=SERVE_NEW) for p in prompts]
    out = eng.run()
    return [out[u] for u in uids]


def _serve_http(ref, prompt, flags=SERVE_FLAGS,
                new_tokens: int = SERVE_NEW) -> dict:
    """``serve --http 0`` with ``flags`` in a process of its own: the port
    from its first line, one POST /generate of ``prompt`` and one GET
    /metrics; the process is interrupted (its exit code kept), and killed
    if it lingers."""
    import select
    import signal
    import urllib.request
    proc = subprocess.Popen(
        [sys.executable, "-m", "onebit_tpu_torch", "serve", "--ckpt", ref,
         "--http", "0", *flags], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    rc = None
    try:
        deadline, line = time.monotonic() + 300, ""
        while "serving on" not in line:
            left = deadline - time.monotonic()
            if left <= 0 or proc.poll() is not None or not select.select(
                    [proc.stdout], [], [], left)[0]:
                raise RuntimeError(f"serve --http did not start: "
                                   f"{proc.stderr.read()[-3000:]}"
                                   if proc.poll() is not None
                                   else "serve --http did not start")
            line = proc.stdout.readline()
        url = line.split()[2]
        req = urllib.request.Request(
            url + "/generate", headers={"Content-Type": "application/json"},
            data=json.dumps({"prompt": prompt,
                             "max_new_tokens": new_tokens}).encode())
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            tokens = json.loads(r.read())["tokens"]
        request_s = time.perf_counter() - t
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return {"tokens": tokens, "metrics": metrics, "request_s": request_s,
            "exit_code": rc}


def generate_cli_checks(dev) -> None:
    """The command lines on the 2-layer native checkpoint of 7B width that
    :func:`eval_checks` wrote under ``build/smoke_ckpt``: ``convert
    --format reference``; ``generate`` from the reference directory, whose
    tokens must equal the in-process ``generate`` of the checkpoint it
    loads; ``eval --check-engines all`` (dense, pipelined, kvq, int4, paged)
    with a pinned ``engine_check.ok`` of 1; ``serve --block-steps 8
    --pipeline-blocks`` on stdin lines of ids, and ``serve --http 0`` with
    one POST /generate and one GET /metrics, each with the tokens of an
    eager engine in this process. After ``convert`` the commands run
    together, ``serve --http`` driven while the others run, so their
    seconds overlap. The reference directory is removed after."""
    import shutil

    from onebit_tpu_torch import generate, load_reference_checkpoint
    from onebit_tpu_torch.engine.sampler import SamplingConfig
    ckpt = os.path.join(ROOT, "build", "smoke_ckpt")
    ref = os.path.join(ROOT, "build", "smoke_ref")
    seconds = {}
    started = []
    try:
        run_cli(seconds, "convert", ckpt, ref, "--format", "reference")
        spec = os.path.join(ref, "expect.json")
        with open(spec, "w") as f:
            json.dump({"engine_check.ok": {"value": 1.0, "atol": 0.0}}, f)
        started = [
            start_cli("generate", "--ckpt", ref, "--prompt", "1,2,3",
                      "--greedy", "--device", "cuda"),
            start_cli("eval", "--ckpt", ref, "--check-engines", "all",
                      "--expect", spec),
            start_cli("serve", "--ckpt", ref, *SERVE_FLAGS, stdin="\n".join(
                ",".join(map(str, p)) for p in SERVE_PROMPTS) + "\n")]
        loaded = load_reference_checkpoint(ref, device=dev)
        want = generate(loaded["params"], loaded["config"], [[1, 2, 3]],
                        sampling=SamplingConfig(greedy=True))[0]
        serve_want = _in_process_serve(loaded, dev, SERVE_PROMPTS)
        http_want = _in_process_serve(loaded, dev, SERVE_PROMPTS[1:2])[0]
        del loaded
        t = time.perf_counter()
        http = _serve_http(ref, SERVE_PROMPTS[1])
        seconds["serve --http"] = time.perf_counter() - t
        tokens = finish_cli(seconds, started[0])[-1]
        out = finish_cli(seconds, started[1])
        result = json.loads([ln for ln in out if ln.startswith("{")][-1])
        served = [json.loads(ln) for ln in finish_cli(seconds, started[2])
                  if ln.startswith("{")]
        line = {"phase": "generate_cli", "ckpt_layers": 2,
                "cli_tokens": tokens,
                "in_process_tokens": ",".join(map(str, want)),
                "engine_check": result["engine_check"],
                "engine_lines": [ln for ln in out if "engine check" in ln],
                "serve_completions": [o["completion"] for o in served],
                "serve_in_process": [",".join(map(str, w))
                                     for w in serve_want],
                "http_tokens": http["tokens"], "http_in_process": http_want,
                "http_request_s": http["request_s"],
                "http_metrics": http["metrics"], "seconds": seconds}
        emit(line)
        if tokens != line["in_process_tokens"] or \
                result["engine_check"]["ok"] != 1.0 or \
                line["serve_completions"] != line["serve_in_process"] or \
                http["tokens"] != http_want or \
                http["metrics"]["completed_requests"] != 1:
            raise RuntimeError(f"the generate, eval and serve command "
                               f"lines: {line}")
    finally:
        _end(started)
        shutil.rmtree(ref, ignore_errors=True)


def end_to_end(dev) -> dict:
    """The dense path at max_len 256, then the int8 and the int4
    quantized-KV paths and the paged paths (bf16 pages, int8 pages, bf16
    pages with prefix caching) at max_len 2048, batch generation
    (:func:`generate_checks`), then evaluation (:func:`eval_checks`), all
    at full llama2-7b width and depth on the same random weights; the
    generate and eval command lines (:func:`generate_cli_checks`); KD
    training (:func:`train_checks`); then the task harness and the task
    registry on the evaluation's weights (:func:`tasks_checks`,
    :func:`registry_checks`) and SFT (:func:`sft_checks`). Each served run
    goes again through graph-replayed decode blocks (:func:`block_run`), the
    dense one also with a fault captured in its graph
    (:func:`block_fault_check`); after training, fully sharded KD training
    on two ranks (:func:`parallel_checks`). Returns
    each kernel's launches from the run of its own path, those that
    its block run's graph replays made, and B11's launches in rank 0 of
    the sharded and of the tensor-parallel steps."""
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
    launches, graph_launches, served = {}, {}, {}
    # (name, prompts, engine options, per-step kernel, kernels of this path,
    # first-step check); each served run again in graph-replayed blocks
    for name, prompts, opts, per_step, path_kernels, check in (
            ("dense", smoke_prompts(), dict(max_len=256), kc.DECODE_BF16,
             all_kernels()[:3], True),
            ("int8", deep_prompts(), dict(max_len=2048, quantized_kv=True),
             kc.APPEND_KT, [kc.APPEND_KT], True),
            ("int4", deep_prompts(), dict(max_len=2048, quantized_kv="int4"),
             kc.APPEND_KT4, [kc.APPEND_KT4], True),
            ("paged", deep_prompts(), paged, pc.PAGED, [pc.PAGED], True),
            ("paged_int8", deep_prompts(), dict(paged, quantized_kv=True),
             pc.PAGED_INT8, [pc.PAGED_INT8], True),
            ("paged_fp8", deep_prompts(), dict(paged, quantized_kv="fp8"),
             pc.PAGED_FP8, [pc.PAGED_FP8], True),
            ("prefix", prefix_prompts(), dict(paged, prefix_cache=True),
             pc.PAGED, [], False)):
        if check:
            check_first_step(params, config, dev, prompts, 32, opts)
        run, tokens, line = served_run(params, config, dev, prompts, 32,
                                       opts, per_step)
        served[name] = tokens, line
        launches.update({k.name: run[k.name] for k in path_kernels})
        torch.cuda.empty_cache()
        _, in_graph = block_run(params, config, dev, prompts, 32, opts,
                                per_step, tokens)
        for k in list(path_kernels) + [per_step]:
            graph_launches.setdefault(k.name, in_graph[k.name])
        if per_step is kc.DECODE_BF16:
            block_fault_check(params, config, dev, prompts, 32, tokens)
    serve_surface_checks(params, config, dev, served)
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
    serve_surface_cli(dev)
    launches.update(train_checks(dev))
    torch.cuda.empty_cache()
    parallel = parallel_checks(dev)
    # the task harness and the registry on the evaluation's weights, made
    # again from their seed, then SFT
    unfused = host_random_packed_params(config, seed=0, device=dev)
    tasks_checks(unfused, config, dev)
    registry_checks(unfused, config, dev)
    del unfused
    torch.cuda.empty_cache()
    sft_checks(dev)
    # B6 and B8, the read-only variants, are on no path of the port
    return ({k.name: launches.get(k.name, 0) for k in all_kernels()},
            {k.name: graph_launches.get(k.name, 0) for k in all_kernels()},
            parallel)


# ---------------------------------------------------------------------------
# the parallel phase: fully sharded KD training on two ranks of the card
# ---------------------------------------------------------------------------

PAR_LAYERS, PAR_RANKS, PAR_BATCH, PAR_SEQLEN, PAR_STEPS = 2, 2, 4, 2048, 1
# the tp_train scenario's steps and batches; the sharded steps take the
# first PAR_STEPS of them
TP_TRAIN_STEPS = 3
# the planted faults run on the first FAULT_ROWS rows of the first batch,
# against the single-device step's gradients on those rows
FAULT_ROWS = 2
PAR_TIMEOUT = 900          # seconds for the ranks, every one of them
# the band of a rank's torch.cuda.max_memory_allocated over its steps
# around the memory plan's estimate of its step (parallel/memplan.py),
# stated before the first run on the card: the plan runs the same code on
# fake tensors, and the card adds only the allocator's 512-byte rounding
# and cuBLAS's workspace
PAR_MEM_BAND = (0.85, 1.2)


def _parallel_setup(dev):
    """The config at PAR_LAYERS, a random plain teacher (fp32,
    ``torch.Generator`` seed 0 on the card, so every process makes the same
    one), its SVID start student, the teacher in bf16 for the steps, and
    TP_TRAIN_STEPS global batches of PAR_BATCH x PAR_SEQLEN."""
    from onebit_tpu_torch import BitLlamaConfig
    from onebit_tpu_torch.core.build_start import build_start_params
    from onebit_tpu_torch.model.bitllama import init_params
    from onebit_tpu_torch.parallel.sharding import map_leaves
    config = BitLlamaConfig.named("llama2-7b", num_hidden_layers=PAR_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    teacher = init_params(config, gen, mode="linear", device=dev)
    student = build_start_params(teacher)
    teacher = map_leaves(teacher, lambda k, t: t.to(torch.bfloat16))
    rng = np.random.default_rng(11)
    ids = rng.integers(3, config.vocab_size,
                       (TP_TRAIN_STEPS, PAR_BATCH, PAR_SEQLEN))
    batches = [{"input_ids": b, "labels": b} for b in ids]
    return config, teacher, student, batches


def kd_recipe():
    """The reference recipe (scripts/llama_7b.sh), as the train phase."""
    from onebit_tpu_torch.train.losses import KDConfig
    return KDConfig(kd_alpha=1.0, kd_beta=1.0, kd_gamma=0.0,
                    kd_loss_scale=0.01)


def _par_train_cfg():
    from onebit_tpu_torch.train.trainer import TrainConfig
    return TrainConfig(warmup_steps=1, total_steps=TP_TRAIN_STEPS)


class _DropOneReduceScatter:
    """A data group whose rank 1 drops its contribution (zeros in place of
    its gradient) to one leaf's reduce-scatters: those of the gradients of
    ``shape``'s, the down_proj latent's ``[d, intermediate]`` in every
    layer (the planted fault of part d)."""

    def __init__(self, group, shape):
        self.inner, self.shape = group, tuple(shape)
        self.group, self.rank = group.group, group.rank
        self.size, self.device = group.size, group.device

    def all_gather(self, t):
        return self.inner.all_gather(t)

    def all_reduce(self, t):
        return self.inner.all_reduce(t)

    def reduce_scatter(self, full):
        if self.rank == 1 and tuple(full.shape) == self.shape:
            full = torch.zeros_like(full)
        return self.inner.reduce_scatter(full)


def _full_grads(named, grads, layout, mesh, keys=None) -> dict:
    """The full gradient of each trainable leaf (of those in ``keys``,
    default every one) on rank 0's host, by key (an empty dict on the
    other ranks): a data-split leaf's layers' shards stacked, every split
    leaf gathered over the data ranks, then the model ranks."""
    from onebit_tpu_torch.parallel.sharding import gather_full
    out = {}
    for (key, _), g in zip(named, grads):
        if keys is not None and key not in keys:
            continue
        g = torch.stack(g) if isinstance(g, list) else g
        g = gather_full(g, key, layout, mesh)
        if mesh.rank == 0:
            out[key] = g.float().cpu()
    return out


def _host_grad_rel(grads: dict, ref: dict) -> float:
    """The largest relative error of the leaves in ``grads`` (a subset's
    bounds the whole's from below)."""
    return max(((g - ref[k]).abs().max() / ref[k].abs().max()).item()
               for k, g in grads.items())


def _clock(marks: dict, name: str, t0: float) -> None:
    marks[name] = round(time.perf_counter() - t0, 3)


def _first_step(step, state, t_local, batch, named, layout, mesh, ref,
                out, prefix):
    """Step 1 of a scenario: its gradients, each leaf gathered to rank 0's
    host and held against the single-device step's (``ref``: loss,
    gradients), then its update. Returns ``(state, metrics, seconds)``,
    the seconds those of the gradients and the update, not the gather's."""
    t = time.perf_counter()
    grads, m = step.grads(state, t_local, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    full = _full_grads(named, grads, layout, mesh)
    if mesh.rank == 0:
        out[f"{prefix}_loss"] = m["loss"].item()
        out[f"{prefix}_loss_rel_err"] = abs(m["loss"].item() - ref[0]) / \
            abs(ref[0])
        out[f"{prefix}_grad_max_rel_err"] = _host_grad_rel(full, ref[1])
    del full
    t = time.perf_counter()
    state, m = step.update(state, grads, m)
    torch.cuda.synchronize()
    return state, m, seconds + time.perf_counter() - t


def _reference(config, student, teacher, batch) -> tuple:
    """The single-device step's loss and gradients (by key, on the host)
    on ``batch``."""
    from onebit_tpu_torch.train import trainer as tt
    state = tt.init_train_state(tt.clone_params(student), _par_train_cfg())
    step = tt.make_train_step(config, kd_recipe(), _par_train_cfg(),
                              compute_dtype=torch.bfloat16)
    grads, m = step.grads(state, teacher, batch)
    return m["loss"].item(), {
        k: g.float().cpu() for (k, _), g in
        zip(tt.named_trainable(state.params), grads)}


def _import_dcp() -> None:
    """torch.distributed.checkpoint and DTensor, which a first sharded
    save imports (12 s of a rank's 18 s first save on the H100 machine,
    whose installation compiles those modules at their first import)."""
    import torch.distributed.checkpoint  # noqa: F401
    import torch.distributed.tensor  # noqa: F401


def _parallel_rank(tp_group, ckpt_dir):
    """One rank of the parallel phase: (b) on rank 0 alone, then (c)-(e)
    on both. Returns numbers only. The checkpoint's modules are imported
    on a thread of their own meanwhile, joined before (e)'s save."""
    import dataclasses
    import threading

    import torch.distributed as dist
    import torch.profiler  # noqa: F401  (imported before the thread starts)

    from onebit_tpu_torch.kernels import attention_cuda as fc
    from onebit_tpu_torch.parallel.mesh import create_mesh
    from onebit_tpu_torch.parallel.sharding import (map_leaves, mesh_layout,
                                                    shard_params)
    from onebit_tpu_torch.train import trainer as tt
    from onebit_tpu_torch.train.run_kd import (load_train_state,
                                               save_train_state)
    t0, marks = time.perf_counter(), {}
    importer = threading.Thread(target=_import_dcp, daemon=True)
    importer.start()
    mesh = create_mesh((PAR_RANKS, 1), tp_group.device.type)
    dev = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    config, teacher, student, batches = _parallel_setup(dev)
    fault_batch = {k: v[:FAULT_ROWS] for k, v in batches[0].items()}
    kd_cfg, tcfg = kd_recipe(), _par_train_cfg()
    out = {"rank": mesh.rank, "timeline_s": marks}
    _clock(marks, "setup", t0)
    refs = None
    if mesh.rank == 0:
        # (b) the single-device step on the global batch, and on the
        # faults' rows: loss, gradients
        t = time.perf_counter()
        refs = {"step": _reference(config, student, teacher, batches[0]),
                "fault": _reference(config, student, teacher, fault_batch)}
        out["reference_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
    dist.barrier()
    _clock(marks, "reference", t0)

    layout = mesh_layout(student, config, mesh.shape)
    t_layout = mesh_layout(teacher, config, mesh.shape)
    local = shard_params(student, mesh, layout)
    t_local = shard_params(teacher, mesh, t_layout)
    # the tp_train scenario shards the same trees again, after the steps
    student, teacher = (map_leaves(t, lambda k, v: v.cpu())
                        for t in (student, teacher))
    torch.cuda.empty_cache()
    state = tt.init_train_state(local, tcfg)
    out["split"] = sorted(layout.data)
    named = tt.named_trainable(state.params)

    # (d) rank 1's share of the down_proj latent's reduce-scatters
    # dropped: the gradient of that leaf, the one the fault reaches
    down = (config.hidden_size, config.intermediate_size)
    faulty = dataclasses.replace(
        mesh, data=_DropOneReduceScatter(mesh.data, down))
    step = tt.make_sharded_train_step(config, kd_cfg, tcfg, faulty, layout,
                                      t_layout, compute_dtype=torch.bfloat16)
    grads, m = step.grads(state, t_local, fault_batch)
    full = _full_grads(named, grads, layout, mesh,
                       keys={"layers.down_proj.latent"})
    del grads
    if mesh.rank == 0:
        out["fault_grad_max_rel_err"] = _host_grad_rel(full,
                                                       refs["fault"][1])
    del full
    torch.cuda.empty_cache()
    out["reference_loss"] = refs["step"][0] if refs else None
    _clock(marks, "fault", t0)

    # the steps: every count set to 0 before them, the peak reset; (c)
    # step 1's loss and gradients against (b)'s; (e) the state after step
    # 1 saved (DCP, each rank its blocks) and kept
    step = tt.make_sharded_train_step(config, kd_cfg, tcfg, mesh, layout,
                                      t_layout, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_s, metrics, saved = [], [], None
    for i, batch in enumerate(batches[:PAR_STEPS]):
        if i == 0:
            state, m, seconds = _first_step(
                step, state, t_local, batch, named, layout, mesh,
                refs and refs["step"], out, "sharded")
        else:
            t = time.perf_counter()
            state, m = step(state, t_local, batch)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
        step_s.append(seconds)
        metrics.append({k: v.item() for k, v in m.items()})
        if i == 0:
            _clock(marks, "step_1", t0)
            importer.join()
            _clock(marks, "imported", t0)
            t = time.perf_counter()
            save_train_state(ckpt_dir, state, sharded=True, mesh=mesh,
                             layout=layout)
            out["save_s"] = time.perf_counter() - t
            saved = {k: v.detach().clone()
                     for k, v in tt.state_tensors(state).items()}
            _clock(marks, "save", t0)
    counts = read_counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = {k: v for k, v in counts.items() if v}
    out["want_launches"] = {fc.FLASH_BF16.name: 2 * PAR_LAYERS * PAR_STEPS,
                            fc.FLASH_DKV_BF16.name: PAR_LAYERS * PAR_STEPS,
                            fc.FLASH_DQ_BF16.name: PAR_LAYERS * PAR_STEPS}
    out["step_s"], out["metrics"] = step_s, metrics
    _clock(marks, "steps", t0)

    # (e) a fresh sharded state of the same shapes reads the saved one
    t = time.perf_counter()
    fresh = tt.TrainState(
        map_leaves(state.params, lambda k, v: torch.empty_like(v)),
        tt.AdamState(0, [torch.empty_like(x) for x in state.opt_state.mu],
                     [torch.empty_like(x) for x in state.opt_state.nu]), 0)
    del state
    fresh = load_train_state(ckpt_dir, fresh, mesh=mesh, layout=layout)
    out["load_s"] = time.perf_counter() - t
    got = tt.state_tensors(fresh)
    out["ckpt_same_bits"] = sorted(got) == sorted(saved) and all(
        torch.equal(got[k].to(saved[k].device), saved[k]) for k in saved)
    out["ckpt_step"] = fresh.step
    del fresh, got, saved, local, named, t_local, step
    torch.cuda.empty_cache()
    _clock(marks, "load", t0)
    out["tp"] = _tp_train_rank(mesh, config, student, teacher, batches,
                               fault_batch, refs, marks, t0)
    return out


@contextlib.contextmanager
def _stats_fault(rank, layers: int, kind: str):
    """A planted fault in the backward of ``kernels/bitlinear_sharded.py``
    ``sum_stats``, the all-reduce of a column-parallel LayerNorm's
    statistics (part c of the tp_train scenario). ``"drop"``: rank 1's
    share of the gradient of layer 0's q/k/v statistics dropped (zeros in
    its place) before their all-reduces; a step's backward calls them four
    a layer, from the last layer down: gate/up's centred squares and
    means, then q/k/v's, so layer 0's q/k/v are the last two.
    ``"local"``: no all-reduce in any layer's backward (each rank keeps
    its own share)."""
    from onebit_tpu_torch.kernels import bitlinear_sharded as bs
    keep = bs._SumStats.backward
    seen = [0]

    def drop(ctx, d):
        if rank == 1 and seen[0] >= 4 * layers - 2:
            d = torch.zeros_like(d)
        seen[0] += 1
        return keep(ctx, d)

    def local(ctx, d):
        return d, None
    bs._SumStats.backward = staticmethod({"drop": drop, "local": local}[kind])
    try:
        yield
    finally:
        bs._SumStats.backward = keep


# the leaves that layer 0's q/k/v statistics reach in the backward, on
# which the faults' gradients are read: every other leaf's gradient under
# "drop" equals the sound pass's; under "local" a subset's largest error
# bounds the whole's from below (on an H100 80GB HBM3 at 700 W: 0.0752 on
# these leaves at 4 rows, 0.0787 on every leaf at 2 rows)
_QKV_LEAVES = {f"layers.{n}.{f}" for n in ("q_proj", "k_proj", "v_proj")
               for f in ("latent", "input_factor", "weight_scale")} | {
    "layers.input_layernorm"}


def _tp_train_rank(data_mesh, config, student, teacher, batches,
                   fault_batch, refs, marks, t0) -> dict:
    """The tp_train scenario on one rank of the mesh ``(1, PAR_RANKS)``
    (``parallel/mesh.py`` ``create_mesh`` over the phase's ranks; the
    trees on the host, split by ``mesh_layout``): (c) the two planted
    faults of :func:`_stats_fault` on the faults' rows, then
    TP_TRAIN_STEPS steps, every count set to 0 before them: (b) step 1's
    loss and gradients on the global batch against the single-device
    step's (``refs``, rank 0's), rank 0's last step profiled. Numbers
    only."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from onebit_tpu_torch.kernels import attention_cuda as fc
    from onebit_tpu_torch.parallel.mesh import create_mesh
    from onebit_tpu_torch.parallel.sharding import mesh_layout, shard_params
    from onebit_tpu_torch.train import trainer as tt
    kd_cfg, tcfg = kd_recipe(), _par_train_cfg()
    mesh = create_mesh((1, PAR_RANKS), data_mesh.device.type)
    layout = mesh_layout(student, config, mesh.shape)
    t_layout = mesh_layout(teacher, config, mesh.shape)
    state = tt.init_train_state(shard_params(student, mesh, layout), tcfg)
    t_local = shard_params(teacher, mesh, t_layout)
    step = tt.make_sharded_train_step(config, kd_cfg, tcfg, mesh, layout,
                                      t_layout, compute_dtype=torch.bfloat16)
    named = tt.named_trainable(state.params)
    out = {"model_split": sorted(layout.model),
           "heads_per_rank": config.num_attention_heads // mesh.model.size}
    _clock(marks, "tp_shard", t0)
    for kind in ("drop", "local"):
        t = time.perf_counter()
        with _stats_fault(mesh.rank, PAR_LAYERS, kind):
            grads, m = step.grads(state, t_local, fault_batch)
        full = _full_grads(named, grads, layout, mesh, keys=_QKV_LEAVES)
        del grads
        out[f"{kind}_s"] = time.perf_counter() - t
        if mesh.rank == 0:
            out[f"{kind}_grad_max_rel_err"] = _host_grad_rel(
                full, refs["fault"][1])
        del full
        torch.cuda.empty_cache()
        _clock(marks, f"tp_fault_{kind}", t0)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_s, metrics, prof = [], [], None
    for i, batch in enumerate(batches):
        if i == 0:
            state, m, seconds = _first_step(
                step, state, t_local, batch, named, layout, mesh,
                refs and refs["step"], out, "tp")
        else:
            t = time.perf_counter()
            if i == TP_TRAIN_STEPS - 1 and mesh.rank == 0:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    state, m = step(state, t_local, batch)
                    torch.cuda.synchronize()
            else:
                state, m = step(state, t_local, batch)
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t
        step_s.append(seconds)
        metrics.append({k: v.item() for k, v in m.items()})
    counts = read_counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = {k: v for k, v in counts.items() if v}
    out["want_launches"] = {
        fc.FLASH_BF16.name: 2 * PAR_LAYERS * TP_TRAIN_STEPS,
        fc.FLASH_DKV_BF16.name: PAR_LAYERS * TP_TRAIN_STEPS,
        fc.FLASH_DQ_BF16.name: PAR_LAYERS * TP_TRAIN_STEPS}
    out["step_s"], out["metrics"] = step_s, metrics
    _clock(marks, "tp_steps", t0)
    if prof is not None:
        out["profiled_step_device_ms"], out["top_kernels"] = \
            _device_ms(prof)
    _clock(marks, "tp_profile_read", t0)
    return out


def _tp_train_line(ranks, plan) -> dict:
    """The tp_train scenario's line from the ranks' results, and whether
    it passed: the step within TRAIN_GRAD_TOL[bfloat16] of the
    single-device step, both faults beyond it, finite losses equal on both
    ranks, exact B11 launches, each rank's peak within PAR_MEM_BAND of
    the plan."""
    tol = TRAIN_GRAD_TOL[torch.bfloat16]
    lo, hi = PAR_MEM_BAND
    tp = [r["tp"] for r in ranks]
    per_rank = []
    for r in tp:
        steady = sum(r["step_s"][1:]) / (TP_TRAIN_STEPS - 1)
        per_rank.append({
            "step_s": r["step_s"], "ms_per_step": steady * 1e3,
            "tok_per_s": PAR_BATCH * PAR_SEQLEN / steady,
            "peak_bytes": r["peak_bytes"],
            "peak_over_plan": r["peak_bytes"] / plan.peak_bytes,
            "launches": r["launches"], "drop_fault_s": r["drop_s"],
            "local_fault_s": r["local_s"]})
    t0 = tp[0]
    busy = t0["profiled_step_device_ms"] / (t0["step_s"][-1] * 1e3)
    line = {"phase": "tp_train", "mesh": [1, PAR_RANKS],
            "backend": TP_BACKEND, "layers": PAR_LAYERS,
            "batch": [PAR_BATCH, PAR_SEQLEN], "dtype": "bfloat16",
            "heads_per_rank": t0["heads_per_rank"],
            "model_split": t0["model_split"],
            "reference_loss": ranks[0]["reference_loss"],
            "tp_loss": t0["tp_loss"], "loss_rel_err": t0["tp_loss_rel_err"],
            "grad_max_rel_err": t0["tp_grad_max_rel_err"], "rel_tol": tol,
            "fault": "rank 1's share of the gradient of layer 0's q/k/v "
                     "LayerNorm statistics dropped before their all-reduces",
            "fault_grad_max_rel_err": t0["drop_grad_max_rel_err"],
            "fault_local": "no all-reduce in the statistics' backward, "
                           "every layer",
            "fault_local_grad_max_rel_err": t0["local_grad_max_rel_err"],
            "fault_leaves": sorted(_QKV_LEAVES),
            "fault_rows": FAULT_ROWS,
            "metrics": t0["metrics"], "want_launches": t0["want_launches"],
            "per_rank": per_rank, "mem_band": list(PAR_MEM_BAND),
            "plan_peak_bytes": plan.peak_bytes,
            "rank0_profiled_step_device_ms": t0["profiled_step_device_ms"],
            "rank0_busy_share": busy,
            "rank0_top_kernels": t0["top_kernels"],
            "step_s_of": "step 1: its gradients and update, not the "
                         "gradients' gather to the host between them",
            "rate_of": "two gloo ranks share one card and gloo's host "
                       "collectives: a path check, not a multi-card rate"}
    finite = all(math.isfinite(v) for r in tp for m in r["metrics"]
                 for v in m.values())
    ok = (finite and t0["tp_loss_rel_err"] <= tol
          and t0["tp_grad_max_rel_err"] <= tol
          and t0["drop_grad_max_rel_err"] > tol
          and t0["local_grad_max_rel_err"] > tol
          and all({k: v for k, v in r["launches"].items() if "flash" in k}
                  == r["want_launches"] for r in tp)
          and all(lo <= p["peak_over_plan"] <= hi for p in per_rank)
          and all(r["metrics"] == t0["metrics"] for r in tp))
    return line, ok


def parallel_checks(dev) -> dict:
    """Fully sharded KD training at llama2-7b width, PAR_LAYERS layers, on
    PAR_RANKS gloo ranks sharing the card (``spawn_tp``; each rank's
    params, teacher and moments split over both, ``parallel/sharding.py``):

    (a) the memory plan of one rank's step (``parallel/memplan.py``
        ``dry_run_train``: batch 2 x 2048 a rank, bf16 compute, no remat),
        the ranks' sum held against the card's memory before anything
        launches;
    (b) rank 0 alone: the single-device step (``make_train_step``) on the
        global batch PAR_BATCH x PAR_SEQLEN, kernel path, and on its first
        FAULT_ROWS rows (the planted faults'): the losses and the
        gradients, moved to the host;
    (c) PAR_STEPS sharded steps on the first global batches, every count
        set to 0 before them; step 1's loss's relative error and its
        gradients' largest relative error (the shards gathered to the
        host before its update) within TRAIN_GRAD_TOL[bfloat16]; finite
        losses, each rank's B11 bf16 exactly 2 x PAR_LAYERS a step
        (student, teacher) and B11-dkv, B11-dq PAR_LAYERS a step; per rank
        the ms a step (step 1's without the gather), the tokens/s,
        ``max_memory_allocated`` beside (a)'s estimate (PAR_MEM_BAND);
    (d) before the steps, on the faults' rows, rank 1's contribution to
        one leaf's reduce-scatters dropped (:class:`_DropOneReduceScatter`,
        the down_proj latent): that leaf's gradient must break the
        limit;
    (e) the state after step 1 saved as DCP files (each rank its blocks,
        ``save_train_state(sharded=True)``) and read into a fresh sharded
        state: the same bits;

    then the ``tp_train`` scenario, the same ranks as the mesh ``(1,
    PAR_RANKS)`` (tensor-parallel training, ``parallel/sharding.py``
    ``mesh_layout``: each rank the model shard of every projection and 16
    of the 32 heads, both ranks the whole global batch), on the same trees
    and batches (:func:`_tp_train_rank`): its plan beside (a)'s, two
    planted faults in the backward of the LayerNorm statistics' all-reduce
    on the faults' rows (:func:`_stats_fault`: one share of one layer
    dropped, and no all-reduce at all) that must break the limit, and
    TP_TRAIN_STEPS steps with the same exact B11 launches, step 1's loss
    and gradients against (b)'s within TRAIN_GRAD_TOL[bfloat16], each
    rank's ms a step, tokens/s and peak memory beside the plan
    (PAR_MEM_BAND), rank 0's last step profiled (device ms, busy share).

    Returns B11's launches of rank 0 in the sharded steps
    (``parallel_launches``) and in the tensor-parallel ones
    (``tp_train_launches``)."""
    import shutil

    from onebit_tpu_torch.parallel.memplan import dry_run_train
    from onebit_tpu_torch.parallel.mesh import spawn_tp
    from onebit_tpu_torch.kernels import attention_cuda as fc
    from onebit_tpu_torch import BitLlamaConfig
    t0 = time.perf_counter()
    config = BitLlamaConfig.named("llama2-7b", num_hidden_layers=PAR_LAYERS)
    plan = dry_run_train(config, (PAR_RANKS, 1), PAR_BATCH, PAR_SEQLEN,
                         kd_cfg=kd_recipe(), train_cfg=_par_train_cfg())
    card = torch.cuda.get_device_properties(0).total_memory
    line = {"phase": "parallel_plan", "config": "llama2-7b",
            "layers": PAR_LAYERS, "mesh": [PAR_RANKS, 1],
            "batch_per_rank": [PAR_BATCH // PAR_RANKS, PAR_SEQLEN],
            "report": str(plan), "peak_bytes": plan.peak_bytes,
            "ranks_sum_bytes": PAR_RANKS * plan.peak_bytes,
            "card_bytes": card, "seconds": time.perf_counter() - t0,
            "reduced": f"depth 32 -> {PAR_LAYERS}: two ranks share one 80 GB "
                       f"card (a rank a card would hold 32 layers split "
                       f"8 ways, parallel/memplan.py)"}
    emit(line)
    if PAR_RANKS * plan.peak_bytes > card:
        raise RuntimeError(f"the plan does not fit the card: {line}")
    t0 = time.perf_counter()
    tp_plan = dry_run_train(config, (1, PAR_RANKS), PAR_BATCH, PAR_SEQLEN,
                            kd_cfg=kd_recipe(), train_cfg=_par_train_cfg())
    line = dict(line, phase="tp_train_plan", mesh=[1, PAR_RANKS],
                batch_per_rank=[PAR_BATCH, PAR_SEQLEN], report=str(tp_plan),
                peak_bytes=tp_plan.peak_bytes,
                ranks_sum_bytes=PAR_RANKS * tp_plan.peak_bytes,
                seconds=time.perf_counter() - t0)
    emit(line)
    if PAR_RANKS * tp_plan.peak_bytes > card:
        raise RuntimeError(f"the plan does not fit the card: {line}")
    ckpt_dir = os.path.join(ROOT, "build", "smoke_parallel")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t = time.perf_counter()
    try:
        ranks = spawn_tp(_parallel_rank, PAR_RANKS, backend=TP_BACKEND,
                         device="cuda", timeout=PAR_TIMEOUT,
                         args=(ckpt_dir,))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = time.perf_counter() - t
    tol = TRAIN_GRAD_TOL[torch.bfloat16]
    r0 = ranks[0]
    lo, hi = PAR_MEM_BAND
    per_rank = []
    for r in ranks:
        steady = sum(r["step_s"]) / PAR_STEPS
        per_rank.append({
            "rank": r["rank"], "step_s": r["step_s"],
            "ms_per_step": steady * 1e3,
            "tok_per_s": PAR_BATCH // PAR_RANKS * PAR_SEQLEN / steady,
            "peak_bytes": r["peak_bytes"],
            "peak_over_plan": r["peak_bytes"] / plan.peak_bytes,
            "launches": r["launches"], "save_s": r["save_s"],
            "load_s": r["load_s"], "ckpt_same_bits": r["ckpt_same_bits"]})
    line = {"phase": "parallel", "ranks": PAR_RANKS, "backend": TP_BACKEND,
            "layers": PAR_LAYERS, "batch": [PAR_BATCH, PAR_SEQLEN],
            "dtype": "bfloat16", "split_leaves": r0["split"],
            "reference_loss": r0["reference_loss"],
            "reference_s": r0["reference_s"],
            "sharded_loss": r0["sharded_loss"],
            "loss_rel_err": r0["sharded_loss_rel_err"],
            "grad_max_rel_err": r0["sharded_grad_max_rel_err"],
            "rel_tol": tol,
            "fault": "rank 1's share of the down_proj latent's "
                     "reduce-scatters (every layer) dropped",
            "fault_rows": FAULT_ROWS,
            "fault_grad_max_rel_err": r0["fault_grad_max_rel_err"],
            "metrics": r0["metrics"], "want_launches": r0["want_launches"],
            "per_rank": per_rank, "mem_band": list(PAR_MEM_BAND),
            "plan_peak_bytes": plan.peak_bytes,
            "tok_per_s_global": PAR_BATCH * PAR_SEQLEN / max(
                sum(r["step_s"]) / PAR_STEPS for r in ranks),
            "step_s_of": "step 1: its gradients and update, not the "
                         "gradients' gather to the host between them",
            "ckpt_step": r0["ckpt_step"], "wall_s": wall,
            "timeline_s": [r["timeline_s"] for r in ranks]}
    emit(line)
    finite = all(math.isfinite(v) for r in ranks for m in r["metrics"]
                 for v in m.values())
    ok = (finite and r0["sharded_loss_rel_err"] <= tol
          and r0["sharded_grad_max_rel_err"] <= tol
          and r0["fault_grad_max_rel_err"] > tol
          and all({k: v for k, v in r["launches"].items() if "flash" in k}
                  == r["want_launches"] for r in ranks)
          and all(lo <= p["peak_over_plan"] <= hi for p in per_rank)
          and all(r["ckpt_same_bits"] and r["ckpt_step"] == 1
                  for r in ranks)
          and ranks[0]["metrics"] == ranks[1]["metrics"])
    if not ok:
        raise RuntimeError(f"the sharded KD step: {line}")
    line, ok = _tp_train_line(ranks, tp_plan)
    emit(line)
    if not ok:
        raise RuntimeError(f"the tensor-parallel KD step: {line}")
    names = (fc.FLASH_BF16.name, fc.FLASH_DKV_BF16.name,
             fc.FLASH_DQ_BF16.name)
    return {"parallel_launches": {k: r0["launches"].get(k, 0)
                                  for k in names},
            "tp_train_launches": {k: r0["tp"]["launches"].get(k, 0)
                                  for k in names}}


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
# the KL; the 32 of llama2-7b take the fully sharded step over 8 cards
# (parallel/sharding.py; the parallel phase runs it on 2 ranks).
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


def _kd_step_device_ms(config, kd_cfg, params, teacher, batch, dtype):
    """One more kernel-path remat micro-step of :func:`_kd_grads`, profiled:
    its device ms (summed over kernels) and its ten largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _kd_grads(config, kd_cfg, params, teacher, batch, dtype, "auto")
    return _device_ms(prof)


def _train_setup(dev):
    """(a): the config at TRAIN_LAYERS, a random plain teacher and its SVID
    start student, the KD config, the token blocks and the first batch."""
    from onebit_tpu_torch import BitLlamaConfig
    from onebit_tpu_torch.core.build_start import build_start_params
    from onebit_tpu_torch.model.bitllama import init_params
    config = BitLlamaConfig.named("llama2-7b", num_hidden_layers=TRAIN_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    teacher = init_params(config, gen, mode="linear", device=dev)
    student = build_start_params(teacher)
    torch.cuda.synchronize()
    kd_cfg = kd_recipe()
    rng = np.random.default_rng(7)
    blocks = rng.integers(3, config.vocab_size,
                          (TRAIN_STEPS * TRAIN_BATCH, TRAIN_SEQLEN)
                          ).astype(np.int32)
    first = {k: torch.from_numpy(blocks[:TRAIN_BATCH]).long().to(dev)
             for k in ("input_ids", "labels")}
    return config, teacher, student, kd_cfg, blocks, first


def kd_step_timing(dev) -> None:
    """The device ms of (b)'s fp32 kernel-path micro-step alone (for
    ``scripts/torch_kernel_ab.py``: the same step on two checkouts'
    kernels)."""
    config, teacher, student, kd_cfg, _, first = _train_setup(dev)
    _kd_grads(config, kd_cfg, student, teacher, first, torch.float32, "auto")
    device_ms, top = _kd_step_device_ms(config, kd_cfg, student, teacher,
                                        first, torch.float32)
    emit({"phase": "kd_step_timing", "dtype": "float32", "remat": True,
          "layers": TRAIN_LAYERS, "batch": [TRAIN_BATCH, TRAIN_SEQLEN],
          "device_ms": device_ms, "top_kernels": top})


def _grad_rel(grads, ref) -> float:
    """The largest over leaves of max |g - g_ref| / max |g_ref|."""
    return max(((g - r).abs().max() / r.abs().max()).item()
               for g, r in zip(grads, ref))


def _port_kernel_count(prof) -> int:
    """The profiled window's launches of the port's own kernels (the
    ``onebit*`` namespaces of ``onebit_tpu_torch/csrc``)."""
    from torch.autograd import DeviceType
    return sum(evt.count for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA
               and "onebit" in evt.key)


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
                # names cut to 80 characters can meet: add, never replace
                key = evt.key[:80]
                kernels[key] = kernels.get(key, 0.0) + float(
                    getattr(evt, name)) / 1e3
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
        recomputation, teacher), B11-dkv and B11-dq once; the kernel
        path's micro-step again, profiled: its device ms;
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

    from onebit_tpu_torch.eval import ppl as ppl_mod
    from onebit_tpu_torch.kernels import attention_cuda as fc
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.model.bitllama import pack_model_params
    from onebit_tpu_torch.train.data import batch_iterator
    from onebit_tpu_torch.train.trainer import (TrainConfig,
                                                init_train_state,
                                                make_train_step)
    L = TRAIN_LAYERS
    emit({"phase": "train_config", "config": "llama2-7b", "layers": L,
          "full_depth": 32, "batch": [TRAIN_BATCH, TRAIN_SEQLEN],
          "reduced": "depth 32 -> 4: at 7B width a layer's fp32 latent "
                     "weights, gradients, Adam moments, teacher share and "
                     "activations take about 13 GB on one card; 32 layers "
                     "take the fully sharded step over 8 cards (the "
                     "parallel phase runs it on 2 ranks)"})
    t0 = time.perf_counter()
    config, teacher, student, kd_cfg, blocks, first = _train_setup(dev)
    emit({"phase": "train_start", "seconds": time.perf_counter() - t0,
          "teacher": "linear fp32, torch.Generator seed 0",
          "student_h_finite": all(
              bool(torch.isfinite(student["layers"][n].weight_scale).all())
              for n in ("q_proj", "down_proj"))})
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
        line["device_ms"], line["top_kernels"] = _kd_step_device_ms(
            config, kd_cfg, student, teacher, first, dtype)
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
        run_cli(seconds, *args)

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
        kd_cfg = kd_recipe()
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


# ---------------------------------------------------------------------------
# phase 7: the zero-shot task harness at full llama2-7b width and depth
# ---------------------------------------------------------------------------

TASK_DOCS = 8             # docs a task
TASK_BATCH = 16           # evaluate_tasks' default
TASK_FEWSHOT = "hellaswag"  # the task run again with one shot
TASK_GEN_ROWS, TASK_GEN_NEW = 4, 16   # the greedy_until batch
# tasks whose acc is a request's greedy flag
GREEDY_FLAG_TASKS = ("lambada_openai", "triviaqa", "arithmetic_2da",
                     "lambada_standard_cloze")
TASK_WORDS = ("the a cat dog river stone blue quickly jumps over under lazy "
              "bright house tree wind seven wizards watch quietly tonight "
              "small green paper runs sings carefully into market bread "
              "water light north cold").split()


def byte_tokenize(text: str) -> list:
    """A deterministic tokenizer inside the vocabulary: utf-8 bytes + 3."""
    return [b + 3 for b in text.encode("utf-8")]


def byte_detokenize(tokens) -> str:
    """The inverse of :func:`byte_tokenize` on its tokens (bytes that are
    not utf-8 show as ``\\xNN``); any other token becomes a private-use
    character of its own (U+F0000 + id), so that a random model's tokens
    outside the bytes still tell texts apart."""
    out, run = [], bytearray()
    for t in tokens:
        if 3 <= t < 259:
            run.append(t - 3)
            continue
        out.append(run.decode("utf-8", "backslashreplace")
                   + chr(0xF0000 + t))
        run = bytearray()
    return "".join(out) + run.decode("utf-8", "backslashreplace")


def task_raw_docs(seed: int = 9) -> dict:
    """TASK_DOCS raw rows of each task in its published schema (PIQA,
    ARC-Easy/Challenge with some numeric answer keys, BoolQ, HellaSwag,
    Winogrande, LAMBADA, an MMLU subject), from ``random.Random(seed)``."""
    import random
    rnd = random.Random(seed)

    def text(lo, hi):
        return " ".join(rnd.choice(TASK_WORDS)
                        for _ in range(rnd.randint(lo, hi)))

    def arc(i):
        labels = "1234" if i % 3 == 0 else "ABCD"
        return {"question": text(6, 14) + "?", "answerKey":
                rnd.choice(labels), "choices": {
                    "text": [text(1, 4) for _ in labels],
                    "label": list(labels)}}
    n = range(TASK_DOCS)
    return {
        "piqa": [{"goal": text(5, 12), "sol1": text(4, 10),
                  "sol2": text(4, 10), "label": rnd.randint(0, 1)}
                 for _ in n],
        "arc_easy": [arc(i) for i in n],
        "arc_challenge": [arc(i) for i in n],
        "boolq": [{"passage": text(30, 60) + ".", "question": text(4, 8),
                   "label": rnd.randint(0, 1)} for _ in n],
        "hellaswag": [{"activity_label": rnd.choice(["Cooking", "Running"]),
                       "ctx_a": text(8, 16) + " [title] then",
                       "ctx_b": text(2, 5),
                       "endings": [f"{text(4, 10)} [step] {j}"
                                   for j in range(4)],
                       "label": str(rnd.randint(0, 3))} for _ in n],
        "winogrande": [{"sentence": f"{text(4, 8)} _ {text(4, 8)}.",
                        "option1": text(1, 2), "option2": text(1, 2),
                        "answer": str(rnd.randint(1, 2))} for _ in n],
        "lambada_openai": [{"text": text(20, 40)} for _ in n],
        "mmlu": [{"question": text(6, 14) + "?",
                  "choices": [text(1, 3) for _ in range(4)],
                  "answer": rnd.randint(0, 3) if i % 2 else "ABCD"[i % 4]}
                 for i in n],
    }


def smoke_tasks(seed: int = 9) -> list:
    """The six-task suite, LAMBADA and one MMLU subject on
    :func:`task_raw_docs`."""
    from onebit_tpu_torch.eval.tasks import mmlu, suite
    raw = task_raw_docs(seed)
    return [suite.PIQA(raw["piqa"]), suite.ARCEasy(raw["arc_easy"]),
            suite.ARCChallenge(raw["arc_challenge"]),
            suite.BoolQ(raw["boolq"]),
            suite.HellaSwag(raw["hellaswag"]),
            suite.Winogrande(raw["winogrande"]),
            suite.Lambada(raw["lambada_openai"]),
            mmlu.MMLUSubject(raw["mmlu"], "college_mathematics")]


def _run_tasks(params, config, tasks, impl: str, shots: int,
               batch_size: int = TASK_BATCH, **kw) -> dict:
    """``evaluate_tasks`` with every count set to 0 just before it,
    recording each log-likelihood request with its result, the other
    requests as ``(type, payload, result)``, and each doc's results and
    metrics (the order both paths share: the seeded shuffle). ``kw`` goes
    to ``evaluate_tasks`` (``lm``, ``detokenize``, ``max_new_tokens``)."""
    from onebit_tpu_torch.eval.tasks import base
    requests, other, docs = [], [], []
    real = base._run_requests

    def run(p, c, rtype, payloads, *args, **kw):
        out = real(p, c, rtype, payloads, *args, **kw)
        if rtype == "loglikelihood":
            requests.extend(zip(payloads, out))
        else:
            other.extend((rtype, q, r) for q, r in zip(payloads, out))
        return out

    def recorder(task):
        real_process = task.process_results

        def process(doc, results):
            metrics = real_process(doc, results)
            docs.append((task.name, doc, list(results), metrics))
            return metrics
        return process

    base._run_requests = run
    for task in tasks:
        task.process_results = recorder(task)
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = base.evaluate_tasks(params, config, tasks, byte_tokenize,
                                      batch_size=batch_size, impl=impl,
                                      num_fewshot=shots, **kw)
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        base._run_requests = real
        for task in tasks:
            del task.process_results
    return {"results": results, "requests": requests, "other": other,
            "docs": docs, "seconds": seconds, "counts": counts}


def _choice_gap(doc, results, key: str) -> tuple:
    """The plain path's gap between a doc's two best choices (raw
    log-likelihoods for ``acc``, per byte of the choice for ``acc_norm``;
    a doc that is not multiple choice compares its requests' raw
    log-likelihoods) and the sum of those two log-likelihoods' EVAL_LL_TOL
    bounds: a gap under that sum is one the two paths may order either
    way."""
    lls = np.array([r[0] for r in results])
    scores = lls
    if key == "acc_norm":
        scores = lls / np.array([max(len(c), 1) for c in doc.choices])
    top = np.argsort(-scores)[:2]
    gap = float(scores[top[0]] - scores[top[1]])
    bound = float(sum(EVAL_LL_TOL * (1 + abs(lls[i])) for i in top))
    if key == "acc_norm":
        bound /= min(max(len(doc.choices[i]), 1) for i in top)
    return gap, bound


def _compare_task_runs(params, config, dev, auto: dict, plain: dict) -> dict:
    """Each request's log-likelihood within EVAL_LL_TOL x (1 + |ll|) of
    the plain run's, its greedy flag equal unless the plain path's top-2
    gap over its continuation is at most EVAL_GAP_TOL (:func:`_top2_gap`),
    and each doc's acc/acc_norm equal unless its two best choices lie
    within their log-likelihoods' bounds (:func:`_choice_gap`; LAMBADA's
    acc is its request's greedy flag)."""
    if [q for q, _ in auto["requests"]] != [q for q, _ in plain["requests"]]:
        raise RuntimeError("the two task runs sent different requests")
    lls = np.array([[a[0], b[0]] for (_, a), (_, b) in
                    zip(auto["requests"], plain["requests"])])
    err = np.abs(lls[:, 0] - lls[:, 1])
    ll_ok = bool((err <= EVAL_LL_TOL * (1 + np.abs(lls[:, 1]))).all())
    flips = {}
    for i, ((ctx, cont), a), (_, b) in zip(
            range(len(lls)), auto["requests"], plain["requests"]):
        if a[1] != b[1]:
            req = (byte_tokenize(ctx), byte_tokenize(cont))
            flips[i] = _top2_gap(params, config, dev, req)
    metric_flips = []
    for (name, doc, res_a, m_a), (_, _, res_p, m_p) in zip(auto["docs"],
                                                          plain["docs"]):
        if name in GREEDY_FLAG_TASKS or (res_p and isinstance(res_p[0],
                                                              str)):
            # acc is a request's greedy flag, held above; a generated
            # text is held by _compare_generations
            continue
        for key in ("acc", "acc_norm"):
            if key not in m_a or m_a[key] == m_p[key]:
                continue
            gap, bound = _choice_gap(doc, res_p, key)
            metric_flips.append({"task": name, "metric": key, "gap": gap,
                                 "bound": bound})
    ok = (ll_ok and all(g <= EVAL_GAP_TOL for g in flips.values())
          and all(f["gap"] <= f["bound"] for f in metric_flips))
    return {"requests": len(lls), "max_abs_err_vs_torch": float(err.max()),
            "max_rel_err_vs_torch": float(
                (err / (1 + np.abs(lls[:, 1]))).max()),
            "ll_tol": EVAL_LL_TOL, "greedy_flips": {
                str(i): g for i, g in flips.items()},
            "greedy_true": int(sum(a[1] for _, a in auto["requests"])),
            "metric_flips": metric_flips, "ok": ok}


def _divergence_gap(params, config, dev, prompt, plain, step) -> float:
    """The plain path's top-2 logit gap, relative to its largest |logit|,
    for the token at ``step`` after ``prompt`` (a bf16 forward with
    impl="torch" over the prompt and the plain tokens before it)."""
    from onebit_tpu_torch.model.bitllama import forward
    ids = torch.tensor(prompt + plain[:step], device=dev)[None]
    logits = forward(params, ids, config, impl="torch")[0, -1].float()
    top2 = logits.topk(2).values
    return ((top2[0] - top2[1]) / logits.abs().max()).item()


def _greedy_until_check(params, config, dev, tasks) -> None:
    """One ``greedy_until`` batch through the harness on the fused params:
    TASK_GEN_ROWS LAMBADA contexts, stop "\\n", TASK_GEN_NEW new tokens,
    every count set to 0 just before it: K1, K2 launched and B9 (bf16)
    exactly 32 x (TASK_GEN_NEW - 1) times. Its texts must be those of
    ``generate`` on the kernel path cut at the stop; against ``generate``
    with impl="torch", each row's tokens must be the same up to where the
    plain path's top-2 logits lie within LOGITS_REL_TOL of its largest
    |logit| (:func:`_divergence_gap`): the bf16 limit that holds the two
    paths' logits (:func:`_generate_first_step`), where 32 layers of bf16
    roundings at other places may pick the other token."""
    from onebit_tpu_torch import fuse_for_decode, generate
    from onebit_tpu_torch.eval.tasks import base
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    fused = fuse_for_decode(params, config)
    lam = next(t for t in tasks if t.name == "lambada_openai")
    payloads = [(lam.doc_to_text(d), ("\n",))
                for d in lam.docs()[:TASK_GEN_ROWS]]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    texts = base._run_requests(
        fused, config, "greedy_until", payloads, byte_tokenize,
        byte_detokenize, batch_size=8, impl="auto",
        compute_dtype=torch.float32, max_new_tokens=TASK_GEN_NEW)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    prompts = [byte_tokenize(ctx) for ctx, _ in payloads]
    kernel = generate(fused, config, prompts, max_new_tokens=TASK_GEN_NEW)
    plain = generate(fused, config, prompts, max_new_tokens=TASK_GEN_NEW,
                     impl="torch")
    want = [byte_detokenize(toks).split("\n")[0] for toks in kernel]
    parted = {}
    for r, (k, p) in enumerate(zip(kernel, plain)):
        step = next((i for i, (a, b) in enumerate(zip(k, p)) if a != b),
                    None)
        if step is not None:
            parted[r] = {"step": step, "gap": _divergence_gap(
                fused, config, dev, prompts[r], p, step)}
    del fused
    steps = config.num_hidden_layers * (TASK_GEN_NEW - 1)
    line = {"phase": "tasks_greedy_until", "rows": len(payloads),
            "new_tokens": TASK_GEN_NEW, "stop": "\\n",
            "prompt_lengths": [len(p) for p in prompts],
            "texts_equal_kernel_generate": texts == want,
            "texts_equal_plain": texts == [
                byte_detokenize(t).split("\n")[0] for t in plain],
            "parted_from_plain": {str(r): v for r, v in parted.items()},
            "gap_rel_tol": LOGITS_REL_TOL, "seconds": seconds,
            "launches": {k: v for k, v in counts.items() if v}}
    emit(line)
    if not (texts == want and counts[bc.SMALL_M.name]
            and counts[bc.FUSED_SMALL_M.name]
            and counts[kc.DECODE_BF16.name] == steps
            and all(v["gap"] <= LOGITS_REL_TOL for v in parted.values())):
        raise RuntimeError(f"greedy_until: texts differ from generate's, "
                           f"K1/K2 never launched, B9 (bf16) not {steps} "
                           f"times, or a row parts from impl='torch' away "
                           f"from a near-tie: {line}")


def tasks_checks(params, config, dev) -> None:
    """The zero-shot task harness on the unfused full-depth llama2-7b
    params of :func:`eval_checks`, the byte tokenizer, synthetic docs of
    each suite task and an MMLU subject (:func:`smoke_tasks`):

    (a) ``evaluate_tasks`` zero-shot on the kernel path and with
        impl="torch", then TASK_FEWSHOT again with one shot, each held by
        :func:`_compare_task_runs`; fp32 padded batches, so K3 fp32
        launches and B11 never; impl="torch" launches nothing;
    (b) one ``greedy_until`` batch (:func:`_greedy_until_check`).

    Prints the kernel path's ``make_table``."""
    from onebit_tpu_torch.eval.tasks.base import make_table
    from onebit_tpu_torch.kernels import attention_cuda as fc
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    t_phase = time.perf_counter()
    tasks = smoke_tasks()
    for shots, chosen in ((0, tasks), (1, [t for t in tasks
                                           if t.name == TASK_FEWSHOT])):
        runs = {impl: _run_tasks(params, config, chosen, impl, shots)
                for impl in ("auto", "torch")}
        cmp = _compare_task_runs(params, config, dev, runs["auto"],
                                 runs["torch"])
        k = runs["auto"]["counts"]
        line = {"phase": "tasks", "num_fewshot": shots,
                "tasks": [t.name for t in chosen], "docs_per_task":
                TASK_DOCS, "batch_size": TASK_BATCH, "dtype": "float32",
                **cmp, "results": runs["auto"]["results"],
                "results_torch": runs["torch"]["results"],
                "seconds": runs["auto"]["seconds"],
                "seconds_torch": runs["torch"]["seconds"],
                "launches": {n: v for n, v in k.items() if v}}
        emit(line)
        if shots == 0:
            print(make_table(runs["auto"]["results"]), flush=True)
        if not cmp["ok"] or k[bc.LARGE_M_F32.name] == 0 or \
                any(k[f.name] for f in fc.KERNELS) or \
                any(runs["torch"]["counts"].values()):
            raise RuntimeError(f"the task harness disagrees with "
                               f"impl='torch', or launched other kernels "
                               f"than K3 fp32: {line}")
    _greedy_until_check(params, config, dev, tasks)
    emit({"phase": "tasks_done", "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# phase 7b: the task registry, the janitor's C core and text requests
# ---------------------------------------------------------------------------

REGISTRY_DOCS = 4          # docs a task
REGISTRY_BATCH = 4         # the eval command line's --batch-size
REGISTRY_NEW = 16          # new tokens a greedy-until request
REGISTRY_TASKS = ("rte", "copa", "openbookqa", "triviaqa", "gsm8k",
                  "math_algebra", "blimp_causative", "pile_github",
                  "arithmetic_2da", "lambada_standard_cloze", "wikitext")
# packages the card's machine may lack, which this phase must not import
NOT_ON_THE_CARD = ("transformers", "sklearn", "sacrebleu", "zstandard")


class ByteTokenizer:
    """:func:`byte_tokenize` behind a Hugging Face tokenizer's surface:
    ``tok(text)["input_ids"]`` and ``tok.decode(ids)``."""

    def __call__(self, text: str) -> dict:
        return {"input_ids": byte_tokenize(text)}

    def decode(self, tokens) -> str:
        return byte_detokenize(tokens)


def registry_raw_docs(seed: int = 13) -> dict:
    """REGISTRY_DOCS raw rows of each of REGISTRY_TASKS in its published
    schema, from ``random.Random(seed)``."""
    import random
    rnd = random.Random(seed)

    def text(lo, hi):
        return " ".join(rnd.choice(TASK_WORDS)
                        for _ in range(rnd.randint(lo, hi)))

    def doc(name, i):
        a, b = rnd.randint(2, 40), rnd.randint(2, 40)
        if name == "rte":
            return {"sentence1": text(8, 16) + ".",
                    "sentence2": text(4, 8), "label": rnd.randint(0, 1)}
        if name == "copa":
            return {"premise": text(6, 12) + ".",
                    "question": ("cause", "effect")[i % 2],
                    "choice1": "The " + text(3, 6) + ".",
                    "choice2": "A " + text(3, 6) + ".",
                    "label": rnd.randint(0, 1)}
        if name == "openbookqa":
            return {"question_stem": text(6, 12),
                    "choices": {"text": [text(1, 4) for _ in range(4)]},
                    "answerKey": rnd.choice("ABCD")}
        if name == "triviaqa":
            w = rnd.choice(TASK_WORDS)
            return {"question": text(6, 12) + "?", "answer": {
                "value": w, "aliases": [w, w + " " + rnd.choice(TASK_WORDS),
                                        text(1, 2)]}}
        if name == "gsm8k":
            return {"question": f"{text(4, 8)} has {a} and gets {b} more. "
                                "How many now?",
                    "answer": f"{a} + {b} = {a + b}\n#### {a + b}"}
        if name == "math_algebra":
            return {"problem": f"Solve for x: x - {a} = {b}.",
                    "solution": f"So $x = \\boxed{{{a + b}}}$."}
        if name == "blimp_causative":
            return {"sentence_good": text(5, 10) + ".",
                    "sentence_bad": text(5, 10) + "."}
        if name == "arithmetic_2da":
            return {"context": f"Question: What is {a} plus {b}?\nAnswer:",
                    "completion": f" {a + b}"}
        if name == "lambada_standard_cloze":
            return {"text": text(20, 40)}
        if name == "wikitext":
            return (f" = {text(1, 3)} = \n {text(30, 60)} @-@ "
                    f"{text(10, 20)} . \n")
        return text(40, 80)            # pile_github: a raw document
    return {name: [doc(name, i) for i in range(REGISTRY_DOCS)]
            for name in REGISTRY_TASKS}


def registry_tasks(seed: int = 13) -> list:
    """REGISTRY_TASKS, each built by its registry name on
    :func:`registry_raw_docs`."""
    from onebit_tpu_torch.eval.tasks.registry import TASK_REGISTRY
    raw = registry_raw_docs(seed)
    return [TASK_REGISTRY[name](raw[name]) for name in REGISTRY_TASKS]


def _compare_generations(params, config, dev, auto: dict, plain: dict) -> dict:
    """The generated texts of two task runs: for each task's batch of
    greedy-until requests, the kernel run's texts must be ``generate``'s
    on the kernel path cut at the stops, the plain run's those of
    ``generate`` with impl="torch", and where the two parted, the plain
    path's top-2 logits must lie within LOGITS_REL_TOL of its largest
    |logit| at the first parting token (:func:`_divergence_gap`)."""
    from onebit_tpu_torch import generate

    def cut(tokens, stops):
        text = byte_detokenize(tokens)
        for stop in stops:
            idx = text.find(stop)
            if idx >= 0:
                text = text[:idx]
        return text

    def batches(run):
        reqs = [(q, r) for t, q, r in run["other"] if t == "greedy_until"]
        return [reqs[i:i + REGISTRY_BATCH]
                for i in range(0, len(reqs), REGISTRY_BATCH)]
    out = {"requests": 0, "texts_equal_generate": True, "parted": []}
    for got_a, got_p in zip(batches(auto), batches(plain)):
        prompts = [byte_tokenize(ctx) for (ctx, _), _ in got_a]
        if [q for q, _ in got_a] != [q for q, _ in got_p]:
            raise RuntimeError("the two task runs generated for different "
                               "requests")
        kernel = generate(params, config, prompts,
                          max_new_tokens=REGISTRY_NEW)
        ref = generate(params, config, prompts, max_new_tokens=REGISTRY_NEW,
                       impl="torch")
        out["requests"] += len(prompts)
        out["texts_equal_generate"] &= (
            [r for _, r in got_a] == [cut(k, q[1])
                                      for k, (q, _) in zip(kernel, got_a)]
            and [r for _, r in got_p] == [cut(k, q[1]) for k, (q, _)
                                          in zip(ref, got_p)])
        for r, (k, p) in enumerate(zip(kernel, ref)):
            step = next((i for i, (a, b) in enumerate(zip(k, p)) if a != b),
                        None)
            if step is not None:
                out["parted"].append({"prompt_len": len(prompts[r]),
                                      "step": step, "gap": _divergence_gap(
                                          params, config, dev, prompts[r], p,
                                          step)})
    out["ok"] = (out["texts_equal_generate"] and out["requests"] > 0
                 and all(v["gap"] <= LOGITS_REL_TOL for v in out["parted"]))
    return out


def _compare_rolling(auto: dict, plain: dict) -> dict:
    """Each rolling log-likelihood within EVAL_LL_TOL x (1 + |ll|) of the
    plain run's."""
    a = [(q, r) for t, q, r in auto["other"] if t == "loglikelihood_rolling"]
    p = [(q, r) for t, q, r in plain["other"]
         if t == "loglikelihood_rolling"]
    if [q for q, _ in a] != [q for q, _ in p] or not a:
        raise RuntimeError("the two task runs scored different documents")
    lls = np.array([[x, y] for (_, x), (_, y) in zip(a, p)])
    err = np.abs(lls[:, 0] - lls[:, 1])
    return {"documents": len(lls), "max_abs_err_vs_torch": float(err.max()),
            "ok": bool((err <= EVAL_LL_TOL * (1 + np.abs(lls[:, 1]))).all())}


def _janitor_core_check() -> dict:
    """The janitor's C core built on this machine (``build/decontam/``):
    its n-grams and spans against the Python scan's on the registry docs'
    texts and the 13-gram contamination of a training text holding two of
    them."""
    from onebit_tpu_torch.tools.decontam import janitor
    t0 = time.perf_counter()
    native = janitor.Janitor()
    build_s = time.perf_counter() - t0
    python = janitor.Janitor(use_native=False)
    texts = [json.dumps(d) for docs in registry_raw_docs().values()
             for d in docs]
    same = all(native._ngrams_with_indices(t) == python._ngrams_with_indices(t)
               for t in texts)
    for j in (native, python):
        j.register_contaminant(" ".join(texts[:2]))
    counts = [[j.contamination_count(t) for t in texts]
              for j in (native, python)]
    line = {"phase": "janitor_core", "native": native.native,
            "library": str(janitor.core_path().relative_to(ROOT)),
            "build_s": build_s, "texts": len(texts),
            "ngrams_equal_python": same,
            "contaminated": sum(c > 0 for c in counts[0]),
            "counts_equal_python": counts[0] == counts[1]}
    emit(line)
    if not (native.native and same and counts[0] == counts[1]
            and line["contaminated"] >= 2):
        raise RuntimeError(f"the janitor's C core disagrees with the "
                           f"Python scan: {line}")
    return line


def _server_text_check(params, config, dev) -> dict:
    """One ``{"text": ...}`` request, sync and streamed, to an
    ``EngineServer`` holding :class:`ByteTokenizer` on a dense engine of
    the fused weights: the tokens of the ``{"prompt": ...}`` request of
    the text's bytes, and their decoding beside them."""
    import urllib.request
    from onebit_tpu_torch import ContinuousBatchingEngine
    from onebit_tpu_torch.engine.sampler import SamplingConfig
    from onebit_tpu_torch.engine.server import EngineServer
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    eng = ContinuousBatchingEngine(
        params, config, max_batch=2, max_len=256,
        sampling=SamplingConfig(greedy=True), device=dev)
    server = EngineServer(eng, tokenizer=ByteTokenizer())
    port = server.start(port=0)
    text = "the quick brown fox jumps over the lazy dog tonight"

    def post(body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps(dict(body, max_new_tokens=SERVE_NEW)).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read().decode()
    try:
        by_ids = json.loads(post({"prompt": byte_tokenize(text)}))
        reset_counts()
        t0 = time.perf_counter()
        by_text = json.loads(post({"text": text}))
        seconds = time.perf_counter() - t0
        counts = read_counts()
        streamed = [json.loads(x) for x in post({"text": text,
                                                 "stream": True}).split("\n")
                    if x]
    finally:
        server.stop()
    line = {"phase": "server_text", "prompt_bytes": len(text),
            "new_tokens": len(by_text["tokens"]), "seconds": seconds,
            "equal_prompt_request": by_text == by_ids,
            "text_is_decoding": by_text.get("text") == byte_detokenize(
                by_text["tokens"]),
            "stream_equal": streamed[-1] == {"done": True, **by_text}
            and [x["token"] for x in streamed[:-1]] == by_text["tokens"],
            "launches": {k: v for k, v in counts.items() if v}}
    emit(line)
    if not (line["equal_prompt_request"] and line["text_is_decoding"]
            and line["stream_equal"] and by_text["tokens"]
            and counts[kc.DECODE_BF16.name]):
        raise RuntimeError(f"a text request to EngineServer: {line}")
    return line


def registry_checks(params, config, dev) -> None:
    """The task registry on the full-depth llama2-7b weights of
    :func:`tasks_checks`, fused for decode, in the byte tokenizer:

    (a) the registry's names, and REGISTRY_TASKS (one task of each new
        module whose metric needs no package beyond numpy) on
        :func:`registry_raw_docs`, zero-shot at batch REGISTRY_BATCH with
        REGISTRY_NEW new tokens a greedy request, on the kernel path and
        with impl="torch": log-likelihoods and greedy flags
        (:func:`_compare_task_runs`), rolling sums
        (:func:`_compare_rolling`) and texts (:func:`_compare_generations`);
        K3 fp32, K1, K2 and B9 (bf16) launched on the kernel path, nothing
        with impl="torch";
    (b) the same through ``lm=NativeLM(...)``: the kernel path's results,
        requests and per-doc metrics exactly;
    (c) the janitor's C core (:func:`_janitor_core_check`);
    (d) a text request to ``EngineServer`` (:func:`_server_text_check`);

    and none of NOT_ON_THE_CARD imported by this process."""
    from onebit_tpu_torch import fuse_for_decode
    from onebit_tpu_torch.eval.adapters import NativeLM
    from onebit_tpu_torch.eval.tasks.base import make_table
    from onebit_tpu_torch.eval.tasks.registry import ALL_TASKS
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    t_phase = time.perf_counter()
    fused = fuse_for_decode(params, config)
    kw = dict(batch_size=REGISTRY_BATCH, detokenize=byte_detokenize,
              max_new_tokens=REGISTRY_NEW)
    runs = {impl: _run_tasks(fused, config, registry_tasks(), impl, 0, **kw)
            for impl in ("auto", "torch")}
    runs["native_lm"] = _run_tasks(
        None, None, registry_tasks(), "auto", 0,
        lm=NativeLM(fused, config, batch_size=REGISTRY_BATCH), **kw)
    cmp = _compare_task_runs(fused, config, dev, runs["auto"], runs["torch"])
    rolling = _compare_rolling(runs["auto"], runs["torch"])
    texts = _compare_generations(fused, config, dev, runs["auto"],
                                 runs["torch"])
    auto, native = runs["auto"], runs["native_lm"]
    native_equal = (native["results"] == auto["results"]
                    and native["requests"] == auto["requests"]
                    and native["other"] == auto["other"]
                    and [m for *_, m in native["docs"]]
                    == [m for *_, m in auto["docs"]])
    k = auto["counts"]
    need = (bc.LARGE_M_F32, bc.SMALL_M, bc.FUSED_SMALL_M, kc.DECODE_BF16)
    line = {"phase": "registry", "registry_names": len(ALL_TASKS),
            "tasks": list(REGISTRY_TASKS), "docs_per_task": REGISTRY_DOCS,
            "batch_size": REGISTRY_BATCH, "new_tokens": REGISTRY_NEW,
            "loglikelihood": cmp, "rolling": rolling, "greedy_until": texts,
            "native_lm_equal": native_equal,
            "results": auto["results"],
            "results_torch": runs["torch"]["results"],
            "seconds": auto["seconds"],
            "seconds_torch": runs["torch"]["seconds"],
            "seconds_native_lm": native["seconds"],
            "launches": {n: v for n, v in k.items() if v},
            "launches_native_lm": {n: v for n, v in native["counts"].items()
                                   if v}}
    emit(line)
    print(make_table(auto["results"]), flush=True)
    if not (len(ALL_TASKS) == 297 and cmp["ok"] and rolling["ok"]
            and texts["ok"] and native_equal
            and all(k[n.name] for n in need)
            and not any(runs["torch"]["counts"].values())):
        raise RuntimeError(f"the task registry disagrees with "
                           f"impl='torch' or with NativeLM, or K3 fp32, K1, "
                           f"K2 or B9 never launched: {line}")
    _janitor_core_check()
    _server_text_check(fused, config, dev)
    del fused
    torch.cuda.empty_cache()
    imported = [m for m in NOT_ON_THE_CARD if m in sys.modules]
    emit({"phase": "registry_done", "seconds": time.perf_counter() - t_phase,
          "not_to_import": NOT_ON_THE_CARD, "imported": imported,
          "device": nvidia_smi_line()})
    if imported:
        raise RuntimeError(f"the registry phase imported {imported}")


# ---------------------------------------------------------------------------
# phase 8: SFT at llama2-7b width, TRAIN_LAYERS layers
# ---------------------------------------------------------------------------

SFT_PAIRS, SFT_CUTOFF, SFT_BATCH, SFT_STEPS = 16, 512, 4, 3
SFT_TEMPLATE = "alpaca"
SFT_PREDICT, SFT_NEW = 4, 16     # prompts and new tokens of save_predictions
SFT_REL_TOL = 1e-3


def sft_pairs(seed: int = 12) -> list:
    """SFT_PAIRS (prompt, response) pairs of 60-420 and 30-300 bytes:
    with the alpaca template the longest rows pass SFT_CUTOFF tokens."""
    import random
    rnd = random.Random(seed)

    def text(lo, hi):
        return " ".join(rnd.choice(TASK_WORDS)
                        for _ in range(rnd.randint(lo, hi)))
    return [(text(12, 80), text(6, 60)) for _ in range(SFT_PAIRS)]


def sft_checks(dev) -> None:
    """SFT at llama2-7b width, TRAIN_LAYERS layers, on the SVID start
    student of :func:`_train_setup` (no teacher):

    (a) ``run_sft`` of :func:`sft_pairs` in the byte tokenizer (alpaca
        template, cutoff 512, batch 4, bf16, warmup 1), SFT_STEPS with
        impl="torch", then on the kernel path: finite losses,
        the first step's loss and grad norm within SFT_REL_TOL of
        impl="torch"'s; each step's ms and the peak memory; B11 never
        launches (padded batches take the plain masked attention);
    (b) ``save_predictions`` of the trained student, packed and fused, on
        SFT_PREDICT templated prompts, SFT_NEW new tokens, every count set
        to 0 just before it: K1, K2 launched, B9 (bf16) exactly
        TRAIN_LAYERS x (SFT_NEW - 1) times; 4 jsonl rows and the four
        metrics in ``predict_results.json``.

    Its files (under ``build/smoke_sft``) are removed after."""
    import shutil

    from onebit_tpu_torch import (fuse_for_decode, pack_model_params,
                                  run_sft, save_predictions)
    from onebit_tpu_torch.kernels import attention_cuda as fc
    from onebit_tpu_torch.kernels import bitlinear_cuda as bc
    from onebit_tpu_torch.kernels import kv_attention_cuda as kc
    from onebit_tpu_torch.train import run_sft as sft_mod
    from onebit_tpu_torch.train.data import TEMPLATES
    from onebit_tpu_torch.train.run_kd import KDRunConfig
    from onebit_tpu_torch.train.trainer import TrainConfig
    t_phase = time.perf_counter()
    config, teacher, student, _, _, _ = _train_setup(dev)
    del teacher
    torch.cuda.empty_cache()
    pairs = sft_pairs()
    root = os.path.join(ROOT, "build", "smoke_sft")
    shutil.rmtree(root, ignore_errors=True)
    step_s = []
    real_make = sft_mod.make_train_step

    def timed_make(*args, **kw):
        step = real_make(*args, **kw)

        def timed(state, teacher_params, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, teacher_params, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            return out
        return timed

    logs, counts = {}, {}
    sft_mod.make_train_step = timed_make
    try:
        for impl in ("torch", "auto"):
            step_s.clear()
            out = os.path.join(root, impl)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            state = run_sft(
                config, student, pairs, byte_tokenize,
                cutoff_len=SFT_CUTOFF, template=SFT_TEMPLATE,
                train_cfg=TrainConfig(warmup_steps=1),
                run_cfg=KDRunConfig(output_dir=out, batch_size=SFT_BATCH,
                                    max_steps=SFT_STEPS, log_steps=1,
                                    plot=False), impl=impl)
            counts[impl] = read_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            with open(os.path.join(out, "trainer_log.jsonl")) as f:
                logs[impl] = [json.loads(line) for line in f]
            if impl == "torch":
                del state
                torch.cuda.empty_cache()
    finally:
        sft_mod.make_train_step = real_make
    first, ref = logs["auto"][0], logs["torch"][0]
    rel = {k: abs(first[k] - ref[k]) / abs(ref[k])
           for k in ("loss", "grad_norm")}
    losses = [e["loss"] for e in logs["auto"]]
    line = {"phase": "sft", "config": "llama2-7b", "layers": TRAIN_LAYERS,
            "pairs": len(pairs), "cutoff_len": SFT_CUTOFF,
            "template": SFT_TEMPLATE, "batch": SFT_BATCH, "dtype": "bfloat16",
            "steps": SFT_STEPS, "losses": losses,
            "grad_norms": [e["grad_norm"] for e in logs["auto"]],
            "first_step_rel_err_vs_torch": rel, "rel_tol": SFT_REL_TOL,
            "step_ms": [s * 1e3 for s in step_s], "peak_mem_gb": peak_gb,
            "device": nvidia_smi_line(),
            "launches": {k: v for k, v in counts["auto"].items() if v}}
    emit(line)
    if not (all(math.isfinite(v) for v in losses) and len(losses) == SFT_STEPS
            and max(rel.values()) <= SFT_REL_TOL
            and not any(counts["auto"][f.name] for f in fc.KERNELS)
            and not any(counts["torch"].values())):
        raise RuntimeError(f"SFT: non-finite losses, a first step off "
                           f"impl='torch', or B11 launched: {line}")

    # (b) greedy predictions of the trained student, packed and fused
    params = fuse_for_decode(pack_model_params(state.params), config)
    del state, student
    torch.cuda.empty_cache()
    prompts = [TEMPLATES[SFT_TEMPLATE](p) for p, _ in pairs[:SFT_PREDICT]]
    labels = [r for _, r in pairs[:SFT_PREDICT]]
    out = os.path.join(root, "predict")
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        path = save_predictions(out, params, config, prompts, labels,
                                byte_tokenize, byte_detokenize,
                                max_new_tokens=SFT_NEW)
        seconds = time.perf_counter() - t0
        k = read_counts()
        with open(path, encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(out, "predict_results.json")) as f:
            metrics = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = TRAIN_LAYERS * (SFT_NEW - 1)
    line = {"phase": "sft_predictions", "prompts": len(prompts),
            "prompt_lengths": [len(byte_tokenize(p)) for p in prompts],
            "new_tokens": SFT_NEW, "rows": len(rows), "metrics": metrics,
            "seconds": seconds, "launches": {n: v for n, v in k.items() if v},
            "phase_seconds": time.perf_counter() - t_phase}
    emit(line)
    if not (len(rows) == len(prompts) and all(set(r) == {"label", "predict"}
                                              for r in rows)
            and sorted(metrics) == ["bleu-4", "rouge-1", "rouge-2", "rouge-l"]
            and k[bc.SMALL_M.name] and k[bc.FUSED_SMALL_M.name]
            and k[kc.DECODE_BF16.name] == want):
        raise RuntimeError(f"save_predictions: rows, metrics, or K1/K2/B9 "
                           f"({want}) launches: {line}")


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
    launches, graph_launches, parallel = end_to_end(dev)
    emit({"phase": "done", "wall_s": time.perf_counter() - t_wall,
          "graph_launches_of": "the block run (8 steps a replayed CUDA "
                               "graph) of the kernel's served path; "
                               "launches: its eager path's"})
    emit({"kernels": [
        {"name": k.name, "route": k.route, "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "graph_launches": graph_launches[k.name],
         **results[k.name],
         **({"launches_of": "rank 0 of the dense tensor-parallel run"}
            if k.name.startswith("bitlinear_raw") else {}),
         **{key: counts[k.name] for key, counts in parallel.items()
            if k.name in counts}}
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
