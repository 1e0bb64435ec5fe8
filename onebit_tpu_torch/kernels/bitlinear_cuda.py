"""The packed OneBit linear as hand-written CUDA kernels, each beside its
plain PyTorch version.

Port of ``onebit_tpu/kernels/bitlinear_pallas.py``. Three kernels, sources in
``onebit_tpu_torch/csrc/`` (each source's header says what bounds it):

* K1 :func:`small_m`, for one projection at M <= 128 rows (o_proj, down_proj,
  and q/k/v when they are not fused);
* K2 :func:`fused_small_m`, for ``ns`` projections sharing x at M <= 128
  (q/k/v and gate/up after ``fuse_for_decode``); K1 and K2 are one kernel
  on the tensor cores (mma.sync), its LayerNorm in the same launch, split
  over k by :func:`small_m_plan`;
* K3 :func:`large_m`, for M > 128 rows (prefill, and every projection of
  an fp32 eval window), single or fused, on the tensor cores (wgmma on a
  ±1 bf16 tile; the fp32 instance in three bf16 passes,
  :func:`split_bf16x3`); its launches are counted per dtype instance (bf16
  ``bitlinear_large_m``, fp32 ``bitlinear_large_m_f32``);
* B4, the raw projection of a tensor-parallel shard
  (``bitlinear_packed_raw_stacked`` / ``bitlinear_packed_raw``): K1 and K3
  with ``raw=True``, which skip the LayerNorm. Their launches are
  counted as B4's two instances, ``bitlinear_raw_small_m`` (M <= 128, fp32
  out) and ``bitlinear_raw_large_m`` (M > 128, z in x's dtype), never under
  K1 or K3.

Every kernel computes ``LayerNorm(((x ⊙ g_j) · S_jᵀ) ⊙ h_j) (+ bias)`` per
segment ``j``, with the signs in the port's K-major layout
(``core/packing.py``), and each LayerNorm runs over the segment's true width
``n_true``, never over pad columns. ``raw=True`` returns the projection
before the LayerNorm (B4).

A wrapper given CPU tensors returns its plain version (the reference's
strategy: unpack to a dense ±1 matrix, then matmul). Given CUDA tensors it
launches its kernel or raises; there is no fallback. Each wrapper counts its
launches in ``KernelInfo.launches``.

The small-M kernel keeps ticket counters per device (:func:`counters`),
which every launch leaves at zero: two streams must not run it at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from onebit_tpu_torch.core.bitlinear import LN_EPS
from onebit_tpu_torch.core.packing import WORD_BITS, unpack_signs_kmajor
from onebit_tpu_torch.kernels import build

SMALL_M_MAX = 128   # rows; above it prefill takes K3 (bitlinear_pallas.py:51)
_SEG_ALIGN = 64     # fused segments: a multiple of both kernels' column tile
SMALL_M_ROWS = 8        # rows of x a small-M CTA owns: the MMA's N
SMALL_M_WORDS = 64      # word rows (of 32 k) a small-M CTA stages, at most
SMALL_M_MAX_WORDS = 128  # ... unless K needs more (up to K = 32768)
SMALL_M_MAX_SPLITS = 8  # splits of K: one portable thread-block cluster
SMALL_M_CTAS_PER_SM = 1.5  # the grid the small-M plan aims at
SMALL_M_NORMALIZERS = 8  # CTAs that normalise a (row block, segment)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass
class KernelInfo:
    name: str
    source: str      # path in the repository
    replaces: str    # file:line of the Pallas kernel it ports
    library: str     # source file under csrc/
    route: str = "cuda"
    launches: int = 0
    # of ``launches``, those that CUDA graph replays made: the wrapper runs
    # once, at capture, and each replay launches what it recorded
    # (``engine/block_graph.py``)
    graph_launches: int = 0


SMALL_M = KernelInfo(
    "bitlinear_small_m", "onebit_tpu_torch/csrc/bitlinear_small_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:347", "bitlinear_small_m.cu")
FUSED_SMALL_M = KernelInfo(
    "bitlinear_fused_small_m", "onebit_tpu_torch/csrc/bitlinear_small_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:514", "bitlinear_small_m.cu")
LARGE_M = KernelInfo(
    "bitlinear_large_m", "onebit_tpu_torch/csrc/bitlinear_large_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:608", "bitlinear_large_m.cu")
LARGE_M_F32 = KernelInfo(
    "bitlinear_large_m_f32", "onebit_tpu_torch/csrc/bitlinear_large_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:608", "bitlinear_large_m.cu")
RAW_SMALL_M = KernelInfo(
    "bitlinear_raw_small_m", "onebit_tpu_torch/csrc/bitlinear_small_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:691", "bitlinear_small_m.cu")
RAW_LARGE_M = KernelInfo(
    "bitlinear_raw_large_m", "onebit_tpu_torch/csrc/bitlinear_large_m.cu",
    "onebit_tpu/kernels/bitlinear_pallas.py:691", "bitlinear_large_m.cu")
KERNELS = (SMALL_M, FUSED_SMALL_M, LARGE_M, LARGE_M_F32, RAW_SMALL_M,
           RAW_LARGE_M)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = k.graph_launches = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _project_torch(x2, packed, g, h, seg_pad: int) -> torch.Tensor:
    """fp32 ``z [M, N]``: segment j's columns use ``y_j = x ⊙ g[j]`` rounded
    to x.dtype; the dot accumulates in fp32."""
    sign = unpack_signs_kmajor(packed, dtype=torch.float32)     # [N, K]
    n = packed.shape[-1]
    z = torch.empty((x2.shape[0], n), dtype=torch.float32, device=x2.device)
    for j in range(g.shape[0]):
        cols = slice(j * seg_pad, min((j + 1) * seg_pad, n))
        y = (x2 * g[j]).float()
        z[:, cols] = y @ sign[cols].T
    return z * h


def _layernorm_segments_torch(z, bias, ns: int, seg_pad: int, n_true: int,
                              eps: float, dtype) -> torch.Tensor:
    """Two-pass fp32 row LayerNorm per segment -> ``[ns, M, n_true]``."""
    outs = []
    for j in range(ns):
        a = z[:, j * seg_pad:j * seg_pad + n_true].float()
        mean = a.mean(-1, keepdim=True)
        var = (a - mean).square().mean(-1, keepdim=True)
        r = (a - mean) * torch.rsqrt(var + eps)
        if bias is not None:
            r = r + bias
        outs.append(r.to(dtype))
    return torch.stack(outs)


def split_bf16x3(y: torch.Tensor):
    """The fp32 instance of K3's split of fp32 ``y = x ⊙ g`` into three bf16
    parts, ``hi = bf16(y)``, ``mid = bf16(y - hi)``, ``lo = bf16(y - hi -
    mid)``, as the kernel forms them in registers: together 24 mantissa
    bits, so ``hi + mid + lo == y`` wherever y's exponent leaves room for
    the parts (not near fp32's underflow). Each part's product with a ±1
    sign is exact, and the kernel sums the three products in fp32. A plain
    mirror of the kernel's arithmetic for the CPU tests; no path calls it."""
    hi = y.to(torch.bfloat16)
    r = y - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def large_m_block_n(n: int, ns: int) -> int:
    """K3's column tile for ``ns`` segments over ``n`` columns, and the
    small-M kernel's (:func:`small_m_plan`): 128, or 64 where fused
    segments are not a multiple of 128, since a tile must not straddle a
    segment (its A operand depends on the segment's g). K3's launch applies
    the same rule (``block_n`` in ``csrc/bitlinear_large_m.cu``)."""
    return 128 if ns == 1 or (n // ns) % 128 == 0 else 64


@functools.lru_cache(maxsize=256)
def small_m_plan(m: int, k: int, n: int, ns: int,
                 sm_count: int = 132) -> tuple:
    """``(block_n, splits, kw, normalizers)`` of the small-M kernel's
    launch. Column tiles of ``block_n`` (:func:`large_m_block_n`'s rule);
    the K/32 word rows cut into
    ``splits`` of ``kw`` (the last one shorter), so that tiles x splits x
    row blocks of 8 come to about ``SMALL_M_CTAS_PER_SM`` CTAs an SM (every
    weight byte in flight in one wave), with at least 4 and at most
    ``SMALL_M_WORDS`` word rows a split where K allows, and at most
    ``SMALL_M_MAX_SPLITS`` splits, the CTAs of one cluster (the choices
    measured best by ``scripts/torch_small_m_probe.py`` over the llama2-7b
    decode shapes, within its spread). The last
    ``normalizers`` column tiles of a (row block, segment) to finish
    normalise it, a slice each; they wait for the segment's other tiles,
    so all of them together stay under a quarter of the SMs. The wrapper
    passes the plan to the kernel, which checks it."""
    row_blocks = -(-m // SMALL_M_ROWS)
    block_n = large_m_block_n(n, ns)
    tiles = -(-n // block_n) * row_blocks
    nw = k // WORD_BITS
    splits = min(round(SMALL_M_CTAS_PER_SM * sm_count / tiles), -(-nw // 4),
                 SMALL_M_MAX_SPLITS)
    splits = min(max(splits, -(-nw // SMALL_M_WORDS), 1), SMALL_M_MAX_SPLITS)
    kw = -(-nw // splits)
    if kw > SMALL_M_MAX_WORDS:
        raise ValueError(f"K = {k} is past the small-M kernel's "
                         f"{SMALL_M_MAX_SPLITS * SMALL_M_MAX_WORDS * 32}")
    seg_tiles = -(-(n // ns) // block_n)
    normalizers = min(seg_tiles, SMALL_M_NORMALIZERS,
                      max(1, sm_count // (4 * row_blocks * ns)))
    return block_n, -(-nw // kw), kw, normalizers


def small_m_emulation(x2, packed, g, h, bias=None, *, n_true: int,
                      raw: bool = False, sm_count: int = 132,
                      eps: float = LN_EPS) -> torch.Tensor:
    """The small-M kernel's arithmetic on the CPU, step by step: y = x ⊙ g
    rounded to x's dtype (fp32 y as its three bf16 parts), each split's
    fp32 partial over its ``kw`` word rows, the partials summed in split
    order, ``z ⊙ h``; then per (row, segment) the tiles' sums and squared
    deviations about their own means, combined in tile order into the
    mean and variance (biased, over ``n_true``), + bias, cast. Returns what
    :func:`fused_small_m` returns (``[ns, M, n_true]``; raw: fp32 ``[M,
    N]``). A plain mirror for the CPU tests; no path calls it."""
    m, k = x2.shape
    ns, n = g.shape[0], packed.shape[-1]
    seg_pad = n // ns
    block_n, splits, kw, _ = small_m_plan(m, k, n, ns, sm_count)
    sign = unpack_signs_kmajor(packed, dtype=torch.float32)     # [N, K]
    z = torch.zeros((m, n), dtype=torch.float32)
    for j in range(ns):
        cols = slice(j * seg_pad, (j + 1) * seg_pad)
        y = (x2 * g[j]).float()
        parts = split_bf16x3(y) if x2.dtype == torch.float32 else (y,)
        for s in range(splits):
            ks = slice(s * kw * WORD_BITS, min((s + 1) * kw, k // WORD_BITS)
                       * WORD_BITS)
            z[:, cols] += sum(p[:, ks].float() @ sign[cols, ks].T
                              for p in parts)
    z = z * h
    if raw:
        return z
    outs = []
    for j in range(ns):
        a = z[:, j * seg_pad:j * seg_pad + n_true]
        tiles = a.split(block_n, dim=-1)
        sums = torch.stack([t.sum(-1) for t in tiles], -1)
        cnt = torch.tensor([t.shape[-1] for t in tiles], dtype=torch.float32)
        m2 = torch.stack([(t - t.mean(-1, keepdim=True)).square().sum(-1)
                          for t in tiles], -1)
        mean = sums.sum(-1, keepdim=True) / n_true
        var = (m2 + cnt * (sums / cnt - mean).square()).sum(
            -1, keepdim=True) / n_true
        r = (a - mean) * torch.rsqrt(var + eps)
        if bias is not None:
            r = r + bias[:n_true]
        outs.append(r.to(x2.dtype))
    return torch.stack(outs)


def small_m_torch(x2, packed, g, h, bias=None, *, raw: bool = False,
                  eps: float = LN_EPS) -> torch.Tensor:
    n = packed.shape[-1]
    z = _project_torch(x2, packed, g[None], h, n)
    if raw:
        return z
    return _layernorm_segments_torch(z, bias, 1, n, n, eps, x2.dtype)[0]


def fused_small_m_torch(x2, packed, g, h, *, n_true: int,
                        eps: float = LN_EPS) -> torch.Tensor:
    ns = g.shape[0]
    seg_pad = packed.shape[-1] // ns
    z = _project_torch(x2, packed, g, h, seg_pad)
    return _layernorm_segments_torch(z, None, ns, seg_pad, n_true, eps,
                                     x2.dtype)


def large_m_torch(x2, packed, g, h, *, n_true: int, bias=None,
                  raw: bool = False, eps: float = LN_EPS) -> torch.Tensor:
    ns = g.shape[0]
    seg_pad = packed.shape[-1] // ns
    # z is stored in x.dtype, as _call_large_m stores it (bitlinear_pallas.py:632)
    z = _project_torch(x2, packed, g, h, seg_pad).to(x2.dtype)
    if raw:
        return z
    return _layernorm_segments_torch(z, bias, ns, seg_pad, n_true, eps,
                                     x2.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(x2, packed, g, h, bias, ns: int, n_true: int) -> None:
    if x2.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {x2.device}")
    if x2.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x2.device}, but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    tensors = [("x", x2), ("packed", packed), ("g", g), ("h", h)]
    if bias is not None:
        tensors.append(("bias", bias))
    for name, t in tensors:
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x2.dtype}")
    if g.dtype != x2.dtype:
        raise TypeError(f"g must be {x2.dtype}, got {g.dtype}")
    if packed.dtype != torch.int32:
        raise TypeError(f"packed must be int32, got {packed.dtype}")
    for name, t in (("h", h), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    m, k = x2.shape
    nw, n = packed.shape
    if m < 1 or k % WORD_BITS or nw * WORD_BITS != k:
        raise ValueError(f"x {tuple(x2.shape)} does not match packed "
                         f"{tuple(packed.shape)}")
    if g.shape != (ns, k) or h.shape != (n,):
        raise ValueError(f"g {tuple(g.shape)} / h {tuple(h.shape)} do not "
                         f"match ns={ns}, K={k}, N={n}")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} does not match N={n}")
    seg_pad = n // ns
    if ns > 1 and (seg_pad * ns != n or seg_pad % _SEG_ALIGN):
        raise ValueError(f"fused width {n} is not {ns} segments of a "
                         f"multiple of {_SEG_ALIGN}")
    if not 0 < n_true <= seg_pad:
        raise ValueError(f"n_true={n_true} outside (0, {seg_pad}]")


def _raise_on(err: int, kernel: KernelInfo) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA error {err} at launch")


@functools.cache
def _small_m_lib() -> ctypes.CDLL:
    lib = build.load(SMALL_M.library)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.onebit_bitlinear_small_m.argtypes = [p] * 9 + [i] * 13 + [f, p]
    lib.onebit_bitlinear_small_m.restype = i
    return lib


_COUNTERS: dict = {}


def counters(device: torch.device, n: int) -> torch.Tensor:
    """``n`` int32 ticket counters on ``device``, zero between launches
    (every launch that uses them leaves them at zero). One buffer a device,
    grown when a launch needs more; the kernels that take it run on one
    stream at a time."""
    key = (device.type, device.index)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _large_m_lib() -> ctypes.CDLL:
    lib = build.load(LARGE_M.library)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.onebit_bitlinear_large_m.argtypes = [p] * 7 + [i] * 8 + [f, p]
    lib.onebit_bitlinear_large_m.restype = i
    lib.onebit_large_m_block_n.argtypes = [i, i]
    lib.onebit_large_m_block_n.restype = i
    return lib


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it starts on 16 bytes (K3's 16-byte copies), else a
    fresh copy, which does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_small_m(info: KernelInfo, x2, packed, g, h, bias, *, ns: int,
                    n_true: int, raw: bool, eps: float) -> torch.Tensor:
    """One launch of the small-M kernel on checked CUDA tensors: fp32 ``z ⊙
    h [M, N]`` (raw) or ``[ns, M, n_true]`` in x's dtype."""
    m, k = x2.shape
    n = packed.shape[-1]
    if m > SMALL_M_MAX:
        raise ValueError(f"{info.name} takes at most {SMALL_M_MAX} rows")
    dev = x2.device
    block_n, splits, kw, normalizers = small_m_plan(m, k, n, ns,
                                                    _sm_count(dev.index))
    x2, g = _aligned16(x2), _aligned16(g)
    if bias is not None:
        bias = _aligned16(bias)
    tiles = -(-n // block_n)
    row_blocks = -(-m // SMALL_M_ROWS)
    z = torch.empty((m, n), dtype=torch.float32, device=dev)
    stats = torch.empty(2 * m * tiles, dtype=torch.float32, device=dev)
    out = z if raw else torch.empty((ns, m, n_true), dtype=x2.dtype,
                                    device=dev)
    vec = int(n % 4 == 0 and packed.data_ptr() % 16 == 0)
    err = _small_m_lib().onebit_bitlinear_small_m(
        x2.data_ptr(), g.data_ptr(), packed.data_ptr(), h.data_ptr(),
        _ptr(bias), z.data_ptr(), stats.data_ptr(), out.data_ptr(),
        counters(dev, 2 * row_blocks * ns).data_ptr(), m, k, n, ns, n // ns,
        n_true, _DTYPE_CODES[x2.dtype], int(raw), block_n, splits, kw,
        normalizers, vec, eps, _stream(x2))
    _raise_on(err, info)
    info.launches += 1
    return out


def small_m(x2, packed, g, h, bias=None, *, raw: bool = False,
            eps: float = LN_EPS) -> torch.Tensor:
    """K1: ``x2 [M<=128, K]``, ``packed [K/32, N]``, ``g [K]`` (x.dtype),
    ``h [N]`` fp32, ``bias [N]`` fp32 or None -> ``[M, N]`` in x.dtype
    (with ``raw=True`` B4: fp32 ``z ⊙ h`` before the LayerNorm)."""
    if x2.device.type == "cpu":
        return small_m_torch(x2, packed, g, h, bias, raw=raw, eps=eps)
    _check(x2, packed, g[None], h, bias, 1, packed.shape[-1])
    n = packed.shape[-1]
    out = _launch_small_m(RAW_SMALL_M if raw else SMALL_M, x2, packed,
                          g[None], h, bias, ns=1, n_true=n, raw=raw, eps=eps)
    return out if raw else out[0]


def fused_small_m(x2, packed, g, h, *, n_true: int,
                  eps: float = LN_EPS) -> torch.Tensor:
    """K2: ``x2 [M<=128, K]``, ``packed [K/32, ns*seg_pad]``, ``g [ns, K]``
    (x.dtype), ``h [ns*seg_pad]`` fp32 (0 on pads) -> ``[ns, M, n_true]``."""
    if x2.device.type == "cpu":
        return fused_small_m_torch(x2, packed, g, h, n_true=n_true, eps=eps)
    ns = g.shape[0]
    _check(x2, packed, g, h, None, ns, n_true)
    return _launch_small_m(FUSED_SMALL_M, x2, packed, g, h, None, ns=ns,
                           n_true=n_true, raw=False, eps=eps)


def large_m(x2, packed, g, h, *, n_true: int, bias=None, raw: bool = False,
            eps: float = LN_EPS) -> torch.Tensor:
    """K3: ``x2 [M, K]`` (any M), ``packed [K/32, ns*seg_pad]``,
    ``g [ns, K]`` (x.dtype), ``h`` fp32, ``bias`` (ns = 1 only) ->
    ``[ns, M, n_true]`` in x.dtype (with ``raw=True`` B4:
    ``z ⊙ h [M, ns*seg_pad]`` in x.dtype). The column tile is
    :func:`large_m_block_n`'s."""
    if x2.device.type == "cpu":
        return large_m_torch(x2, packed, g, h, n_true=n_true, bias=bias,
                             raw=raw, eps=eps)
    ns = g.shape[0]
    if bias is not None and ns != 1:
        raise ValueError("bias is supported for a single projection only")
    _check(x2, packed, g, h, bias, ns, n_true)
    m, k = x2.shape
    n = packed.shape[-1]
    x2, g = _aligned16(x2), _aligned16(g)
    z = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    out = z if raw else torch.empty((ns, m, n_true), dtype=x2.dtype,
                                    device=x2.device)
    err = _large_m_lib().onebit_bitlinear_large_m(
        x2.data_ptr(), g.data_ptr(), packed.data_ptr(), h.data_ptr(),
        _ptr(bias), z.data_ptr(), out.data_ptr(), m, k, n, ns, n // ns,
        n_true, _DTYPE_CODES[x2.dtype], int(raw), eps, _stream(x2))
    if raw:
        info = RAW_LARGE_M
    else:
        info = LARGE_M_F32 if x2.dtype == torch.float32 else LARGE_M
    _raise_on(err, info)
    info.launches += 1
    return out
