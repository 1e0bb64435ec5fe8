"""The yardstick's arithmetic: published peaks of one H100 SXM, and the
operations and bytes that a piece of work needs, computed from shapes.

Frozen copies of ``chip_smoke.py``'s ``_bound``, ``_kv_bound``,
``_paged_bound``, ``_flash_bound`` and ``_flash_bwd_bound``, taking shapes
instead of tensors, and returning seconds. Each counts every input byte
read once and every output byte written once, and the least time of a piece
of work is the larger of its bytes over the HBM bandwidth and its
operations over the bf16 tensor-core peak. The program may change; these
may not, so that a later change is measured against the same work.
"""

from __future__ import annotations

from typing import Dict, Iterable, NamedTuple

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12          # fp32 on the CUDA cores, no tensor cores
# K3's fp32 instance multiplies on the bf16 tensor cores in three passes
K3_F32_PASSES = 3
# B11 fp32: six products of split bf16 parts for S and six for P V
FLASH_F32_PRODUCTS = 12
# B11-dkv/dq fp32: six bf16 products for each fp32 product
FLASH_BWD_F32_PRODUCTS = 6


class Work(NamedTuple):
    """Bytes and operations of a piece of work."""
    bytes: float
    flops: float

    def __add__(self, other):
        return Work(self.bytes + other.bytes, self.flops + other.flops)

    def least_s(self, flop_per_s: float = BF16_FLOP_PER_S) -> float:
        """max(bytes / HBM bandwidth, operations / peak)."""
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / flop_per_s)


ZERO = Work(0.0, 0.0)


def total_least_s(works: Iterable[Work]) -> float:
    """Least seconds of works that run one after another."""
    return sum(w.least_s() for w in works)


# ---------------------------------------------------------------------------
# Kernels (frozen from chip_smoke.py)
# ---------------------------------------------------------------------------

def bitlinear_work(m: int, k: int, n_true: int, ns: int = 1,
                   n_cat: int = 0, elem: int = 2, out_elem: int = 0,
                   fp32: bool = False) -> Work:
    """One BitLinear call (``_bound``): the packed words ``[k/32, n_cat]``,
    x ``[m, k]``, g ``[ns, k]`` and h ``[n_cat]`` read once, ``ns`` outputs
    ``[m, n_true]`` written once; ``2 m k ns n_true`` operations (three
    bf16 passes for K3's fp32 instance)."""
    n_cat = n_cat or ns * n_true
    bytes_ = (k // 32 * n_cat * 4 + m * k * elem + ns * k * elem
              + n_cat * 4 + ns * m * n_true * (out_elem or elem))
    flops = 2 * m * k * ns * n_true * (K3_F32_PASSES if fp32 else 1)
    return Work(bytes_, flops)


def kv_work(lengths, nkv: int, g: int, hd: int, t: int, int4: bool,
            append: bool) -> Work:
    """B5-B8 (``_kv_bound``): each row's K and V bytes up to its length
    (int4: min(length, T/2) byte columns) and its scales read once, q read,
    ctx written, with the append this step's K/V and scales read and
    written once; 4 operations per K/V element per query head."""
    b = len(lengths)
    bytes_ = 2 * b * nkv * g * hd * 2
    flops = 0
    for n in lengths:
        cols = min(n, t // 2) if int4 else n
        bytes_ += nkv * (2 * hd * cols + 2 * 4 * n)
        flops += 4 * nkv * g * hd * n
    bytes_ += 4 * b * (2 if append else 1)
    if append:
        bytes_ += 2 * b * nkv * (2 * hd + 2 * 4)
    return Work(bytes_, flops)


def paged_work(lengths, nkv: int, g: int, hd: int, ps: int,
               quant=False) -> Work:
    """B10 (``_paged_bound``): each row's K and V below its length (int8,
    ``quant`` True, with their scales; int8 and fp8 one byte an element,
    bf16 two), the page-table entries under the length and the length read
    once, q read, the fp32 output written; 4 operations per K/V element per
    query head."""
    b = len(lengths)
    elem = 1 if quant else 2
    scales = 4 if quant is True else 0
    bytes_ = b * nkv * g * hd * (2 + 4) + 4 * b
    flops = 0
    for n in lengths:
        bytes_ += 2 * nkv * n * (hd * elem + scales)
        bytes_ += 4 * -(-n // ps)
        flops += 4 * nkv * g * hd * n
    return Work(bytes_, flops)


def flash_work(b: int, s: int, nh: int, nkv: int, hd: int,
               fp32: bool = False) -> Work:
    """B11 (``_flash_bound``): q, k, v read and the output written once;
    the causal half's two products, ``4 B nh hd S(S+1)/2`` (fp32: twelve
    bf16 products in place of two)."""
    elem = 4 if fp32 else 2
    bytes_ = elem * b * s * hd * (2 * nh + 2 * nkv)
    flops = 4 * b * nh * hd * s * (s + 1) / 2
    if fp32:
        flops *= FLASH_F32_PRODUCTS / 2
    return Work(bytes_, flops)


def flash_bwd_work(b: int, s: int, nh: int, nkv: int, hd: int, kernel: str,
                   fp32: bool = False) -> Work:
    """B11-dkv (``kernel="dkv"``: S, dP, dV, dK) or B11-dq (S, dP, dQ)
    (``_flash_bwd_bound``): q, do, k, v and the fp32 lse and di read once,
    the outputs written once; ``2 B nh hd S(S+1)/2`` operations a
    product."""
    elem = 4 if fp32 else 2
    bytes_ = elem * b * s * hd * (2 * nh + 2 * nkv) + 2 * 4 * b * nh * s
    bytes_ += elem * b * s * hd * (2 * nkv if kernel == "dkv" else nh)
    products = 4 if kernel == "dkv" else 3
    flops = products * 2 * b * nh * hd * s * (s + 1) / 2
    if fp32:
        flops *= FLASH_BWD_F32_PRODUCTS
    return Work(bytes_, flops)


# ---------------------------------------------------------------------------
# A model's work, from its configuration
# ---------------------------------------------------------------------------

def proj_shapes(cfg: Dict) -> Dict[str, tuple]:
    """name -> (out, in) of a layer's seven projections."""
    d, inter = cfg["hidden_size"], cfg["intermediate_size"]
    hd = d // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * hd
    return {"q_proj": (d, d), "k_proj": (kv, d), "v_proj": (kv, d),
            "o_proj": (d, d), "gate_proj": (inter, d),
            "up_proj": (inter, d), "down_proj": (d, inter)}


def layer_params(cfg: Dict) -> int:
    """Weights of one layer's seven projections."""
    return sum(o * i for o, i in proj_shapes(cfg).values())


def projections_work(cfg: Dict, m: int) -> Work:
    """Every BitLinear call of one forward of all layers at ``m`` rows, one
    call a projection (fusion changes launches, not the work)."""
    w = ZERO
    for out, inp in proj_shapes(cfg).values():
        w = w + bitlinear_work(m, inp, out)
    return Work(w.bytes * cfg["num_hidden_layers"],
                w.flops * cfg["num_hidden_layers"])


def lm_head_work(cfg: Dict, m: int, elem: int = 2) -> Work:
    """The lm_head at ``m`` rows: its weights and x read once, fp32 logits
    written once."""
    v, d = cfg["vocab_size"], cfg["hidden_size"]
    return Work(v * d * elem + m * d * elem + m * v * 4, 2.0 * m * d * v)


def decode_attention_work(cfg: Dict, lengths, page_size: int) -> Work:
    """One decode step's attention over pages at every layer (B10's count)
    for rows attending ``lengths`` positions."""
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // nh
    w = paged_work(lengths, nkv, nh // nkv, hd, page_size)
    layers = cfg["num_hidden_layers"]
    return Work(w.bytes * layers, w.flops * layers)


def decode_step_work(cfg: Dict, rows: int, lengths, page_size: int) -> Work:
    """A whole decode token-step at ``rows`` rows: every packed projection,
    the lm_head and the KV of ``lengths`` read once; their products."""
    return (projections_work(cfg, rows) + lm_head_work(cfg, rows)
            + decode_attention_work(cfg, lengths, page_size))


def prompt_flops(cfg: Dict, plen: int) -> float:
    """Operations that one prompt's prefill needs: every projection and
    the causal attention of its real tokens, and the lm_head of its last."""
    nh = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // nh
    attn = 4.0 * nh * hd * plen * (plen + 1) / 2 * cfg["num_hidden_layers"]
    return (2.0 * plen * layer_params(cfg) * cfg["num_hidden_layers"] + attn
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"])


def kd_step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Operations a KD step needs, recomputation not counted: the teacher's
    forward and the student's forward (1x each) and backward (2x) of every
    projection, the lm_head (the student's backward takes only the input's
    gradient: the head is frozen) and the causal attention (B11's count,
    its backward 2.5x)."""
    tokens = batch * seq
    layers = cfg["num_hidden_layers"]
    proj = 2.0 * tokens * layer_params(cfg) * layers
    head = 2.0 * tokens * cfg["hidden_size"] * cfg["vocab_size"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // nh
    attn = flash_work(batch, seq, nh, nkv, hd).flops * layers
    return 4 * proj + 3 * head + 4.5 * attn


def kd_gemm_flops(cfg: Dict, batch: int, seq: int) -> float:
    """The matrix products of a KD step: :func:`kd_step_flops` without the
    attention (the products the projections' and head's GEMMs run)."""
    tokens = batch * seq
    proj = 2.0 * tokens * layer_params(cfg) * cfg["num_hidden_layers"]
    head = 2.0 * tokens * cfg["hidden_size"] * cfg["vocab_size"]
    return 4 * proj + 3 * head
