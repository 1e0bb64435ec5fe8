"""The plain reference: the model of a configuration written out in plain
PyTorch, in float32 with TF32 off, with no kernel, cache or batching.

It imports nothing of the program. It is handed the benchmark's own seeded
inputs (``weights.py``: sign words, value vectors, embeddings, a teacher)
and works out again whatever the program derives from them (sign matrices
from the packed words, the student's SVID start). With ``precision="fp8"``
every matrix product takes operands rounded to float8 e4m3 with a scale a
tensor: the control, one precision below the bf16 the configurations state.

The BitLinear is ``LayerNorm_noaffine(((x * g) @ sign(W).T) * h)`` with
LayerNorm's eps 1e-5 (OneBit's ``nn.LayerNorm``), the decoder layer the
Llama layer (RMSNorm, GQA attention with rotary embeddings, SwiGLU MLP),
which Mistral-7B and DeepSeek-LLM-7B share.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5
PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
              "gate_proj", "up_proj", "down_proj")
FP8_MAX = 448.0
STE_OFFSET = 1.001      # OneBit's soft-sign STE: 1.001 - tanh(w)^2
LATENT_SIGN_SCALE = 0.01
SVID_ITERS = 50


def strict_fp32() -> None:
    """Matrix products in full fp32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its absmax at 448),
    back in fp32; the gradient passes through unchanged."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


class Arith:
    """The precision of every matrix product: ``fp32`` or ``fp8``."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.low = precision == "fp8"

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.low else x

    def mm(self, a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
        """``a @ b_t.T`` with both operands at this precision."""
        return torch.matmul(self.r(a), self.r(b_t).transpose(-1, -2))


def unpack_signs(words: torch.Tensor) -> torch.Tensor:
    """The port's K-major words ``[K/32, N]`` int32 (bit j of word (i, n)
    is the sign of input 32 i + j of output n, 1 meaning -1) -> the sign
    matrix ``[N, K]`` in fp32."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, None, :] >> shifts[None, :, None]) & 1   # [K/32, 32, N]
    signs = 1.0 - 2.0 * bits.reshape(-1, words.shape[-1]).float()
    return signs.T.contiguous()


def layernorm(z: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    mean = z.mean(-1, keepdim=True)
    var = (z - mean).square().mean(-1, keepdim=True)
    return (z - mean) * torch.rsqrt(var + eps)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding of ``x [S, n, hd]`` at ``positions [S]``."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    f = positions.float()[:, None] * inv
    emb = torch.cat([f, f], -1)
    cos, sin = emb.cos()[:, None], emb.sin()[:, None]
    x1, x2 = x.chunk(2, -1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(q, k, v, ar: Arith) -> torch.Tensor:
    """Causal GQA attention of ``q [B, S, nh, hd]``, ``k, v [B, S, nkv,
    hd]`` -> ``[B, S, nh*hd]``."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # [B, nh, S, hd]
    scores = ar.mm(qh, kh) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, -1)
    ctx = torch.matmul(ar.r(probs), ar.r(vh))
    return ctx.transpose(1, 2).reshape(b, s, nh * hd)


# ---------------------------------------------------------------------------
# The served model: packed projections
# ---------------------------------------------------------------------------

def _bitlinear(x, signs, g, h, ar: Arith):
    return layernorm(ar.mm(x * g, signs) * h)


def _served_layer(x, lw: Dict, cfg: Dict, positions, ar: Arith):
    """One decoder layer of the served model on ``x [B, S, d]``."""
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // nh
    b, s, _ = x.shape
    eps = cfg["rms_norm_eps"]

    def proj(name, inp):
        sg, g, h = lw[name]
        return _bitlinear(inp, sg, g, h, ar)

    hx = rmsnorm(x, lw["input_layernorm"], eps)
    q = proj("q_proj", hx).reshape(b, s, nh, hd)
    k = proj("k_proj", hx).reshape(b, s, nkv, hd)
    v = proj("v_proj", hx).reshape(b, s, nkv, hd)
    q = torch.stack([rope(qi, positions, cfg["rope_theta"]) for qi in q])
    k = torch.stack([rope(ki, positions, cfg["rope_theta"]) for ki in k])
    x = x + proj("o_proj", attention(q, k, v, ar))
    hx = rmsnorm(x, lw["post_attention_layernorm"], eps)
    act = F.silu(proj("gate_proj", hx)) * proj("up_proj", hx)
    return x + proj("down_proj", act)


def _served_layer_weights(raw: Dict, i: int) -> Dict:
    lw = {n: raw["layers"][n][i].float()
          for n in ("input_layernorm", "post_attention_layernorm")}
    for name in PROJ_NAMES:
        p = raw["layers"][name]
        lw[name] = (unpack_signs(p["packed"][i]), p["g"][i].float(),
                    p["h"][i].float())
    return lw


@torch.no_grad()
def served_gaps(raw: Dict, cfg: Dict, seqs: Sequence[Tuple[List[int],
                                                             List[int]]],
                control: bool = False) -> Dict[str, float]:
    """The reference over each ``(prompt, served tokens)``, one sequence
    at a time through a layer whose signs are unpacked once:
    ``served_gap``, the widest gap by which a served token's logit lies
    below the reference's best at its position; with ``control`` also
    ``control_gap``, the same for the token that the fp8 reference puts
    first at each of those positions."""
    strict_fp32()
    dev = raw["embed_tokens"].device
    arts = [("ref", Arith("fp32"))] + ([("ctl", Arith("fp8"))]
                                       if control else [])
    states = {}
    for name, _ in arts:
        states[name] = []
        for prompt, served in seqs:
            ids = torch.tensor(list(prompt) + list(served[:-1]),
                               device=dev)
            states[name].append(raw["embed_tokens"][ids].float()[None])
    for i in range(cfg["num_hidden_layers"]):
        lw = _served_layer_weights(raw, i)
        for name, ar in arts:
            for j, x in enumerate(states[name]):
                pos = torch.arange(x.shape[1], device=dev)
                states[name][j] = _served_layer(x, lw, cfg, pos, ar)
        del lw
    head = raw["lm_head"].float()
    final = raw["final_norm"].float()
    eps = cfg["rms_norm_eps"]
    served_gap, control_gap = 0.0, 0.0
    for j, (prompt, served) in enumerate(seqs):
        at = slice(len(prompt) - 1, len(prompt) - 1 + len(served))
        logits = torch.matmul(rmsnorm(states["ref"][j][0, at], final, eps),
                              head.T)
        best = logits.max(-1).values
        toks = torch.tensor(served, device=dev)
        gaps = best - logits.gather(-1, toks[:, None])[:, 0]
        served_gap = max(served_gap, gaps.max().item())
        if control:
            ar = arts[1][1]
            low = ar.mm(rmsnorm(states["ctl"][j][0, at], final, eps), head)
            first = low.argmax(-1)
            cg = best - logits.gather(-1, first[:, None])[:, 0]
            control_gap = max(control_gap, cg.max().item())
    out = {"served_gap": served_gap}
    if control:
        out["control_gap"] = control_gap
    return out


# ---------------------------------------------------------------------------
# KD training: the teacher, the SVID start, three steps of the recipe
# ---------------------------------------------------------------------------

class _SignSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        ctx.save_for_backward(w)
        return torch.sign(w)

    @staticmethod
    def backward(ctx, grad):
        (w,) = ctx.saved_tensors
        return grad * (STE_OFFSET - torch.tanh(w) ** 2)


def svid_start(w: torch.Tensor, iters: int = SVID_ITERS):
    """The SVID start of a plain weight ``[L, out, in]``: the leading
    singular pair of ``|W|`` by power iteration from a uniform start (the
    Perron vector, so it is the rank-1 NMF), h carrying the singular
    value; the latent weight ``sign(W) * 0.01``."""
    a = w.abs()
    g = torch.full(a.shape[:-2] + (a.shape[-1],), a.shape[-1] ** -0.5,
                   device=w.device)
    for _ in range(iters):
        h = torch.matmul(a, g[..., None])[..., 0]
        h = h / (h.norm(dim=-1, keepdim=True) + 1e-30)
        g = torch.matmul(a.transpose(-1, -2), h[..., None])[..., 0]
        g = g / (g.norm(dim=-1, keepdim=True) + 1e-30)
    h = torch.matmul(a, g[..., None])[..., 0]
    return torch.sign(w) * LATENT_SIGN_SCALE, h, g


def _kd_forward(tree: Dict, cfg: Dict, ids: torch.Tensor, ar: Arith,
                student: bool):
    """Logits ``[B, S, V]`` and the hidden states ``[L+1, B, S, d]`` (the
    embeddings, then each layer's output)."""
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // nh
    eps = cfg["rms_norm_eps"]
    b, s = ids.shape
    pos = torch.arange(s, device=ids.device)
    layers = tree["layers"]

    def proj(name, i, x):
        p = layers[name]
        if student:
            sg = _SignSTE.apply(p["latent"][i])
            return layernorm(ar.mm(x * p["g"][i], sg) * p["h"][i])
        return ar.mm(x, p["weight"][i])

    def attn_half(x, i):
        hx = rmsnorm(x, layers["input_layernorm"][i], eps)
        q = proj("q_proj", i, hx).reshape(b, s, nh, hd)
        k = proj("k_proj", i, hx).reshape(b, s, nkv, hd)
        v = proj("v_proj", i, hx).reshape(b, s, nkv, hd)
        q = torch.stack([rope(t, pos, cfg["rope_theta"]) for t in q])
        k = torch.stack([rope(t, pos, cfg["rope_theta"]) for t in k])
        return x + proj("o_proj", i, attention(q, k, v, ar))

    def mlp_half(x, i):
        hx = rmsnorm(x, layers["post_attention_layernorm"][i], eps)
        act = F.silu(proj("gate_proj", i, hx)) * proj("up_proj", i, hx)
        return x + proj("down_proj", i, act)

    x = tree["embed_tokens"][ids]
    hidden = [x]
    for i in range(cfg["num_hidden_layers"]):
        if student:
            x = checkpoint(attn_half, x, i, use_reentrant=False)
        else:
            x = attn_half(x, i)
        x = mlp_half(x, i)
        hidden.append(x)
    h = rmsnorm(x, tree["final_norm"], eps)
    return ar.mm(h, tree["lm_head"]), torch.stack(hidden)


def _kd_loss(kd: Dict, cfg: Dict, s_logits, t_logits, s_hidden, t_hidden):
    """kd_alpha * kd_loss_scale * KL(student || teacher) (batchmean) +
    (1 - kd_alpha) * CE + kd_beta * the normalized hidden-state MSE of
    the embeddings and the first L-1 layers."""
    b = s_logits.shape[0]
    log_s = torch.log_softmax(s_logits, -1)
    log_t = torch.log_softmax(t_logits, -1)
    kl = (log_t.exp() * (log_t - log_s)).sum() / b
    total = kd["kd_alpha"] * kd["kd_loss_scale"] * kl
    if kd["kd_alpha"] != 1.0:
        raise ValueError("the reference recipe distills only (kd_alpha 1)")
    if kd["kd_beta"] > 0:
        n = cfg["num_hidden_layers"]
        s = s_hidden[:n].reshape(n, -1, s_hidden.shape[-1])
        t = t_hidden[:n].reshape(n, -1, t_hidden.shape[-1])
        s = s / (s.norm(dim=-1, keepdim=True) + 1e-12)
        t = t / (t.norm(dim=-1, keepdim=True) + 1e-12)
        total = total + kd["kd_beta"] * ((t - s) ** 2).sum(-1).mean(-1).sum()
    if kd.get("kd_gamma", 0) > 0:
        raise ValueError("the reference recipe has no attention-map loss")
    return total


def _lr(train: Dict, count: int) -> float:
    """The learning rate of update ``count`` (from 0): a linear warmup
    from 0, then a cosine to ``min_lr_ratio`` (or a constant)."""
    peak, warm = train["learning_rate"], train["warmup_steps"]
    if count < warm:
        return peak * min(count, warm) / warm
    if train["lr_schedule"] == "constant":
        return peak
    decay = train["total_steps"] - warm
    c = min(count - warm, decay)
    alpha = train.get("min_lr_ratio", 0.0)
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay))
                   + alpha)


def student_leaves(student: Dict) -> List[Tuple[str, torch.Tensor]]:
    """``(key, leaf)`` of the trainable leaves, keyed as the native
    checkpoints key them (``layers.<proj>.latent|weight_scale|
    input_factor``)."""
    names = {"latent": "latent", "h": "weight_scale", "g": "input_factor"}
    return [(f"layers.{p}.{names[f]}", student["layers"][p][f])
            for p in PROJ_NAMES for f in ("latent", "h", "g")]


def kd_reference(teacher_raw: Dict, cfg: Dict, batches: Sequence[
        torch.Tensor], kd: Dict, train: Dict, precision: str = "fp32",
                 rows: Optional[int] = None) -> Dict:
    """Three (``len(batches)``) steps of the KD recipe from the SVID start
    of ``teacher_raw``: each step's loss, each leaf's norm of its first
    clipped gradient (what AdamW is given), of its first raw gradient, and
    of its change over the steps. ``rows``: use only the first ``rows`` of
    each batch (a fault: part of the batch left out)."""
    strict_fp32()
    ar = Arith(precision)
    layers = teacher_raw["layers"]
    shared = {k: teacher_raw[k].float()
              for k in ("embed_tokens", "lm_head", "final_norm")}
    norms = {k: layers[k].float()
             for k in ("input_layernorm", "post_attention_layernorm")}
    teacher = dict(shared, layers=dict(norms, **{
        p: {"weight": layers[p].float()} for p in PROJ_NAMES}))
    student_layers = dict(norms)
    for p in PROJ_NAMES:
        lat, h, g = svid_start(layers[p].float())
        student_layers[p] = {"latent": lat, "h": h, "g": g}
    student = dict(shared, layers=student_layers)
    leaves = student_leaves(student)
    for _, t in leaves:
        t.requires_grad_(True)
    start = [t.detach().clone() for _, t in leaves]
    mu = [torch.zeros_like(t) for _, t in leaves]
    nu = [torch.zeros_like(t) for _, t in leaves]
    b1, b2 = train["adam_beta1"], train["adam_beta2"]
    out = {"loss": [], "grad": {}, "raw_grad": {}, "change": {}}
    for n, ids in enumerate(batches):
        ids = ids if rows is None else ids[:rows]
        with torch.no_grad():
            t_logits, t_hidden = _kd_forward(teacher, cfg, ids, ar, False)
        s_logits, s_hidden = _kd_forward(student, cfg, ids, ar, True)
        loss = _kd_loss(kd, cfg, s_logits, t_logits, s_hidden, t_hidden)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        del s_logits, s_hidden, t_logits, t_hidden
        out["loss"].append(loss.item())
        with torch.no_grad():
            norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
            scale = (train["max_grad_norm"] / norm
                     if norm >= train["max_grad_norm"] else 1.0)
            lr = _lr(train, n)
            bc1, bc2 = 1 - b1 ** (n + 1), 1 - b2 ** (n + 1)
            for j, ((key, p), g) in enumerate(zip(leaves, grads)):
                if n == 0:
                    out["raw_grad"][key] = g.norm().item()
                g = g * scale
                if n == 0:
                    out["grad"][key] = g.norm().item()
                mu[j].mul_(b1).add_((1 - b1) * g)
                nu[j].mul_(b2).add_((1 - b2) * g * g)
                u = (mu[j] / bc1) / (torch.sqrt(nu[j] / bc2) + 1e-8)
                p.add_(-lr * (u + train["weight_decay"] * p))
        del grads
    with torch.no_grad():
        for (key, p), p0 in zip(leaves, start):
            out["change"][key] = (p - p0).norm().item()
    return out


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keys: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap between two per-leaf norms: ``|prog - ref|``
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger. Returns (gap, leaf)."""
    keys = list(ref) if keys is None else list(keys)
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    worst, at = 0.0, ""
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def moved_leaves(raw_grad: Dict[str, float], share: float = 1e-3
                 ) -> List[str]:
    """Leaves whose first raw gradient is at least ``share`` of the median
    leaf's: the others move under AdamW by round-off alone."""
    med = sorted(raw_grad.values())[len(raw_grad) // 2]
    return [k for k, v in raw_grad.items() if v >= share * med]
