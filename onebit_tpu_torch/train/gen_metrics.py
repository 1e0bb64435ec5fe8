"""Generation metrics for SFT predict: ROUGE-1/2/L + BLEU-4.

A copy of ``onebit_tpu/train/gen_metrics.py`` (pure Python): the port
scores its predictions as the JAX package does, to the last float.

The reference's ComputeMetrics (llama_factory/llamafactory/sft.py:31-68)
scores each (prediction, label) pair with rouge-1/2/l F1 over
jieba-segmented words and sentence BLEU-4 over character lists with NLTK
SmoothingFunction().method3, reporting means of per-pair scores x100.

This is a dependency-free reimplementation of those published algorithms
(jieba/rouge_chinese/nltk are not vendored): segmentation splits CJK
codepoints as single tokens and non-CJK runs on whitespace — jieba's
behavior for the mixed Chinese/English SFT corpora the reference targets,
minus its dictionary-driven multi-char word grouping.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence

_CJK = (
    "一-鿿㐀-䶿豈-﫿"  # unified ideographs + compat
    "぀-ヿ"                            # kana
)
_SEG_RE = re.compile(rf"[{_CJK}]|[^{_CJK}\s]+")


def segment(text: str) -> List[str]:
    """CJK-char / whitespace-word segmentation (jieba stand-in)."""
    return _SEG_RE.findall(text)


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def rouge_n_f1(hyp: Sequence[str], ref: Sequence[str], n: int) -> float:
    """ROUGE-N F1 (clipped n-gram overlap; Lin 2004)."""
    h, r = _ngrams(hyp, n), _ngrams(ref, n)
    overlap = sum((h & r).values())
    if not h or not r or overlap == 0:
        return 0.0
    p = overlap / sum(h.values())
    rec = overlap / sum(r.values())
    return 2 * p * rec / (p + rec)


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(prev[j + 1], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l_f1(hyp: Sequence[str], ref: Sequence[str]) -> float:
    """ROUGE-L F1 via longest common subsequence."""
    lcs = _lcs_len(hyp, ref)
    if lcs == 0:
        return 0.0
    p, r = lcs / len(hyp), lcs / len(ref)
    return 2 * p * r / (p + r)


def bleu4(hyp: Sequence[str], refs: Sequence[Sequence[str]],
          max_n: int = 4) -> float:
    """Sentence BLEU with NIST geometric smoothing (NLTK method3): the
    k-th zero-count modified precision is replaced by 1/2^k."""
    hyp = list(hyp)
    if not hyp:
        return 0.0
    log_p, invcnt = 0.0, 1
    for n in range(1, max_n + 1):
        h = _ngrams(hyp, n)
        # NLTK modified_precision clamps the denominator to >= 1, so a
        # hyp shorter than n still yields a (numerator-zero, smoothable)
        # fraction rather than a hard zero.
        den = max(sum(h.values()), 1)
        clipped = Counter()
        for ref in refs:
            clipped |= h & _ngrams(ref, n)
        num = sum(clipped.values())
        if num == 0:
            p = 1.0 / (2 ** invcnt * den)
            invcnt += 1
        else:
            p = num / den
        log_p += math.log(p)
    ref_len = min(refs, key=lambda r: (abs(len(r) - len(hyp)), len(r)))
    bp = 1.0 if len(hyp) > len(ref_len) else (
        math.exp(1 - len(ref_len) / len(hyp)) if len(hyp) else 0.0)
    return bp * math.exp(log_p / max_n)


def compute_generation_metrics(preds: Sequence[str],
                               labels: Sequence[str]) -> Dict[str, float]:
    """Mean rouge-1/2/l F1 (over segmented words) and bleu-4 (over
    characters) x100, exactly the reference's score table
    (sft.py:43-68)."""
    scores: Dict[str, List[float]] = {"rouge-1": [], "rouge-2": [],
                                      "rouge-l": [], "bleu-4": []}
    for pred, label in zip(preds, labels):
        hyp, ref = segment(pred), segment(label)
        if not hyp or not ref:
            r1 = r2 = rl = 0.0
        else:
            r1 = rouge_n_f1(hyp, ref, 1)
            r2 = rouge_n_f1(hyp, ref, 2)
            rl = rouge_l_f1(hyp, ref)
        scores["rouge-1"].append(round(r1 * 100, 4))
        scores["rouge-2"].append(round(r2 * 100, 4))
        scores["rouge-l"].append(round(rl * 100, 4))
        scores["bleu-4"].append(
            round(bleu4(list(pred), [list(label)]) * 100, 4))
    return {k: float(sum(v) / max(len(v), 1)) for k, v in scores.items()}
