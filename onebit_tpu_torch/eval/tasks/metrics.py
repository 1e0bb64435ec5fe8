"""Shared task metrics & text helpers (reference evaluation/lm_eval/metrics.py
+ utils.py + the SQuAD metric conventions used by superglue/coqa/drop).

Fresh implementations of the public metric definitions; names mirror the
reference so task code reads the same. A copy of
``onebit_tpu/eval/tasks/metrics.py``; ``f1_score`` and
``matthews_corrcoef`` import scikit-learn when called.
"""

from __future__ import annotations

import collections
import re
import string
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


def mean(items) -> float:
    return float(np.mean(items))


def yesno(x) -> str:
    return "yes" if x else "no"


def matthews_corrcoef(items) -> float:
    """items: [(gold, pred)] (reference metrics.py:32-36)."""
    import sklearn.metrics
    golds, preds = zip(*items)
    return float(sklearn.metrics.matthews_corrcoef(golds, preds))


def f1_score(items) -> float:
    """items: [(gold, pred)] binary F1 (reference metrics.py:39-45)."""
    import sklearn.metrics
    golds, preds = zip(*items)
    return float(np.max(sklearn.metrics.f1_score(golds, preds)))


def acc_all(items) -> float:
    """MultiRC: correct iff every answer option of a question is labeled
    correctly (reference metrics.py:48-64).  items: [(pred, doc)] where doc
    carries ``idx.paragraph``/``idx.question`` and ``label``."""
    per_question: Dict[Tuple, List[bool]] = {}
    for pred, doc in items:
        key = (doc["idx"]["paragraph"], doc["idx"]["question"])
        per_question.setdefault(key, []).append((doc["label"] == 1) == pred)
    return float(np.mean([int(all(v)) for v in per_question.values()]))


def metric_max_over_ground_truths(metric_fn: Callable, prediction,
                                  ground_truths) -> float:
    return max(metric_fn(prediction, gt) for gt in ground_truths)


def general_detokenize(text: str) -> str:
    """Undo moses-style tokenization artifacts (reference utils.py
    general_detokenize)."""
    text = text.replace(" n't", "n't")
    text = text.replace(" )", ")")
    text = text.replace("( ", "(")
    text = text.replace('" ', '"')
    text = text.replace(' "', '"')
    text = re.sub(r" (['.,])", r"\1", text)
    return text


# -- SQuAD-style answer metrics (the public SQuAD v2 eval definitions, used
# by the reference via transformers.data.metrics.squad_metrics) --------------

def normalize_answer(s: str) -> str:
    """Lower, strip punctuation/articles, collapse whitespace."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def compute_exact(a_gold: str, a_pred: str) -> int:
    return int(normalize_answer(a_gold) == normalize_answer(a_pred))


def compute_f1(a_gold: str, a_pred: str) -> float:
    gold_toks = normalize_answer(a_gold).split()
    pred_toks = normalize_answer(a_pred).split()
    common = collections.Counter(gold_toks) & collections.Counter(pred_toks)
    num_same = sum(common.values())
    if not gold_toks or not pred_toks:
        return float(gold_toks == pred_toks)
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_toks)
    recall = num_same / len(gold_toks)
    return 2 * precision * recall / (precision + recall)


def squad_em_f1(prediction: str, golds: Sequence[str]) -> Tuple[float, float]:
    em = metric_max_over_ground_truths(compute_exact, prediction, golds)
    f1 = metric_max_over_ground_truths(compute_f1, prediction, golds)
    return float(em), float(f1)
