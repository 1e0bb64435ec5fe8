"""Train/test overlap against PRE-BUILT sorted n-gram buckets.

The reference's ``decontamination/decontaminate.py:get_train_overlap``
(:37-169) scans ``ngrams_*.sorted.zst`` files (13-grams of the training
corpus, produced offline) against per-task document n-gram lookups and
returns ``{task_name: set(contaminated_doc_ids)}``.  This is the
big-corpus path — the training set is visited once as a sorted stream, so
memory stays bounded by the task-side lookup regardless of corpus size.
(The small-corpus path, scanning raw training text with the Janitor C
core, lives in ``eval.tasks.base._find_contaminated``.)

Same inputs/outputs as the reference: an ``info.json`` with
``{"ngram_size": N}`` next to the bucket files, and the bucket line format
``"<ngram> <doc_id>"``.  Differences: no hidden ``data/`` pickle cache
(pass ``cache_dir`` explicitly if wanted) and streaming decompression.

A copy of ``onebit_tpu/tools/decontam/overlap.py``.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import pickle
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from onebit_tpu_torch.tools.decontam.archiver import ZstTextReader
from onebit_tpu_torch.tools.decontam.janitor import Janitor


def word_ngrams(s: str, n: int) -> Iterable[str]:
    """Space-joined word n-grams (reference janitor.py word_ngrams)."""
    words = s.split()
    return (" ".join(words[i:i + n]) for i in range(len(words) - n + 1))


def build_task_lookup(docs: Sequence[str], ngram_size: int,
                      janitor: Janitor = None) -> Dict[str, Set[int]]:
    """``{ngram: set(doc_ids)}`` over normalized task documents
    (reference decontaminate.py:84-91)."""
    janitor = janitor or Janitor(ngram_n=ngram_size)
    lookup: Dict[str, Set[int]] = collections.defaultdict(set)
    for doc_id, document in enumerate(docs):
        for ngram in word_ngrams(janitor.normalize(document), ngram_size):
            lookup[ngram].add(doc_id)
    return dict(lookup)


def get_train_overlap(docs_by_task: Dict[str, Sequence[str]],
                      ngrams_path: str,
                      cache_dir: str = None) -> Dict[str, Set[int]]:
    """Contaminated doc ids per task, from pre-built sorted n-gram buckets.

    ``docs_by_task``: task name → decontamination queries (one per doc).
    ``ngrams_path``: directory holding ``info.json`` and
    ``*.sorted.zst`` bucket files.  ``cache_dir``: optional directory for
    per-task overlap pickles (the reference caches under ``data/``,
    decontaminate.py:49-69).
    """
    with open(os.path.join(ngrams_path, "info.json")) as f:
        ngram_size = json.load(f)["ngram_size"]

    results: Dict[str, Set[int]] = {}
    pending: Dict[str, Sequence[str]] = {}
    for task, docs in docs_by_task.items():
        cached = _cache_path(cache_dir, task, ngram_size)
        if cached and os.path.exists(cached):
            with open(cached, "rb") as f:
                results[task] = pickle.load(f)
        else:
            pending[task] = docs
    if not pending:
        return results

    janitor = Janitor(ngram_n=ngram_size)
    # merged lookup: ngram -> [(task, doc_ids)] (decontaminate.py:100-107)
    merged: Dict[str, List[Tuple[str, Set[int]]]] = collections.defaultdict(
        list)
    for task, docs in pending.items():
        results[task] = set()
        for ngram, doc_ids in build_task_lookup(docs, ngram_size,
                                                janitor).items():
            merged[ngram].append((task, doc_ids))

    for bucket in sorted(glob.glob(os.path.join(ngrams_path,
                                                "*.sorted.zst"))):
        current = None
        for line in ZstTextReader(bucket).read():
            if not line:
                continue
            ngram = line.rsplit(" ", 1)[0]
            if ngram == current:      # sorted stream: match each once
                continue
            current = ngram
            hits = merged.pop(ngram, None)
            if hits:
                for task, doc_ids in hits:
                    results[task] |= doc_ids

    if cache_dir:
        for task in pending:
            with open(_cache_path(cache_dir, task, ngram_size), "wb") as f:
                pickle.dump(results[task], f)
    return results


def _cache_path(cache_dir, task, ngram_size):
    if not cache_dir:
        return None
    os.makedirs(cache_dir, exist_ok=True)
    safe = task.replace(os.sep, "_")
    return os.path.join(cache_dir, f"{safe}_{ngram_size}grams.overlaps")
