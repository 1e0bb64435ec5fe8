"""PPL evaluation corpora: exact reference tokenization protocols.

Reference (evaluation/lm_eval/datautils.py):

* **wikitext2** (:35-54): test split joined with "\\n\\n", tokenized whole.
* **c4** (:86-127): the eval stream is 256 random ``seqlen+``-windows (seed
  0) drawn from validation docs long enough to hold ``seqlen+1`` tokens,
  hstacked into one stream.
* **ptb** variants analogous (train/val joined).

All loaders return a flat int32 token array ready for
``onebit_tpu_torch.eval.ppl.perplexity``. A copy of
``onebit_tpu/eval/datasets.py``.  HF ``datasets`` downloads require
network; every loader also accepts a local path (``load_from_disk`` dir or
a raw text/jsonl file), mirroring the reference's local-disk c4
(:86-87, :153-154).
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, List, Optional

import numpy as np


def _load_texts(source, split: str, text_column: str = "text") -> List[str]:
    """source: HF dataset name tuple, load_from_disk dir, or text file."""
    if isinstance(source, (tuple, list)):
        import datasets
        ds = datasets.load_dataset(*source, split=split)
        return list(ds[text_column])
    if os.path.isdir(source):
        import datasets
        ds = datasets.load_from_disk(source)
        if hasattr(ds, "keys") and split in getattr(ds, "keys", lambda: [])():
            ds = ds[split]
        return list(ds[text_column])
    if source.endswith(".jsonl"):
        with open(source) as f:
            return [json.loads(line)[text_column] for line in f]
    with open(source) as f:
        return [f.read()]


def wikitext2_tokens(tokenize: Callable, source=None,
                     split: str = "test") -> np.ndarray:
    """"\\n\\n".join(test split) tokenized whole (datautils.py:38-42)."""
    source = source or ("wikitext", "wikitext-2-raw-v1")
    texts = _load_texts(source, split)
    return np.asarray(tokenize("\n\n".join(texts)), np.int32)


def c4_eval_tokens(tokenize: Callable, source, *, seqlen: int = 2048,
                   n_windows: int = 256, seed: int = 0) -> np.ndarray:
    """256 random seqlen windows from long-enough val docs, concatenated
    (datautils.py:113-127: seed 0, while-loop resampling)."""
    texts = _load_texts(source, "validation")
    rng = random.Random(seed)
    windows = []
    for _ in range(n_windows):
        while True:
            i = rng.randint(0, len(texts) - 1)
            toks = tokenize(texts[i])
            if len(toks) >= seqlen + 1:
                break
        i = rng.randint(0, len(toks) - seqlen - 1)
        windows.append(toks[i:i + seqlen])
    return np.concatenate([np.asarray(w, np.int32) for w in windows])


def ptb_tokens(tokenize: Callable, source=None,
               split: str = "test") -> np.ndarray:
    """" ".join(sentence) tokenized whole (datautils.py:122-131 ptb_new:
    test split, space join)."""
    source = source or ("ptb_text_only", "penn_treebank")
    texts = _load_texts(source, split, text_column="sentence")
    return np.asarray(tokenize(" ".join(texts)), np.int32)


def ptb_val_tokens(tokenize: Callable, source=None) -> np.ndarray:
    """Original ptb eval stream: "\\n\\n".join(validation split)
    (datautils.py:56-65 get_ptb)."""
    source = source or ("ptb_text_only", "penn_treebank")
    texts = _load_texts(source, "validation", text_column="sentence")
    return np.asarray(tokenize("\n\n".join(texts)), np.int32)


def c4_new_eval_tokens(tokenize: Callable, source, *, seqlen: int = 2048,
                       n_windows: int = 256) -> np.ndarray:
    """c4_new eval stream: " ".join(first 1100 val docs) truncated to
    256*seqlen tokens (datautils.py:173-174)."""
    texts = _load_texts(source, "validation")[:1100]
    toks = np.asarray(tokenize(" ".join(texts)), np.int32)
    return toks[: n_windows * seqlen]


def pile_tokens(tokenize: Callable, source, n_docs: int = 1000) -> np.ndarray:
    """Pile stream: "\\n\\n".join(first 1000 docs) tokenized whole
    (datautils.py:16-21; the reference uses it for calibration crops only —
    exposed here for both calibration and rolling ppl)."""
    texts = _load_texts(source, "train")[:n_docs]
    return np.asarray(tokenize("\n\n".join(texts)), np.int32)


# ---------------------------------------------------------------------------
# Calibration crop loaders (the reference's `trainloader` half of
# datautils.get_loaders — nsamples random seqlen crops, labels masked to the
# final position; used by OmniQuant-style calibration consumers)
# ---------------------------------------------------------------------------

def calibration_crops(tokens: np.ndarray, nsamples: int, seqlen: int,
                      seed: int) -> List[np.ndarray]:
    """nsamples random [seqlen] crops of a flat token stream with the
    reference's randint convention (datautils.py:45-53)."""
    rng = random.Random(seed)
    crops = []
    for _ in range(nsamples):
        i = rng.randint(0, len(tokens) - seqlen - 1)
        crops.append(np.asarray(tokens[i:i + seqlen], np.int32))
    return crops


def c4_calibration_crops(tokenize: Callable, source, nsamples: int,
                         seqlen: int, seed: int,
                         min_len_plus: int = 1) -> List[np.ndarray]:
    """Per-doc resampling crops (datautils.py:92-105: while-loop until a doc
    holds seqlen+1 tokens, then one random window).  ``min_len_plus=0``
    reproduces the c4_new >= seqlen quirk (:164)."""
    texts = _load_texts(source, "train")
    rng = random.Random(seed)
    crops = []
    for _ in range(nsamples):
        while True:
            i = rng.randint(0, len(texts) - 1)
            toks = tokenize(texts[i])
            if len(toks) >= seqlen + min_len_plus:
                break
        i = rng.randint(0, len(toks) - seqlen - 1)
        crops.append(np.asarray(toks[i:i + seqlen], np.int32))
    return crops


def mix_calibration_crops(tokenize: Callable, nsamples: int, seqlen: int,
                          seed: int, *, wiki_source=None, ptb_source=None,
                          c4_source=None) -> List[np.ndarray]:
    """wiki + ptb + c4 thirds (datautils.py:193-199 get_loaders 'mix')."""
    third = nsamples // 3
    wiki = calibration_crops(
        wikitext2_tokens(tokenize, wiki_source, split="train"),
        third, seqlen, seed)
    ptb = calibration_crops(
        np.asarray(tokenize("\n\n".join(_load_texts(
            ptb_source or ("ptb_text_only", "penn_treebank"), "train",
            text_column="sentence"))), np.int32),
        third, seqlen, seed)
    c4 = c4_calibration_crops(tokenize, c4_source, third, seqlen, seed)
    return wiki + ptb + c4


def get_eval_tokens(name: str, tokenize: Callable, *, source=None,
                    seqlen: int = 2048) -> Optional[np.ndarray]:
    """Name-dispatch eval stream loader (reference get_loaders
    datautils.py:178-199 test-side).  Returns None for corpora the
    reference defines no eval stream for (pile, mix)."""
    if "wikitext2" in name:
        return wikitext2_tokens(tokenize, source)
    if "pile" in name:
        return None
    if "ptb" in name:
        if "new" in name:
            return ptb_tokens(tokenize, source)
        return ptb_val_tokens(tokenize, source)
    if "c4" in name:
        if source is None:
            raise ValueError("c4 needs a local source (zero-egress)")
        if "new" in name:
            return c4_new_eval_tokens(tokenize, source, seqlen=seqlen)
        return c4_eval_tokens(tokenize, source, seqlen=seqlen)
    if "mix" in name:
        return None
    raise ValueError(f"unknown ppl corpus {name!r}")
