"""KD and SFT data: registry, texts, token blocks and the train step's batches.

A copy of ``onebit_tpu/train/data.py`` (json, hashlib and numpy), so that
the port imports nothing of the JAX package; its templates come from the
port's own ``train/templates.py``. It mirrors the reference's data path
(llama_factory/llamafactory/dsets.py):

* a JSON registry maps dataset name -> file + expected SHA-1; loading
  verifies the checksum (dsets.py:27-39, data/dataset_info.json);
* KD preprocessing is the ``pt`` path (dsets.py:170-191, 350-352):
  tokenize every example, append EOS, concatenate, chunk into
  ``cutoff_len`` blocks, drop the remainder;
* SFT masks the prompt's labels to ``IGNORE_INDEX`` and right-pads;
* ``split_dataset`` and ``batch_iterator`` draw the JAX module's numpy
  random streams, so both packages draw the same batches for a seed.
  Labels equal the input ids (HF CLM collator semantics, kd.py:207).

Every function takes a ``tokenize`` callable. The CLI's text flags wait
for :data:`TEXT_DATASETS_WAIT_FOR`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from onebit_tpu_torch.train import templates as _templates

TEXT_DATASETS_WAIT_FOR = ("a Hugging Face tokenizer (transformers) in the "
                          "repository, which it does not hold; pass "
                          "pre-tokenized blocks (--tokens BLOCKS.npy)")


# ---------------------------------------------------------------------------
# Registry (data/dataset_info.json equivalent)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DatasetInfo:
    file_name: str
    file_sha1: Optional[str] = None
    prompt_column: str = "text"


def load_registry(path: str) -> Dict[str, DatasetInfo]:
    """Parse a dataset_info.json (reference format, data/dataset_info.json).

    Reference entries look like
    ``{"kd_132k": {"file_name": ..., "file_sha1": ...,
    "columns": {"prompt": "text"}}}``.
    """
    with open(path) as f:
        raw = json.load(f)
    registry = {}
    for name, spec in raw.items():
        registry[name] = DatasetInfo(
            file_name=spec["file_name"],
            file_sha1=spec.get("file_sha1"),
            prompt_column=spec.get("columns", {}).get("prompt", "text"),
        )
    return registry


def checksum(path: str) -> str:
    """SHA-1 of a file (reference dsets.py:27-39 integrity check)."""
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_texts(data_dir: str, name: str,
               registry: Optional[Dict[str, DatasetInfo]] = None,
               verify: bool = True) -> List[str]:
    """Load a registered dataset's text column (json/jsonl/txt)."""
    if registry is None:
        registry = load_registry(os.path.join(data_dir, "dataset_info.json"))
    info = registry[name]
    path = os.path.join(data_dir, info.file_name)
    if verify and info.file_sha1:
        got = checksum(path)
        if got != info.file_sha1:
            raise ValueError(
                f"checksum mismatch for {name}: {got} != {info.file_sha1}")
    texts: List[str] = []
    if path.endswith(".jsonl"):
        with open(path) as f:
            for line in f:
                texts.append(json.loads(line)[info.prompt_column])
    elif path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        for row in data:
            texts.append(row[info.prompt_column])
    else:
        with open(path) as f:
            texts = [f.read()]
    return texts


# ---------------------------------------------------------------------------
# Templates: train/templates.py's 18 formats, each as a single-turn render
# ---------------------------------------------------------------------------

class _TemplateMap:
    def __getitem__(self, name: str) -> Callable[[str], str]:
        tpl = _templates.REGISTRY[name]
        return lambda q: tpl.render(q)

    def __contains__(self, name):
        return name in _templates.REGISTRY


TEMPLATES = _TemplateMap()


def register_template(name: str, fn: Callable[[str], str]) -> None:
    """Register a plain callable as a single-turn template."""
    class _FnTemplate(_templates.Template):
        def render(self, query, history=None, system=None):  # type: ignore
            return fn(query)
    _templates.register_template(_FnTemplate(name=name))


# ---------------------------------------------------------------------------
# Tokenize-concat-chunk (dsets.py:170-191)
# ---------------------------------------------------------------------------

def chunk_tokens(token_lists: Sequence[Sequence[int]], cutoff_len: int,
                 eos_id: Optional[int] = None) -> np.ndarray:
    """Concatenate token lists (each + EOS) and chunk into fixed blocks.

    The reference's preprocess_pretrain_dataset: the total length is
    floored to a multiple of ``cutoff_len``; the remainder is dropped.
    """
    parts = []
    for toks in token_lists:
        parts.extend(toks)
        if eos_id is not None:
            parts.append(eos_id)
    total = (len(parts) // cutoff_len) * cutoff_len
    if total == 0:
        return np.zeros((0, cutoff_len), np.int32)
    return np.asarray(parts[:total], np.int32).reshape(-1, cutoff_len)


def prepare_kd_dataset(texts: Sequence[str], tokenize: Callable,
                       cutoff_len: int = 2048, eos_id: int = 2,
                       template: str = "vanilla") -> np.ndarray:
    """texts -> [num_blocks, cutoff_len] int32 (the KD training matrix)."""
    tpl = TEMPLATES[template]
    token_lists = [tokenize(tpl(t)) for t in texts]
    return chunk_tokens(token_lists, cutoff_len, eos_id=eos_id)


def split_dataset(blocks: np.ndarray, val_size: float = 0.0,
                  seed: int = 42):
    """Shuffled train/val split (reference dsets.py:42-63)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(blocks))
    n_val = int(len(blocks) * val_size)
    return blocks[perm[n_val:]], blocks[perm[:n_val]]


def batch_iterator(blocks: np.ndarray, batch_size: int, *, shuffle=True,
                   seed: int = 0, drop_last=True,
                   epochs: Optional[int] = None) -> Iterator[dict]:
    """Yields {"input_ids", "labels"} batches (labels = input_ids, CLM)."""
    epoch = 0
    while epochs is None or epoch < epochs:
        idx = np.arange(len(blocks))
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(idx)
        end = len(idx) - (len(idx) % batch_size if drop_last else 0)
        for i in range(0, end, batch_size):
            chunk = blocks[idx[i:i + batch_size]]
            if len(chunk) < batch_size and drop_last:
                break
            yield {"input_ids": chunk, "labels": chunk.copy()}
        epoch += 1


# ---------------------------------------------------------------------------
# SFT preprocessing (reference dsets.py preprocess_supervised_dataset path)
# ---------------------------------------------------------------------------

IGNORE_INDEX = -100  # HF label-masking convention


def prepare_sft_dataset(pairs, tokenize: Callable, *, cutoff_len: int = 1024,
                        eos_id: int = 2, pad_id: int = 0,
                        template: str = "vanilla"):
    """(prompt, response) pairs -> padded supervised batches.

    Prompt tokens are masked to IGNORE_INDEX in the labels (only the
    response is learned), sequences are truncated to ``cutoff_len`` and
    right-padded (reference supervised preprocessing semantics).
    Returns {"input_ids", "labels", "attention_mask"} numpy arrays [N, L].
    """
    tpl = TEMPLATES[template]
    rows = []
    for prompt, response in pairs:
        p = tokenize(tpl(prompt))
        r = tokenize(response) + [eos_id]
        ids = (p + r)[:cutoff_len]
        labels = ([IGNORE_INDEX] * min(len(p), cutoff_len) +
                  r[:max(0, cutoff_len - len(p))])[:cutoff_len]
        rows.append((ids, labels))
    max_len = max(len(ids) for ids, _ in rows)
    n = len(rows)
    input_ids = np.full((n, max_len), pad_id, np.int32)
    labels = np.full((n, max_len), IGNORE_INDEX, np.int32)
    attn = np.zeros((n, max_len), np.int32)
    for i, (ids, lab) in enumerate(rows):
        input_ids[i, :len(ids)] = ids
        labels[i, :len(lab)] = lab
        attn[i, :len(ids)] = 1
    return {"input_ids": input_ids, "labels": labels,
            "attention_mask": attn}
