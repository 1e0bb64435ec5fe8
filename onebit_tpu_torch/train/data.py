"""KD data: token blocks and the batches the train step takes.

The numpy part of ``onebit_tpu/train/data.py``, copied so that the port
imports nothing of the JAX package: ``chunk_tokens`` (the reference's
tokenize-concat-chunk, dsets.py:170-191), ``split_dataset`` (dsets.py:42-63)
and ``batch_iterator``, with the JAX module's numpy random streams, so both
packages draw the same batches for a seed. Labels equal the input ids (HF
CLM collator semantics, kd.py:207). Loading a registered text dataset and
tokenizing it wait for ``train/templates.py`` and a Hugging Face tokenizer,
which the repository does not hold: :func:`prepare_kd_dataset` raises.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

TEXT_DATASETS_WAIT_FOR = ("train/templates.py and a Hugging Face tokenizer "
                          "(transformers), which the repository does not "
                          "hold; pass pre-tokenized blocks (--tokens "
                          "BLOCKS.npy)")


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


def prepare_kd_dataset(*args, **kwargs) -> np.ndarray:
    """Texts -> token blocks: not ported yet."""
    raise NotImplementedError(
        f"text datasets are not ported yet: they wait for "
        f"{TEXT_DATASETS_WAIT_FOR}")


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
