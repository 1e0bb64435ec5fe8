"""Offline dataset ingestion for the task library.

The reference vendors 13 HF dataset *builders*
(evaluation/lm_eval/datasets/, 1,959 LoC — drop/drop.py,
coqa/coqa.py, the headqa fix, …) so tasks can load corpora from local
files without hub access.  This module is this repository's equivalent,
one convention instead of 13 builders: a task named ``NAME`` loads its raw
rows (in the PUBLIC dataset schema each task's ``convert`` expects) from

    SOURCE_DIR/NAME/<split>.jsonl      one JSON object per line
    SOURCE_DIR/NAME/<split>.json       a JSON list of objects
    SOURCE_DIR/NAME/<split>.csv|.tsv   header row → dict per row
    SOURCE_DIR/NAME/<split>.parquet    via pyarrow (if installed)
    SOURCE_DIR/NAME/                   an HF ``save_to_disk`` dataset dir
                                       (loaded with datasets.load_from_disk)

Used by ``DocTask.from_source``.  With zero egress, any public corpus
exported to one of these forms evaluates end-to-end. A copy of
``onebit_tpu/eval/task_source.py``.
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Optional

from onebit_tpu_torch.eval import raw_formats

_EXTS = (".jsonl", ".json", ".csv", ".tsv", ".parquet")


def read_rows(path: str) -> List[dict]:
    """Rows from one file, by extension."""
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, list):
            raise ValueError(
                f"{path}: expected a JSON list of rows (original-"
                "distribution raw files are accepted when named per the "
                "corpus's published layout — see eval/raw_formats.py)")
        return data
    if path.endswith((".csv", ".tsv")):
        delim = "\t" if path.endswith(".tsv") else ","
        with open(path, newline="") as f:
            return list(csv.DictReader(f, delimiter=delim))
    if path.endswith(".parquet"):
        import pyarrow.parquet as pq
        return pq.read_table(path).to_pylist()
    raise ValueError(f"unsupported task-source file {path}; use one of "
                     f"{_EXTS}")


def _split_file(task_dir: str, split: str) -> Optional[str]:
    for ext in _EXTS:
        p = os.path.join(task_dir, split + ext)
        if os.path.exists(p):
            return p
    return None


def load_split(source_dir: str, name: str, split: str) -> List[dict]:
    """Rows for ``name``'s ``split`` under ``source_dir`` (see module
    docstring for the layout conventions)."""
    task_dir = os.path.join(source_dir, name)
    if not os.path.isdir(task_dir):
        raise FileNotFoundError(
            f"no local data for task {name!r}: expected directory "
            f"{task_dir} (file conventions: {_EXTS} per split, or an HF "
            f"save_to_disk dir)")
    p = _split_file(task_dir, split)
    if p is not None:
        try:
            return read_rows(p)
        except ValueError:
            # a <split>.json holding a raw (non-list) object: try the
            # task's original-format converter before giving up
            if p.endswith(".json"):
                with open(p) as f:
                    data = json.load(f)
                rows = raw_formats.convert_raw(name, data)
                if rows is not None:
                    return rows
            raise
    # original-distribution raw download dropped into the task dir
    # (e.g. drop/drop_dataset_dev.json, coqa/coqa-dev-v1.0.json)
    rows = raw_formats.load_raw_split(name, task_dir, split)
    if rows is not None:
        return rows
    # HF save_to_disk layouts: either the split is a sub-dataset dir, or
    # the task dir is a DatasetDict containing the split
    import datasets
    split_dir = os.path.join(task_dir, split)
    if os.path.isdir(split_dir):
        return list(datasets.load_from_disk(split_dir))
    ds = datasets.load_from_disk(task_dir)
    if split not in ds:
        raise FileNotFoundError(
            f"task {name!r}: no {split} split in {task_dir} "
            f"(have {list(ds)})")
    return list(ds[split])


def task_from_source(task_cls, name: str, source_dir: str, *,
                     split: Optional[str] = None,
                     with_train: bool = False):
    """Build a DocTask-style class from local files."""
    split = split or task_cls.DEFAULT_SPLIT
    rows = load_split(source_dir, name, split)
    train = None
    if with_train and task_cls.TRAIN_SPLIT:
        try:
            train = load_split(source_dir, name, task_cls.TRAIN_SPLIT)
        except FileNotFoundError:
            train = None   # few-shot pool falls back to eval docs
    return task_cls(rows, train)
