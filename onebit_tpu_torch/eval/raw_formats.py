"""Original-distribution-format parsers for offline task ingestion.

Task sources need not hold rows flattened to the public (HF-hub) schema:
the reference's 13 vendored builders parse the corpora's NATIVE files —
DROP's nested section dict (reference
evaluation/lm_eval/datasets/drop/drop.py:146-192), CoQA's ``data`` list
with per-turn answer columns (coqa/coqa.py:182-232), TriviaQA's
``Data``/``Answer.Aliases`` (triviaqa/triviaqa.py:120-157), HeadQA's
``exams`` tree (headqa/headqa.py:133-162), and SQuAD's
``data→paragraphs→qas`` nesting.  This module gives each such family a
parser from the UNTOUCHED raw download to the rows each task's
``convert``/``doc_to_text`` expects, so pointing a task source at an
original ``drop_dataset_dev.json`` (etc.) evaluates end-to-end.

It covers every other reference-vendored builder too: ASDiv's repo-zip
XML (asdiv/asdiv.py:101-111), the MATH per-problem json directories
(hendrycks_math.py:111-122), LogiQA's 4+-line txt records
(logiqa/logiqa.py:111-126), the ETHICS per-subset csvs
(hendrycks_ethics.py:178-231), MuTual's per-example txt dirs
(mutual/mutual.py:117-136), QuAC's first-paragraph qas
(quac/quac.py:100-117), the SAT analogy package txt
(sat_analogies.py:103-130), and the unscramble ``.jsonl.gz`` corpora
(unscramble.py:103-110).  Pile needs none (its task reads the published
``.jsonl.zst`` directly).

Wired into :mod:`onebit_tpu_torch.eval.task_source`: ``load_split``
first tries the flattened conventions, then falls back to these
converters — by content shape for a ``<split>.json`` that holds a raw
(non-list) object, and by original filename (``_SPLIT_FILES``) when the
task dir simply contains the raw download. A copy of
``onebit_tpu/eval/raw_formats.py``.
"""

from __future__ import annotations

import csv
import functools
import gzip
import json
import os
from typing import Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# DROP — raw: {section_id: {passage, qa_pairs: [{question, query_id,
# answer{number, date{day,month,year}, spans}, validated_answers?}]}}
# ---------------------------------------------------------------------------


def _drop_answer(a: dict) -> dict:
    date = a.get("date") or {}
    return {
        "number": str(a.get("number", "")),
        "date": {"day": str(date.get("day", "")),
                 "month": str(date.get("month", "")),
                 "year": str(date.get("year", ""))},
        "spans": list(a.get("spans", [])),
    }


def drop_to_rows(data: dict) -> List[dict]:
    rows = []
    for section_id, example in data.items():
        for qa in example["qa_pairs"]:
            va = [_drop_answer(v) for v in qa.get("validated_answers", [])]
            rows.append({
                "section_id": section_id,
                "passage": example["passage"],
                "question": qa["question"],
                "query_id": qa["query_id"],
                "answer": _drop_answer(qa["answer"]),
                # columnar (HF Sequence-of-struct) form — what
                # tasks.generation.DROP.get_answers indexes
                "validated_answers": {
                    "number": [v["number"] for v in va],
                    "date": [v["date"] for v in va],
                    "spans": [v["spans"] for v in va],
                },
            })
    return rows


def _is_drop(data) -> bool:
    if not isinstance(data, dict) or not data:
        return False
    v = next(iter(data.values()))
    return isinstance(v, dict) and "qa_pairs" in v


# ---------------------------------------------------------------------------
# CoQA — raw: {"data": [{id, source, story, questions: [{input_text,
# turn_id}], answers: [...], additional_answers?: {"0": [...], ...}}]}
# ---------------------------------------------------------------------------


def _coqa_cols(turns: List[dict]) -> dict:
    return {"input_text": [t["input_text"] for t in turns],
            "turn_id": [t["turn_id"] for t in turns]}


def coqa_to_rows(data: dict) -> List[dict]:
    rows = []
    for row in data["data"]:
        out = {
            "id": row["id"],
            "source": row.get("source", ""),
            "story": row["story"],
            "questions": _coqa_cols(row["questions"]),
            "answers": _coqa_cols(row["answers"]),
        }
        extra = row.get("additional_answers")
        if extra:
            out["additional_answers"] = {
                k: _coqa_cols(v) for k, v in extra.items()}
        rows.append(out)
    return rows


def _is_coqa(data) -> bool:
    if not isinstance(data, dict) or not isinstance(data.get("data"), list):
        return False
    d = data["data"]
    return bool(d) and isinstance(d[0], dict) and "story" in d[0] \
        and "questions" in d[0]


# ---------------------------------------------------------------------------
# SQuAD v1/v2 — raw: {"data": [{title, paragraphs: [{context, qas:
# [{id, question, answers: [{text, answer_start}], is_impossible?}]}]}]}
# ---------------------------------------------------------------------------


def squad_to_rows(data: dict) -> List[dict]:
    rows = []
    for article in data["data"]:
        title = article.get("title", "")
        for para in article["paragraphs"]:
            context = para["context"]
            for qa in para["qas"]:
                answers = qa.get("answers", [])
                rows.append({
                    "id": qa["id"],
                    "title": title,
                    "context": context,
                    "question": qa["question"],
                    "answers": {
                        "text": [a["text"] for a in answers],
                        "answer_start": [a["answer_start"]
                                         for a in answers],
                    },
                })
    return rows


def _is_squad(data) -> bool:
    if not isinstance(data, dict) or not isinstance(data.get("data"), list):
        return False
    d = data["data"]
    return bool(d) and isinstance(d[0], dict) and "paragraphs" in d[0]


# ---------------------------------------------------------------------------
# TriviaQA — raw: {"Data": [{Question, QuestionId, QuestionSource,
# Answer: {Value, Aliases, ...}, ...}]}
# ---------------------------------------------------------------------------


def triviaqa_to_rows(data: dict) -> List[dict]:
    rows = []
    for d in data["Data"]:
        ans = d.get("Answer", {})
        rows.append({
            "question_id": d.get("QuestionId", ""),
            "question_source": d.get("QuestionSource", ""),
            "question": d["Question"],
            "answer": {"value": ans.get("Value", ""),
                       "aliases": list(ans.get("Aliases", []))},
        })
    return rows


def _is_triviaqa(data) -> bool:
    if not isinstance(data, dict) or not isinstance(data.get("Data"), list):
        return False
    d = data["Data"]
    return bool(d) and isinstance(d[0], dict) and "Question" in d[0]


# ---------------------------------------------------------------------------
# HeadQA — raw: {"exams": {exam_name: {name, year, category, data:
# [{qid, qtext, ra, answers: [{aid, atext}]}]}}}
# ---------------------------------------------------------------------------


def headqa_to_rows(data: dict) -> List[dict]:
    rows = []
    for exam_id, exam in enumerate(data["exams"].values()):
        for q in exam["data"]:
            rows.append({
                "name": exam["name"].strip(),
                "year": str(exam["year"]).strip(),
                "category": exam["category"].strip(),
                "qid": int(str(q["qid"]).strip()),
                "qtext": q["qtext"].strip(),
                "ra": int(str(q["ra"]).strip()),
                "answers": [{"aid": a["aid"],
                             "atext": a["atext"].strip()}
                            for a in q["answers"]],
            })
    return rows


def _is_headqa(data) -> bool:
    return isinstance(data, dict) and isinstance(data.get("exams"), dict)


# ---------------------------------------------------------------------------
# QuAC — raw: {"data": [{title, section_title, paragraphs: [{context,
# qas: [{question, answers: [{text}]}]}]}]} (reference
# evaluation/lm_eval/datasets/quac/quac.py:100-117: first paragraph only,
# CANNOTANSWER stripped from the context, first answer per question)
# ---------------------------------------------------------------------------


def quac_to_rows(data: dict) -> List[dict]:
    rows = []
    for row in data["data"]:
        para = row["paragraphs"][0]
        context = para["context"].replace("CANNOTANSWER", "")
        for qa in para["qas"]:
            rows.append({
                "title": row["title"],
                "section_title": row["section_title"],
                "paragraph": context,
                "question": qa["question"],
                "answer": qa["answers"][0]["text"],
            })
    return rows


def _is_quac(data) -> bool:
    if not isinstance(data, dict) or not isinstance(data.get("data"), list):
        return False
    d = data["data"]
    return bool(d) and isinstance(d[0], dict) and "section_title" in d[0]


# ---------------------------------------------------------------------------
# File/dir-based raw loaders (non-JSON original distributions):
# ASDiv XML, LogiQA txt records, SAT-package txt, MuTual per-example txt
# dirs, MATH per-problem json dirs, ETHICS csv, unscramble jsonl(.gz)
# ---------------------------------------------------------------------------


def asdiv_file_to_rows(path: str) -> List[dict]:
    """ASDiv.xml → rows (reference datasets/asdiv/asdiv.py:101-111)."""
    import xml.etree.ElementTree as ET
    root = ET.parse(path).getroot()
    return [{
        "body": p.findtext("Body"),
        "question": p.findtext("Question"),
        "solution_type": p.findtext("Solution-Type"),
        "answer": p.findtext("Answer"),
        "formula": p.findtext("Formula"),
    } for p in root.iter("Problem")]


def logiqa_file_to_rows(path: str) -> List[dict]:
    """Train/Eval/Test.txt → rows: blank-line-separated records of
    (label, context, question, options a-d); '.'→'. ' normalization and
    the 2-char option prefix strip follow the reference builder
    (datasets/logiqa/logiqa.py:111-126) — the row text IS the prompt
    contract."""
    def norm(t: str) -> str:
        return t.replace(".", ". ").strip()

    with open(path, encoding="utf-8") as f:
        blocks = f.read().strip().split("\n\n")
    rows = []
    for block in blocks:
        lines = block.split("\n")
        rows.append({
            "label": lines[0].strip(),
            "context": norm(lines[1]),
            "question": norm(lines[2]),
            "options": [norm(o[2:]) for o in lines[3:]],
        })
    return rows


def sat_file_to_rows(path: str) -> List[dict]:
    """SAT-package-V3.txt → rows: '#' comments skipped, blank-line-
    separated records whose last 8 lines are source, stem, 5 choices,
    solution (datasets/sat_analogies/sat_analogies.py:103-130)."""
    records, record = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                if record:
                    records.append(record)
                    record = []
            elif line.startswith("#"):
                continue
            else:
                record.append(line)
    if record:
        records.append(record)
    return [{"source": r[-8], "stem": r[-7], "choices": r[-6:-1],
             "solution": r[-1]} for r in records]


def mutual_dir_to_rows(path: str) -> List[dict]:
    """MuTual split dir (data/<config>/<split>/*.txt, one JSON object per
    file; occasional empty files skipped) → rows
    (datasets/mutual/mutual.py:117-136)."""
    rows = []
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".txt"):
            continue
        with open(os.path.join(path, fname), encoding="utf-8") as f:
            s = f.read()
        if not s:
            continue
        d = json.loads(s)
        rows.append({"answers": d["answers"], "options": d["options"],
                     "article": d["article"], "id": d["id"]})
    return rows


def math_dir_to_rows(path: str) -> List[dict]:
    """MATH category dir (MATH/<split>/<category>/*.json, one problem per
    file) → rows (datasets/hendrycks_math/hendrycks_math.py:111-122)."""
    rows = []
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(path, fname), encoding="utf-8") as f:
            d = json.load(f)
        rows.append({"problem": d["problem"], "level": d["level"],
                     "type": d["type"], "solution": d["solution"]})
    return rows


def ethics_file_to_rows(path: str, config: str) -> List[dict]:
    """ETHICS csv → rows with the reference's per-subset semantics
    (datasets/hendrycks_ethics/hendrycks_ethics.py:178-231): 4-doc
    group_ids for deontology/justice, 5-doc for virtue (whose scenario
    column splits on ' [SEP] ' into scenario/trait), headerless
    activity/baseline csv for utilitarianism."""
    with open(path, newline="", encoding="utf-8") as f:
        if config == "utilitarianism":
            reader = csv.DictReader(f, fieldnames=["activity", "baseline"])
        else:
            reader = csv.DictReader(f)
        rows = []
        for key, row in enumerate(reader):
            if config == "commonsense":
                rows.append({"label": row["label"], "input": row["input"],
                             "is_short": row["is_short"],
                             "edited": row["edited"]})
            elif config == "deontology":
                rows.append({"group_id": key // 4, "label": row["label"],
                             "scenario": row["scenario"],
                             "excuse": row["excuse"]})
            elif config == "justice":
                rows.append({"group_id": key // 4, "label": row["label"],
                             "scenario": row["scenario"]})
            elif config == "virtue":
                scenario, trait = row["scenario"].split(" [SEP] ")
                rows.append({"group_id": key // 5, "label": row["label"],
                             "scenario": scenario, "trait": trait})
            elif config == "utilitarianism":
                rows.append({"activity": row["activity"],
                             "baseline": row["baseline"], "rating": ""})
            else:
                raise ValueError(f"unknown ethics subset {config!r}")
    return rows


def jsonl_file_to_rows(path: str) -> List[dict]:
    """jsonl or jsonl.gz (the unscramble corpora ship as
    <config>.jsonl.gz) → rows."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# registry + dispatch
# ---------------------------------------------------------------------------

# task name → (shape detector, converter)
_CONVERTERS: Dict[str, tuple] = {
    "drop": (_is_drop, drop_to_rows),
    "coqa": (_is_coqa, coqa_to_rows),
    "squad2": (_is_squad, squad_to_rows),
    "triviaqa": (_is_triviaqa, triviaqa_to_rows),
    "headqa_en": (_is_headqa, headqa_to_rows),
    "headqa_es": (_is_headqa, headqa_to_rows),
    "quac": (_is_quac, quac_to_rows),
}

# MATH registry-name → raw category dir (reference BUILDER_CONFIGS)
_MATH_CATEGORIES = {
    "math_algebra": "algebra",
    "math_counting_and_prob": "counting_and_probability",
    "math_geometry": "geometry",
    "math_intermediate_algebra": "intermediate_algebra",
    "math_num_theory": "number_theory",
    "math_prealgebra": "prealgebra",
    "math_precalc": "precalculus",
}

# ETHICS registry-name → (raw config dir, file prefix)
_ETHICS_CONFIGS = {
    "ethics_cm": ("commonsense", "cm"),
    "ethics_deontology": ("deontology", "deontology"),
    "ethics_justice": ("justice", "justice"),
    "ethics_utilitarianism": ("utilitarianism", "util"),
    "ethics_utilitarianism_original": ("utilitarianism", "util"),
    "ethics_virtue": ("virtue", "virtue"),
}

# unscramble registry-name → published corpus file stem
_UNSCRAMBLE_FILES = {
    "anagrams1": "mid_word_1_anagrams",
    "anagrams2": "mid_word_2_anagrams",
    "cycle_letters": "cycle_letters_in_word",
    "random_insertion": "random_insertion_in_word",
    "reversed_words": "reversed_words",
}

# task name → loader(path) for non-JSON / directory-shaped raw downloads
_RAW_LOADERS: Dict[str, Callable[[str], List[dict]]] = {
    "math_asdiv": asdiv_file_to_rows,
    "logiqa": logiqa_file_to_rows,
    "sat": sat_file_to_rows,
    "mutual": mutual_dir_to_rows,
    "mutual_plus": mutual_dir_to_rows,
}
for _name in _MATH_CATEGORIES:
    _RAW_LOADERS[_name] = math_dir_to_rows
for _name, (_cfg, _) in _ETHICS_CONFIGS.items():
    _RAW_LOADERS[_name] = functools.partial(ethics_file_to_rows,
                                            config=_cfg)
for _name in _UNSCRAMBLE_FILES:
    _RAW_LOADERS[_name] = jsonl_file_to_rows

# task name → split → original-distribution filename candidates (as the
# corpora are published; the reference's _split_generators point at the
# same names after extraction)
_SPLIT_FILES: Dict[str, Dict[str, List[str]]] = {
    "drop": {
        "train": ["drop_dataset_train.json"],
        "validation": ["drop_dataset_dev.json"],
    },
    "coqa": {
        "train": ["coqa-train-v1.0.json"],
        "validation": ["coqa-dev-v1.0.json"],
    },
    "squad2": {
        "train": ["train-v2.0.json"],
        "validation": ["dev-v2.0.json"],
    },
    "triviaqa": {
        "train": ["unfiltered-web-train.json", "wikipedia-train.json",
                  "web-train.json"],
        "validation": ["unfiltered-web-dev.json", "wikipedia-dev.json",
                       "web-dev.json"],
    },
    "headqa_en": {
        "train": ["train_HEAD_EN.json"],
        "validation": ["dev_HEAD_EN.json"],
        "test": ["test_HEAD_EN.json"],
    },
    "headqa_es": {
        "train": ["train_HEAD.json"],
        "validation": ["dev_HEAD.json"],
        "test": ["test_HEAD.json"],
    },
    "quac": {
        "train": ["train_v0.2.json"],
        "validation": ["val_v0.2.json"],
    },
    # ASDiv ships inside the repo zip under dataset/; candidates are path
    # SUFFIXES searched recursively, so the extracted nesting
    # nlu-asdiv-dataset-<sha>/dataset/ASDiv.xml resolves untouched
    "math_asdiv": {
        "validation": [os.path.join("dataset", "ASDiv.xml"), "ASDiv.xml"],
    },
    "logiqa": {
        "train": ["Train.txt"],
        "validation": ["Eval.txt"],
        "test": ["Test.txt"],
    },
    "sat": {
        "validation": ["SAT-package-V3.txt"],
    },
}

# MuTual: the split is a DIRECTORY of per-example txt files
# (MuTual-master/data/<config>/<split>/)
for _name in ("mutual", "mutual_plus"):
    _SPLIT_FILES[_name] = {
        split: [os.path.join("data", _name, d), os.path.join(_name, d), d]
        for split, d in (("train", "train"), ("validation", "dev"),
                         ("test", "test"))
    }

# MATH: the split is a category DIRECTORY of per-problem json files
# (MATH/<split>/<category>/)
for _name, _cat in _MATH_CATEGORIES.items():
    _SPLIT_FILES[_name] = {
        split: [os.path.join("MATH", split, _cat),
                os.path.join(split, _cat)]
        for split in ("train", "test")
    }

# ETHICS: ethics/<config>/<prefix>_<split>.csv
for _name, (_cfg, _prefix) in _ETHICS_CONFIGS.items():
    _SPLIT_FILES[_name] = {
        split: [os.path.join("ethics", _cfg, f"{_prefix}_{split}.csv"),
                os.path.join(_cfg, f"{_prefix}_{split}.csv"),
                f"{_prefix}_{split}.csv"]
        for split in ("train", "test")
    }

# unscramble: <published stem>.jsonl(.gz), validation only
for _name, _stem in _UNSCRAMBLE_FILES.items():
    _SPLIT_FILES[_name] = {
        "validation": [f"{_stem}.jsonl", f"{_stem}.jsonl.gz"],
    }


def convert_raw(name: str, data) -> Optional[List[dict]]:
    """Rows from an already-parsed raw JSON object, or None if ``name``
    has no raw converter / the shape does not match."""
    entry = _CONVERTERS.get(name)
    if entry is None:
        return None
    detect, conv = entry
    if not detect(data):
        return None
    return conv(data)


def find_raw_file(name: str, task_dir: str, split: str) -> Optional[str]:
    """Path of an original-distribution file OR directory for (task,
    split) inside ``task_dir``.  Candidates are path SUFFIXES (e.g.
    ``dataset/ASDiv.xml``, ``MATH/test/algebra``) searched recursively —
    raw archives extract into arbitrarily nested folders
    (``nlu-asdiv-dataset-<sha>/…``, ``MuTual-master/data/…``).  Earlier
    candidates and shallower paths win.  Returns None if absent."""
    candidates = _SPLIT_FILES.get(name, {}).get(split, [])
    if not candidates or not os.path.isdir(task_dir):
        return None
    hits = []   # (candidate priority, depth, path)
    for dirpath, dirnames, _filenames in os.walk(task_dir):
        depth = os.path.relpath(dirpath, task_dir).count(os.sep)
        if depth > 6:
            dirnames[:] = []
            continue
        for rank, cand in enumerate(candidates):
            p = os.path.join(dirpath, cand)
            if os.path.exists(p):
                hits.append((rank, depth, p))
    if not hits:
        return None
    hits.sort(key=lambda h: (h[0], h[1]))
    return hits[0][2]


def load_raw_split(name: str, task_dir: str,
                   split: str) -> Optional[List[dict]]:
    """Rows for (task, split) from an original raw download under
    ``task_dir``, or None if no recognized raw file is present.  JSON
    shapes route through :func:`convert_raw`; the non-JSON corpora (XML,
    txt, csv, jsonl(.gz), per-example directories) through their
    task-specific ``_RAW_LOADERS`` entry."""
    p = find_raw_file(name, task_dir, split)
    if p is None:
        return None
    loader = _RAW_LOADERS.get(name)
    if loader is not None:
        return loader(p)
    with open(p, encoding="utf-8") as f:
        data = json.load(f)
    rows = convert_raw(name, data)
    if rows is None:
        raise ValueError(
            f"{p} matched task {name!r}'s raw filename convention but its "
            f"content shape is not the expected original format")
    return rows
