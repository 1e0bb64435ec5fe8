"""MMLU (hendrycks_test): 57 subjects + category aggregation.

Prompt format matches the reference task (hendrycks_test.py:129-151):
``Question: {q}\nChoices:\nA. ..\nB. ..\nC. ..\nD. ..\nAnswer:`` with the
raw choice strings as continuations.  Category rollups follow the standard
MMLU taxonomy (the reference vendors it as lm_eval/categories.py; the
aggregation loop is lm_eval.py:140-166: per-subject acc averaged into
subcategory → category → overall means). A copy of
``onebit_tpu/eval/tasks/mmlu.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from onebit_tpu_torch.eval.tasks.base import MCDoc
from onebit_tpu_torch.eval.tasks.suite import _DocListTask

# standard MMLU subject → subcategory taxonomy (Hendrycks et al., 2021)
SUBCATEGORIES: Dict[str, List[str]] = {
    "abstract_algebra": ["math"], "anatomy": ["health"],
    "astronomy": ["physics"], "business_ethics": ["business"],
    "clinical_knowledge": ["health"], "college_biology": ["biology"],
    "college_chemistry": ["chemistry"],
    "college_computer_science": ["computer science"],
    "college_mathematics": ["math"], "college_medicine": ["health"],
    "college_physics": ["physics"], "computer_security": ["computer science"],
    "conceptual_physics": ["physics"], "econometrics": ["economics"],
    "electrical_engineering": ["engineering"],
    "elementary_mathematics": ["math"], "formal_logic": ["philosophy"],
    "global_facts": ["other"], "high_school_biology": ["biology"],
    "high_school_chemistry": ["chemistry"],
    "high_school_computer_science": ["computer science"],
    "high_school_european_history": ["history"],
    "high_school_geography": ["geography"],
    "high_school_government_and_politics": ["politics"],
    "high_school_macroeconomics": ["economics"],
    "high_school_mathematics": ["math"],
    "high_school_microeconomics": ["economics"],
    "high_school_physics": ["physics"],
    "high_school_psychology": ["psychology"],
    "high_school_statistics": ["math"],
    "high_school_us_history": ["history"],
    "high_school_world_history": ["history"], "human_aging": ["health"],
    "human_sexuality": ["culture"], "international_law": ["law"],
    "jurisprudence": ["law"], "logical_fallacies": ["philosophy"],
    "machine_learning": ["computer science"], "management": ["business"],
    "marketing": ["business"], "medical_genetics": ["health"],
    "miscellaneous": ["other"], "moral_disputes": ["philosophy"],
    "moral_scenarios": ["philosophy"], "nutrition": ["health"],
    "philosophy": ["philosophy"], "prehistory": ["history"],
    "professional_accounting": ["other"], "professional_law": ["law"],
    "professional_medicine": ["health"],
    "professional_psychology": ["psychology"],
    "public_relations": ["politics"], "security_studies": ["politics"],
    "sociology": ["culture"], "us_foreign_policy": ["politics"],
    "virology": ["health"], "world_religions": ["philosophy"],
}

CATEGORIES: Dict[str, List[str]] = {
    "STEM": ["physics", "chemistry", "biology", "computer science", "math",
             "engineering"],
    "humanities": ["history", "philosophy", "law"],
    "social sciences": ["politics", "culture", "economics", "geography",
                        "psychology"],
    "other (business, health, misc.)": ["other", "business", "health"],
}

SUBJECTS = sorted(SUBCATEGORIES)


class MMLUSubject(_DocListTask):
    DATASET_PATH, DATASET_NAME, DEFAULT_SPLIT = "cais/mmlu", None, "test"
    KEYS = ["A", "B", "C", "D"]

    def __init__(self, raw_docs: Sequence[dict], subject: str):
        super().__init__(raw_docs)
        self.subject = subject
        self.name = f"hendrycksTest-{subject}"

    def convert(self, d):
        prompt = "Question: " + d["question"] + "\nChoices:\n"
        prompt += "".join(f"{k}. {c}\n"
                          for k, c in zip(self.KEYS, d["choices"]))
        prompt += "Answer:"
        gold = (self.KEYS.index(d["answer"])
                if isinstance(d["answer"], str) else int(d["answer"]))
        return MCDoc(query=prompt, choices=list(d["choices"]),
                     gold=gold)


def aggregate_mmlu(results: Dict[str, Dict]) -> Dict[str, float]:
    """Per-subject acc → subcategory/category/overall means
    (reference lm_eval.py:140-166)."""
    cat_cors = {c: [] for c in CATEGORIES}
    all_cors = []
    for key, metrics in results.items():
        if "hendrycksTest" not in key:
            continue
        subject = key.split("-", 1)[-1]
        acc = metrics["acc"]
        for subcat in SUBCATEGORIES.get(subject, []):
            for cat, subcats in CATEGORIES.items():
                if subcat in subcats:
                    cat_cors[cat].append(acc)
            all_cors.append(acc)
    out = {f"category:{c}": float(np.mean(v)) for c, v in cat_cors.items()
           if v}
    if all_cors:
        out["mmlu_average"] = float(np.mean(all_cors))
    return out
