"""The zero-shot benchmark suite — prompt formats bit-identical to the
reference task modules (evaluation/lm_eval/tasks/*).

Each task converts its public dataset schema into MCDocs.  Data comes from
an injected doc list or from HF ``datasets`` when available (offline-first:
the constructor takes ``raw_docs``; ``from_datasets`` is the convenience
loader used when the corpus is on disk).

Formats (cited):
* PIQA (piqa.py:52-63): "Question: {goal}\\nAnswer:"; choices " {sol}".
* ARC-e/c (arc.py:54-67): "Question: {question}\\nAnswer:"; numeric answer
  keys remapped to letters.
* BoolQ (superglue.py:57-75): "{passage}\\nQuestion: {question}?\\nAnswer:";
  choices " no"/" yes" (label 1 = yes).
* HellaSwag (hellaswag.py:52-68): "{activity_label}: {ctx_a} {Ctx_b}" with
  the bracket/title scrubbing preprocess.
* Winogrande (winogrande.py:56-104): *partial evaluation* — per-option
  context "…option" and fixed continuation " {suffix}".
* LAMBADA (lambada.py): greedy last-word prediction scored by
  loglikelihood + is_greedy accuracy.

A copy of ``onebit_tpu/eval/tasks/suite.py``: the same prompts, requests
and metrics.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from onebit_tpu_torch.eval.tasks.base import (
    DocTask,
    MCDoc,
    MultipleChoiceTask,
    perplexity,
)


class _DocListTask(MultipleChoiceTask, DocTask):
    """Injectable multiple-choice task (docs convert to :class:`MCDoc`)."""

    def convert(self, doc: dict) -> MCDoc:
        raise NotImplementedError


class PIQA(_DocListTask):
    name = "piqa"
    DATASET_PATH, DATASET_NAME, DEFAULT_SPLIT = "piqa", None, "validation"

    def convert(self, d):
        return MCDoc(query="Question: " + d["goal"] + "\nAnswer:",
                     choices=[d["sol1"], d["sol2"]],
                     gold=int(d["label"]))


class ARCEasy(_DocListTask):
    name = "arc_easy"
    DATASET_PATH, DATASET_NAME = "ai2_arc", "ARC-Easy"
    DEFAULT_SPLIT = "test"

    def convert(self, d):
        num_to_letter = {"1": "A", "2": "B", "3": "C", "4": "D", "5": "E"}
        key = num_to_letter.get(d["answerKey"], d["answerKey"])
        return MCDoc(query="Question: " + d["question"] + "\nAnswer:",
                     choices=list(d["choices"]["text"]),
                     gold=["A", "B", "C", "D", "E"].index(key))


class ARCChallenge(ARCEasy):
    name = "arc_challenge"
    DATASET_NAME = "ARC-Challenge"


class BoolQ(_DocListTask):
    name = "boolq"
    DATASET_PATH, DATASET_NAME, DEFAULT_SPLIT = "super_glue", "boolq", \
        "validation"

    def convert(self, d):
        return MCDoc(
            query=f"{d['passage']}\nQuestion: {d['question']}?\nAnswer:",
            choices=["no", "yes"], gold=int(d["label"]))

    def process_results(self, doc, results):
        # reference BoolQ reports only acc (ll_yes vs ll_no comparison,
        # superglue.py:70-75)
        lls = np.asarray([r[0] for r in results])
        return {"acc": float(np.argmax(lls) == doc.gold)}

    def higher_is_better(self):
        return {"acc": True}


class HellaSwag(_DocListTask):
    name = "hellaswag"
    DATASET_PATH, DATASET_NAME, DEFAULT_SPLIT = "hellaswag", None, \
        "validation"

    @staticmethod
    def _preprocess(text: str) -> str:
        text = text.strip()
        text = text.replace(" [title]", ". ")
        text = re.sub("\\[.*?\\]", "", text)
        text = text.replace("  ", " ")
        return text

    def convert(self, d):
        ctx = d["ctx_a"] + " " + d["ctx_b"].capitalize()
        return MCDoc(
            query=self._preprocess(d["activity_label"] + ": " + ctx),
            choices=[self._preprocess(e) for e in d["endings"]],
            gold=int(d["label"]))


class Winogrande(_DocListTask):
    """Partial evaluation (reference winogrande.py:56-104): the option is
    substituted into the context and the fixed suffix is the continuation;
    few-shot contexts render with the *correct* option (doc_to_text) and
    ``append_context`` swaps in each candidate at request time."""
    name = "winogrande"
    DATASET_PATH, DATASET_NAME, DEFAULT_SPLIT = "winogrande", \
        "winogrande_xl", "validation"

    def convert(self, d):
        return {"sentence": d["sentence"], "option1": d["option1"],
                "option2": d["option2"], "gold": int(d["answer"]) - 1}

    @staticmethod
    def partial_context(doc, option: str) -> str:
        loc = doc["sentence"].index("_")
        return doc["sentence"][:loc] + option

    @staticmethod
    def partial_target(doc) -> str:
        loc = doc["sentence"].index("_") + 1
        return " " + doc["sentence"][loc:].strip()

    def doc_to_text(self, doc):
        return self.partial_context(
            doc, doc["option1" if doc["gold"] == 0 else "option2"])

    def doc_to_target(self, doc):
        return self.partial_target(doc)

    def doc_to_decontamination_query(self, doc):
        return doc["sentence"]

    @classmethod
    def append_context(cls, ctx: str, partial_ctx: str) -> str:
        parts = ctx.split("\n\n")  # few-shot examples are \n\n-separated
        parts.pop()                # drop the doc_to_text (correct-option) ctx
        return "\n\n".join([*parts, partial_ctx]) if parts else partial_ctx

    def construct_requests(self, doc, ctx):
        target = self.partial_target(doc)
        return [(self.append_context(ctx, self.partial_context(doc, doc[o])),
                 target) for o in ("option1", "option2")]

    def process_results(self, doc, results):
        lls = np.asarray([r[0] for r in results])
        return {"acc": float(np.argmax(lls) == doc["gold"])}

    def higher_is_better(self):
        return {"acc": True}


class Lambada(_DocListTask):
    """Last-word prediction: ppl over the target + greedy-exact accuracy
    (reference lambada.py LambadaBase)."""
    name = "lambada_openai"
    DATASET_PATH, DATASET_NAME, DEFAULT_SPLIT = "EleutherAI/lambada_openai", \
        "en", "test"

    def convert(self, d):
        return {"text": d["text"]}

    def doc_to_text(self, doc):
        return doc["text"].rsplit(" ", 1)[0]

    def doc_to_target(self, doc):
        return " " + doc["text"].rsplit(" ", 1)[1]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["text"]

    def construct_requests(self, doc, ctx):
        return [(ctx, self.doc_to_target(doc))]

    def process_results(self, doc, results):
        ll, greedy = results[0]
        return {"ppl": float(ll), "acc": float(greedy)}

    def aggregation(self):
        return {"ppl": perplexity}

    def higher_is_better(self):
        return {"ppl": False, "acc": True}


TASK_REGISTRY = {
    "piqa": PIQA,
    "arc_easy": ARCEasy,
    "arc_challenge": ARCChallenge,
    "boolq": BoolQ,
    "hellaswag": HellaSwag,
    "winogrande": Winogrande,
    "lambada_openai": Lambada,
}

# MMLU (hendrycks_test) category aggregation (reference categories.py +
# lm_eval.py:140-166) is provided by mmlu.py.
