"""GLUE tasks (reference evaluation/lm_eval/tasks/glue.py) — prompt formats
byte-identical to the reference for score parity.

Registry names: cola, sst, mnli, mnli_mismatched, mrpc, rte, qnli, qqp, wnli.

A copy of ``onebit_tpu/eval/tasks/glue.py`` with its imports pointed at the
port; its optional imports stay lazy, where the JAX module has them.
"""

from __future__ import annotations

import numpy as np

from onebit_tpu_torch.eval.tasks.base import DocTask
from onebit_tpu_torch.eval.tasks.metrics import (
    f1_score,
    general_detokenize,
    matthews_corrcoef,
    yesno,
)


class CoLA(DocTask):
    """reference glue.py CoLA: mcc over yes/no loglikelihoods."""
    name = "cola"
    DATASET_PATH, DATASET_NAME = "glue", "cola"

    def doc_to_text(self, doc):
        return "{}\nQuestion: Does this sentence make sense?\nAnswer:".format(
            doc["sentence"])

    def doc_to_target(self, doc):
        return " {}".format({1: "yes", 0: "no"}[doc["label"]])

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["sentence"]

    def construct_requests(self, doc, ctx):
        return [(ctx, " yes"), (ctx, " no")]

    def process_results(self, doc, results):
        ll_yes, ll_no = results[0][0], results[1][0]
        return {"mcc": (doc["label"], ll_yes > ll_no)}

    def aggregation(self):
        return {"mcc": matthews_corrcoef}

    def higher_is_better(self):
        return {"mcc": True}


class SST(DocTask):
    """reference glue.py SST (sst2): positive/negative."""
    name = "sst"
    DATASET_PATH, DATASET_NAME = "glue", "sst2"

    def doc_to_text(self, doc):
        return ("{}\nQuestion: Is this sentence positive or negative?"
                "\nAnswer:").format(general_detokenize(doc["sentence"]))

    def doc_to_target(self, doc):
        return " {}".format({1: "positive", 0: "negative"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [(ctx, " positive"), (ctx, " negative")]

    def process_results(self, doc, results):
        pred = results[0][0] > results[1][0]
        return {"acc": float(pred == doc["label"])}

    def higher_is_better(self):
        return {"acc": True}


class MNLI(DocTask):
    """reference glue.py MNLI: True/Neither/False 3-way."""
    name = "mnli"
    DATASET_PATH, DATASET_NAME = "glue", "mnli"
    DEFAULT_SPLIT = "validation_matched"

    def doc_to_text(self, doc):
        hyp = doc["hypothesis"].strip()
        return "{}\nQuestion: {} True, False or Neither?\nAnswer:".format(
            doc["premise"], hyp + ("" if hyp.endswith(".") else "."))

    def doc_to_target(self, doc):
        return " {}".format({0: "True", 1: "Neither", 2: "False"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [(ctx, " True"), (ctx, " Neither"), (ctx, " False")]

    def process_results(self, doc, results):
        pred = int(np.argmax([r[0] for r in results]))
        return {"acc": float(pred == doc["label"])}

    def higher_is_better(self):
        return {"acc": True}


class MNLIMismatched(MNLI):
    name = "mnli_mismatched"
    DEFAULT_SPLIT = "validation_mismatched"


class MRPC(DocTask):
    """reference glue.py MRPC: acc + binary F1 over yes/no."""
    name = "mrpc"
    DATASET_PATH, DATASET_NAME = "glue", "mrpc"

    def doc_to_text(self, doc):
        return ("Sentence 1: {}\nSentence 2: {}\nQuestion: Do both sentences "
                "mean the same thing?\nAnswer:").format(
            general_detokenize(doc["sentence1"]),
            general_detokenize(doc["sentence2"]))

    def doc_to_target(self, doc):
        return " {}".format(yesno(doc["label"]))

    def construct_requests(self, doc, ctx):
        return [(ctx, " yes"), (ctx, " no")]

    def process_results(self, doc, results):
        pred = results[0][0] > results[1][0]
        return {"acc": float(pred == doc["label"]),
                "f1": (doc["label"], pred)}

    def aggregation(self):
        return {"f1": f1_score}

    def higher_is_better(self):
        return {"acc": True, "f1": True}


class RTE(DocTask):
    """reference glue.py RTE: label 0 = entailment = True."""
    name = "rte"
    DATASET_PATH, DATASET_NAME = "glue", "rte"

    def doc_to_text(self, doc):
        return "{}\nQuestion: {} True or False?\nAnswer:".format(
            doc["sentence1"], doc["sentence2"])

    def doc_to_target(self, doc):
        return " {}".format({0: "True", 1: "False"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [(ctx, " True"), (ctx, " False")]

    def process_results(self, doc, results):
        # pred = ll_false > ll_true matches label encoding 1 = not-entailment
        pred = results[1][0] > results[0][0]
        return {"acc": float(pred == doc["label"])}

    def higher_is_better(self):
        return {"acc": True}


class QNLI(DocTask):
    name = "qnli"
    DATASET_PATH, DATASET_NAME = "glue", "qnli"

    def doc_to_text(self, doc):
        return ("{}\n{}\nQuestion: Does this response answer the question?"
                "\nAnswer:").format(doc["question"], doc["sentence"])

    def doc_to_target(self, doc):
        return " {}".format({0: "yes", 1: "no"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [(ctx, " yes"), (ctx, " no")]

    def process_results(self, doc, results):
        pred = results[1][0] > results[0][0]  # ll_no > ll_yes ⇒ label 1
        return {"acc": float(pred == doc["label"])}

    def higher_is_better(self):
        return {"acc": True}


class QQP(DocTask):
    name = "qqp"
    DATASET_PATH, DATASET_NAME = "glue", "qqp"

    def doc_to_text(self, doc):
        return ("Question 1: {}\nQuestion 2: {}\nQuestion: Do both questions "
                "ask the same thing?\nAnswer:").format(
            doc["question1"], doc["question2"])

    def doc_to_target(self, doc):
        return " {}".format(yesno(doc["label"]))

    def construct_requests(self, doc, ctx):
        return [(ctx, " yes"), (ctx, " no")]

    def process_results(self, doc, results):
        pred = results[0][0] > results[1][0]
        return {"acc": float(pred == doc["label"]),
                "f1": (doc["label"], pred)}

    def aggregation(self):
        return {"f1": f1_score}

    def higher_is_better(self):
        return {"acc": True, "f1": True}


class WNLI(DocTask):
    name = "wnli"
    VERSION = 1
    DATASET_PATH, DATASET_NAME = "glue", "wnli"

    def doc_to_text(self, doc):
        return "{}\nQuestion: {} True or False?\nAnswer:".format(
            doc["sentence1"], doc["sentence2"])

    def doc_to_target(self, doc):
        return " {}".format({0: "False", 1: "True"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [(ctx, " True"), (ctx, " False")]

    def process_results(self, doc, results):
        pred = results[0][0] > results[1][0]  # ll_true > ll_false ⇒ label 1
        return {"acc": float(pred == doc["label"])}

    def higher_is_better(self):
        return {"acc": True}


class STSB(DocTask):
    """reference glue.py STSB (:488-540): prompt + regression target
    defined, evaluation deliberately unimplemented upstream
    (construct_requests raises) — registered for registry parity."""
    name = "stsb"
    DATASET_PATH, DATASET_NAME = "glue", "stsb"

    def doc_to_text(self, doc):
        return "sentence 1: {}\nsentence 2: {}\nAnswer:".format(
            doc["sentence1"], doc["sentence2"])

    def doc_to_target(self, doc):
        return " {}".format(doc["label"])

    def construct_requests(self, doc, ctx):
        raise NotImplementedError("Evaluation not implemented")
