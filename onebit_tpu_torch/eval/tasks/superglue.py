"""SuperGLUE tasks beyond BoolQ (reference evaluation/lm_eval/tasks/
superglue.py) — prompt formats byte-identical for score parity.

Registry names: cb, copa, multirc, record, wic, wsc.  (boolq lives in
suite.py with the published-table tasks.)

A copy of ``onebit_tpu/eval/tasks/superglue.py`` with its imports pointed at
the port; its optional imports stay lazy, where the JAX module has them.
"""

from __future__ import annotations

import numpy as np

from onebit_tpu_torch.eval.tasks.base import DocTask
from onebit_tpu_torch.eval.tasks.metrics import (
    acc_all,
    general_detokenize,
    mean,
    squad_em_f1,
    yesno,
)


class CommitmentBank(DocTask):
    """reference superglue.py CommitmentBank: 3-way + multi-class F1."""
    name = "cb"
    VERSION = 1
    DATASET_PATH, DATASET_NAME = "super_glue", "cb"

    def doc_to_text(self, doc):
        return "{}\nQuestion: {}. True, False or Neither?\nAnswer:".format(
            doc["premise"], doc["hypothesis"])

    def doc_to_target(self, doc):
        return " {}".format({0: "True", 1: "False", 2: "Neither"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [(ctx, " True"), (ctx, " False"), (ctx, " Neither")]

    def process_results(self, doc, results):
        pred = int(np.argmax([r[0] for r in results]))
        return {"acc": float(pred == doc["label"]),
                "f1": (pred, doc["label"])}

    @staticmethod
    def cb_multi_f1(items):
        import sklearn.metrics
        preds, golds = map(np.asarray, zip(*items))
        return mean([sklearn.metrics.f1_score(y_true=golds == k,
                                              y_pred=preds == k)
                     for k in (0, 1, 2)])

    def aggregation(self):
        return {"f1": self.cb_multi_f1}

    def higher_is_better(self):
        return {"acc": True, "f1": True}


class Copa(DocTask):
    """reference superglue.py Copa: premise + because/therefore."""
    name = "copa"
    DATASET_PATH, DATASET_NAME = "super_glue", "copa"

    @staticmethod
    def convert_choice(choice):
        return choice[0].lower() + choice[1:]

    def doc_to_text(self, doc):
        connector = {"cause": "because", "effect": "therefore"}[doc["question"]]
        return doc["premise"].strip()[:-1] + f" {connector}"

    def doc_to_target(self, doc):
        correct = doc["choice1"] if doc["label"] == 0 else doc["choice2"]
        return " " + self.convert_choice(correct)

    def construct_requests(self, doc, ctx):
        return [(ctx, " " + self.convert_choice(doc["choice1"])),
                (ctx, " " + self.convert_choice(doc["choice2"]))]

    def process_results(self, doc, results):
        pred = int(np.argmax([r[0] for r in results]))
        return {"acc": float(pred == doc["label"])}

    def higher_is_better(self):
        return {"acc": True}


class MultiRC(DocTask):
    """reference superglue.py MultiRC: per-option yes/no, aggregated with
    acc_all (all options of a question must be right)."""
    name = "multirc"
    VERSION = 1
    DATASET_PATH, DATASET_NAME = "super_glue", "multirc"

    def doc_to_text(self, doc):
        return f"{doc['paragraph']}\nQuestion: {doc['question']}\nAnswer:"

    @staticmethod
    def format_answer(answer, label):
        label_str = "yes" if label else "no"
        return f"{answer}\nIs the answer correct? {label_str}"

    def doc_to_target(self, doc):
        return " " + self.format_answer(doc["answer"], doc["label"])

    def construct_requests(self, doc, ctx):
        return [(ctx, " " + self.format_answer(doc["answer"], True)),
                (ctx, " " + self.format_answer(doc["answer"], False))]

    def process_results(self, doc, results):
        pred = results[0][0] > results[1][0]
        return {"acc": (pred, doc)}

    def aggregation(self):
        return {"acc": acc_all}

    def higher_is_better(self):
        return {"acc": True}


class ReCoRD(DocTask):
    """reference superglue.py ReCoRD: max-likelihood entity, per-example
    token F1 + EM vs the answer set."""
    name = "record"
    DATASET_PATH, DATASET_NAME = "super_glue", "record"

    def convert(self, doc):
        return {"passage": doc["passage"], "query": doc["query"],
                "entities": sorted(set(doc["entities"])),
                "answers": sorted(set(doc["answers"]))}

    def doc_to_text(self, doc):
        initial_text, *highlights = doc["passage"].strip().split(
            "\n@highlight\n")
        text = initial_text + "\n\n"
        for highlight in highlights:
            text += f"  - {highlight}.\n"
        return text

    @classmethod
    def format_answer(cls, query, entity):
        return f"  - {query}".replace("@placeholder", entity)

    def doc_to_target(self, doc):
        return self.format_answer(doc["query"], doc["answers"][0])

    def construct_requests(self, doc, ctx):
        return [(ctx, self.format_answer(doc["query"], entity))
                for entity in doc["entities"]]

    def process_results(self, doc, results):
        max_idx = int(np.argmax([r[0] for r in results]))
        prediction = doc["entities"][max_idx]
        em, f1 = squad_em_f1(prediction, doc["answers"])
        return {"f1": f1, "em": em}

    def higher_is_better(self):
        return {"f1": True, "em": True}


class WordsInContext(DocTask):
    name = "wic"
    DATASET_PATH, DATASET_NAME = "super_glue", "wic"

    def doc_to_text(self, doc):
        return ("Sentence 1: {}\nSentence 2: {}\nQuestion: Is the word '{}' "
                "used in the same way in the two sentences above?\nAnswer:"
                ).format(doc["sentence1"], doc["sentence2"],
                         doc["sentence1"][doc["start1"]:doc["end1"]])

    def doc_to_target(self, doc):
        return " {}".format({0: "no", 1: "yes"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [(ctx, " yes"), (ctx, " no")]

    def process_results(self, doc, results):
        pred = results[0][0] > results[1][0]
        return {"acc": float(pred == doc["label"])}

    def higher_is_better(self):
        return {"acc": True}


class SGWinogradSchemaChallenge(DocTask):
    """reference superglue.py WSC (binary): *{pronoun}* highlighted passage,
    yes/no coreference question.  Few-shot pool = positive examples only
    (GPT-3 paper convention)."""
    name = "wsc"
    DATASET_PATH, DATASET_NAME = "super_glue", "wsc"

    def training_docs(self):
        docs = super().training_docs()
        if docs is None:
            return None
        return [d for d in docs if d["label"]]

    def doc_to_text(self, doc):
        raw_passage = doc["text"]
        # HF span indices are word-based
        pre = " ".join(raw_passage.split()[:doc["span2_index"]])
        post = raw_passage[len(pre) + len(doc["span2_text"]) + 1:]
        passage = general_detokenize(
            pre + " *{}*".format(doc["span2_text"]) + post)
        return (f"Passage: {passage}\n"
                f'Question: In the passage above, does the pronoun '
                f'"*{doc["span2_text"]}*" refer to "*{doc["span1_text"]}*"?\n'
                "Answer:")

    def doc_to_target(self, doc):
        return " " + yesno(doc["label"])

    def construct_requests(self, doc, ctx):
        return [(ctx, " yes"), (ctx, " no")]

    def process_results(self, doc, results):
        pred = results[0][0] > results[1][0]
        return {"acc": float(pred == doc["label"])}

    def higher_is_better(self):
        return {"acc": True}
