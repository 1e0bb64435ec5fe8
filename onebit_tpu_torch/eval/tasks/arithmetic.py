"""EleutherAI arithmetic probes (reference evaluation/lm_eval/tasks/
arithmetic.py): accuracy = is_greedy of the exact completion.

A copy of ``onebit_tpu/eval/tasks/arithmetic.py`` with its imports pointed
at the port; its optional imports stay lazy, where the JAX module has them.
"""

from __future__ import annotations

from onebit_tpu_torch.eval.tasks.base import DocTask


class Arithmetic(DocTask):
    """acc = the completion is the model's greedy continuation."""
    name = "arithmetic_2da"
    DATASET_PATH = "EleutherAI/arithmetic"
    DATASET_NAME = "arithmetic_2da"
    TRAIN_SPLIT = None

    def doc_to_text(self, doc):
        return doc["context"]

    def doc_to_target(self, doc):
        return doc["completion"]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["context"]

    def construct_requests(self, doc, ctx):
        return [(ctx, doc["completion"])]

    def process_results(self, doc, results):
        return {"acc": float(bool(results[0][1]))}

    def higher_is_better(self):
        return {"acc": True}


ARITHMETIC_NAMES = ["2da", "2ds", "3da", "3ds", "4da", "4ds", "5da", "5ds",
                    "2dm", "1dc"]


def make_arithmetic_task(suffix: str):
    return type(f"Arithmetic_{suffix}", (Arithmetic,), {
        "name": f"arithmetic_{suffix}",
        "DATASET_NAME": f"arithmetic_{suffix}"})
