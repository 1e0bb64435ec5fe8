"""LAMBADA variants beyond the published-table lambada_openai (reference
evaluation/lm_eval/tasks/{lambada,lambada_cloze,lambada_multilingual}.py).

A copy of ``onebit_tpu/eval/tasks/cloze.py`` with its imports pointed at the
port; its optional imports stay lazy, where the JAX module has them.
"""

from __future__ import annotations

from onebit_tpu_torch.eval.tasks.suite import Lambada


class LambadaStandard(Lambada):
    """reference lambada.py LambadaStandard (the original Zenodo test set)."""
    name = "lambada_standard"
    DATASET_PATH, DATASET_NAME, DEFAULT_SPLIT = "lambada", None, "test"


class LambadaOpenAICloze(Lambada):
    """reference lambada_cloze.py: ' ____. ->' cloze-style prompt."""
    name = "lambada_openai_cloze"

    def doc_to_text(self, doc):
        return doc["text"].rsplit(" ", 1)[0] + " ____. ->"


class LambadaStandardCloze(LambadaStandard):
    name = "lambada_standard_cloze"

    def doc_to_text(self, doc):
        return doc["text"].rsplit(" ", 1)[0] + " ____. ->"


def make_multilingual_task(lang: str):
    """reference lambada_multilingual.py: ``lambada_openai_mt_<lang>``."""
    return type(f"LambadaMultilingual_{lang}", (Lambada,), {
        "name": f"lambada_openai_mt_{lang}", "DATASET_NAME": lang})


LAMBADA_LANGS = ["en", "fr", "de", "it", "es"]
