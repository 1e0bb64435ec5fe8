"""The task registry (reference evaluation/lm_eval/tasks/__init__.py
TASK_REGISTRY + get_task_dict/pattern_match): every reference registry name
maps to a task class here.

Tasks are constructed with injected docs (``TASK_REGISTRY[name](raw_docs)``)
or via each class's ``from_datasets``/``from_jsonl`` loader when the corpus
is on local disk — this registry maps names to classes, it does not fetch
data.

A copy of ``onebit_tpu/eval/tasks/registry.py`` with its imports pointed at
the port: the same names, classes and ``VERSION``s.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, List, Type

from onebit_tpu_torch.eval.tasks import arithmetic as _arith
from onebit_tpu_torch.eval.tasks import cloze as _cloze
from onebit_tpu_torch.eval.tasks import generation as _gen
from onebit_tpu_torch.eval.tasks import glue as _glue
from onebit_tpu_torch.eval.tasks import math_tasks as _math
from onebit_tpu_torch.eval.tasks import pairs as _pairs
from onebit_tpu_torch.eval.tasks import pile as _pile
from onebit_tpu_torch.eval.tasks import qa as _qa
from onebit_tpu_torch.eval.tasks import suite as _suite
from onebit_tpu_torch.eval.tasks import superglue as _sg
from onebit_tpu_torch.eval.tasks import translation as _trans
from onebit_tpu_torch.eval.tasks.base import PerplexityTask
from onebit_tpu_torch.eval.tasks.mmlu import SUBJECTS as MMLU_SUBJECTS
from onebit_tpu_torch.eval.tasks.mmlu import MMLUSubject
from onebit_tpu_torch.eval.tasks.wikitext import wikitext_detokenize


class WikiText(PerplexityTask):
    """reference tasks/wikitext.py: rolling ppl over detokenized pages."""
    name = "wikitext"
    VERSION = 1

    def __init__(self, pages):
        self._pages = list(pages)

    def docs(self):
        return [wikitext_detokenize(p) for p in self._pages if p.strip()]


TASK_REGISTRY: Dict[str, Type] = {
    # glue
    "cola": _glue.CoLA,
    "mnli": _glue.MNLI,
    "mnli_mismatched": _glue.MNLIMismatched,
    "mrpc": _glue.MRPC,
    "rte": _glue.RTE,
    "qnli": _glue.QNLI,
    "qqp": _glue.QQP,
    "sst": _glue.SST,
    "wnli": _glue.WNLI,
    "stsb": _glue.STSB,
    # superglue
    "boolq": _suite.BoolQ,
    "cb": _sg.CommitmentBank,
    "copa": _sg.Copa,
    "multirc": _sg.MultiRC,
    "record": _sg.ReCoRD,
    "wic": _sg.WordsInContext,
    "wsc": _sg.SGWinogradSchemaChallenge,
    # published-table suite
    "piqa": _suite.PIQA,
    "arc_easy": _suite.ARCEasy,
    "arc_challenge": _suite.ARCChallenge,
    "hellaswag": _suite.HellaSwag,
    "winogrande": _suite.Winogrande,
    "lambada_openai": _suite.Lambada,
    # lambada variants
    "lambada_standard": _cloze.LambadaStandard,
    "lambada_openai_cloze": _cloze.LambadaOpenAICloze,
    "lambada_standard_cloze": _cloze.LambadaStandardCloze,
    # QA / reasoning / commonsense
    "openbookqa": _qa.OpenBookQA,
    "sciq": _qa.SciQ,
    "race": _qa.RACE,
    "logiqa": _qa.LogiQA,
    "headqa": _qa.HeadQAEs,     # backwards-compat: headqa = es
    "headqa_en": _qa.HeadQAEn,
    "headqa_es": _qa.HeadQAEs,
    "mathqa": _qa.MathQA,
    "prost": _qa.PROST,
    "pubmedqa": _qa.PubmedQA,
    "qa4mre_2011": _qa.QA4MRE_2011,
    "qa4mre_2012": _qa.QA4MRE_2012,
    "qa4mre_2013": _qa.QA4MRE,
    "mc_taco": _qa.MCTACO,
    "triviaqa": _qa.TriviaQA,
    "webqs": _qa.WebQs,
    "swag": _qa.SWAG,
    "storycloze_2016": _qa.StoryCloze2016,
    "storycloze_2018": _qa.StoryCloze2018,
    "sat": _qa.SATAnalogies,
    "mutual": _qa.MuTual,
    "mutual_plus": _qa.MuTualPlus,
    "anli_r1": _qa.ANLIRound1,
    "anli_r2": _qa.ANLIRound2,
    "anli_r3": _qa.ANLIRound3,
    "wsc273": _qa.WSC273,
    "truthfulqa_mc": _qa.TruthfulQAMultipleChoice,
    "ethics_cm": _qa.EthicsCM,
    "ethics_justice": _qa.EthicsJustice,
    "ethics_deontology": _qa.EthicsDeontology,
    "ethics_utilitarianism": _qa.EthicsUtilitarianism,
    "ethics_utilitarianism_original": _qa.EthicsUtilitarianismOriginal,
    "ethics_virtue": _qa.EthicsVirtue,
    "cbt-cn": _qa.CBTCN,
    "cbt-ne": _qa.CBTNE,
    "qasper": _qa.QASPER,
    "truthfulqa_gen": _qa.TruthfulQAGeneration,
    # registered-but-unimplemented upstream (construct_requests raises in
    # the reference too): naturalqs, quac, stsb
    "naturalqs": _qa.NaturalQs,
    "quac": _qa.QuAC,
    "toxigen": _pairs.ToxiGen,
    # MATH + asdiv
    "math_algebra": _math.MathAlgebra,
    "math_counting_and_prob": _math.MathCountingAndProbability,
    "math_geometry": _math.MathGeometry,
    "math_intermediate_algebra": _math.MathIntermediateAlgebra,
    "math_num_theory": _math.MathNumberTheory,
    "math_prealgebra": _math.MathPrealgebra,
    "math_precalc": _math.MathPrecalculus,
    "math_asdiv": _math.Asdiv,
    # generation tasks
    "gsm8k": _gen.GSM8K,
    "drop": _gen.DROP,
    "coqa": _gen.CoQA,
    "squad2": _gen.SQuAD2,
    "anagrams1": _gen.WordUnscramble,
    "anagrams2": _gen.Anagrams2,
    "cycle_letters": _gen.CycleLetters,
    "random_insertion": _gen.RandomInsertion,
    "reversed_words": _gen.ReversedWords,
    # perplexity
    "wikitext": WikiText,
}

# lambada multilingual
for _lang in _cloze.LAMBADA_LANGS:
    TASK_REGISTRY[f"lambada_openai_mt_{_lang}"] = \
        _cloze.make_multilingual_task(_lang)

# arithmetic_*
for _suffix in _arith.ARITHMETIC_NAMES:
    TASK_REGISTRY[f"arithmetic_{_suffix}"] = \
        _arith.make_arithmetic_task(_suffix)

# blimp_*
for _paradigm in _pairs.BLIMP_PARADIGMS:
    TASK_REGISTRY[f"blimp_{_paradigm}"] = _pairs.make_blimp_task(_paradigm)

# translation: wmt14/16/20 + iwslt17 per language pair
TASK_REGISTRY.update(_trans.benchmark_tasks())

# crows_pairs_{english,french}[_bias]
for _lang in ("english", "french"):
    TASK_REGISTRY[f"crows_pairs_{_lang}"] = \
        _pairs.make_crows_pairs_task(_lang)
    for _bias in _pairs.CROWS_PAIRS_BIAS_TYPES:
        TASK_REGISTRY[f"crows_pairs_{_lang}_{_bias}"] = \
            _pairs.make_crows_pairs_task(_lang, _bias)

# pile_*
for _suffix in _pile.PILE_SUBSETS:
    TASK_REGISTRY[f"pile_{_suffix}"] = _pile.make_pile_task(_suffix)

# hendrycks_test (MMLU) per-subject: the reference registers these as
# hendrycksTest-<subject> (tasks/__init__.py hendrycks_test.create_all_tasks)
def _make_mmlu(subject: str):
    def __init__(self, raw_docs, raw_train=None):
        MMLUSubject.__init__(self, raw_docs, subject)
    return type(f"MMLU_{subject}", (MMLUSubject,), {"__init__": __init__})


for _subject in MMLU_SUBJECTS:
    TASK_REGISTRY[f"hendrycksTest-{_subject}"] = _make_mmlu(_subject)


ALL_TASKS = sorted(TASK_REGISTRY)


def pattern_match(patterns: List[str], source=None) -> List[str]:
    """Expand fnmatch patterns against the registry (reference
    evaluator pattern_match, lm_eval.py:31)."""
    source = source if source is not None else ALL_TASKS
    names: List[str] = []
    for pattern in patterns:
        for name in fnmatch.filter(source, pattern):
            if name not in names:
                names.append(name)
    return names


def get_task_class(name: str):
    if name not in TASK_REGISTRY:
        raise KeyError(f"unknown task {name!r}; known: {len(ALL_TASKS)} "
                       "(see onebit_tpu_torch.eval.tasks.registry.ALL_TASKS)")
    return TASK_REGISTRY[name]
