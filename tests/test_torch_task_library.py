"""The port's task registry and its ten task modules
(``onebit_tpu_torch/eval/tasks/{registry,qa,generation,math_tasks,glue,
superglue,pairs,translation,pile,arithmetic,cloze}.py``) against the JAX
package's on the CPU.

Every registry name resolves to a class of the same name, ``VERSION`` and
task name. Each task class that tests/test_task_library.py drives (GLUE,
SuperGLUE, every QA family, MATH and ASDiv, the generation tasks, BLiMP,
CrowS-Pairs, ToxiGen, arithmetic, pile, translation, the LAMBADA variants)
gets docs in its published schema, made from a seed: converted docs,
zero- and one-shot contexts, requests, ``process_results`` on seeded
results and the metric tables must equal JAX's exactly, and so must
``evaluate_tasks`` with a scripted LM; the stub tasks raise as JAX's do.
``DummyLM`` gives JAX's dict exactly, bootstrap stderrs included, for a
task of each module. On the tiny model (JAX packed params carried over by
``params_from_jax``) in fp32, a log-likelihood, a rolling and a greedy
task give each request's log-likelihood within 1e-4 of JAX's, the same
greedy texts, the same 0/1 metrics and perplexities within 1e-4
relative; through ``lm=NativeLM(...)`` the same run gives the same bits.
"""

import copy
import dataclasses
import functools
import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.engine import generate as jgenerate
from onebit_tpu.eval import dummy as jdummy
from onebit_tpu.eval.tasks import base as jbase
from onebit_tpu.eval.tasks import registry as jreg
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch import params_from_jax
from onebit_tpu_torch.eval import dummy as tdummy
from onebit_tpu_torch.eval import rolling as trolling
from onebit_tpu_torch.eval.adapters import NativeLM
from onebit_tpu_torch.eval.tasks import base as tbase
from onebit_tpu_torch.eval.tasks import registry as treg
from onebit_tpu_torch.model.config import BitLlamaConfig

LL_TOL = 1e-4
WORDS = ("the a cat dog river stone blue quickly jumps over under lazy bright "
         "house tree wind seven wizards watch quietly tonight small green "
         "paper runs sings carefully into market bread").split()
# the modules this file holds (suite.py and mmlu.py: tests/test_torch_tasks.py)
MODULES = ("qa", "generation", "math_tasks", "glue", "superglue", "pairs",
           "translation", "pile", "arithmetic", "cloze", "registry")


def char_tokenize(s):
    return [ord(c) % 128 for c in s]


def char_detokenize(toks):
    return "".join(chr(t) for t in toks)


def _text(rnd, lo, hi):
    return " ".join(rnd.choice(WORDS) for _ in range(rnd.randint(lo, hi)))



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one torch thread each, beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

# ---------------------------------------------------------------------------
# raw docs in each published schema
# ---------------------------------------------------------------------------

def _glue_pair(a, b, labels):
    return lambda r, i: {a: _text(r, 3, 6) + ".", b: _text(r, 3, 6),
                         "label": r.choice(labels)}


def _mc4(r, i):
    return [_text(r, 1, 3) + f" {j}" for j in range(4)]


def _arc_choices(r, i):
    return {"text": _mc4(r, i)}


def _mutual(r, i):
    return {"article": _text(r, 6, 10) + " , ok ?",
            "options": _mc4(r, i), "answers": r.choice("ABCD")}


def _anli(r, i):
    return {"premise": _text(r, 4, 8) + ".", "hypothesis": _text(r, 3, 5),
            "label": r.randint(0, 2)}


def _story(r, i):
    d = {f"input_sentence_{k}": _text(r, 3, 5) + "." for k in range(1, 5)}
    return dict(d, sentence_quiz1=_text(r, 2, 4) + ".",
                sentence_quiz2=_text(r, 2, 4) + " too.",
                answer_right_ending=r.randint(1, 2))


def _wsc273(r, i):
    text = "The trophy doesn't fit in the suitcase because it is too big."
    return {"text": text, "pronoun": "it", "pronoun_loc": 47,
            "options": ["The trophy", "The suitcase"], "label": i % 2,
            "quote": "it is too big", "quote_loc": 44, "source": "t"}


def _truthful_mc(r, i):
    return {"question": _text(r, 3, 6) + "?",
            "mc1_targets": {"choices": [_text(r, 1, 3) + f" {j}"
                                        for j in range(3)],
                            "labels": [1, 0, 0]},
            "mc2_targets": {"choices": [_text(r, 1, 3) + f" {j}"
                                        for j in range(4)],
                            "labels": [1, 1, 0, 0]}}


def _qasper(r, i):
    kind = ["bool", "free form answer", "extractive spans",
            "unanswerable"][i % 4]
    answer = {"bool": r.choice(["yes", "no"]), "unanswerable":
              "unanswerable"}.get(kind, _text(r, 2, 4))
    return {"title": _text(r, 2, 4), "abstract": _text(r, 6, 10),
            "question": _text(r, 3, 5) + "?", "answer": answer,
            "answer_type": kind}


def _drop(r, i):
    number = str(r.randint(1, 9)) if i % 2 else ""
    spans = [] if number else [_text(r, 1, 2)]
    return {"query_id": f"q{i}", "passage": _text(r, 8, 12) + ".",
            "question": _text(r, 3, 5) + "?",
            "answer": {"number": number, "date": {"day": "", "month": "",
                                                  "year": ""},
                       "spans": spans},
            "validated_answers": {"number": [], "date": [], "spans": []}}


def _squad(r, i):
    answers = [] if i % 3 == 0 else [_text(r, 1, 2)]
    return {"id": f"s{i}", "title": _text(r, 1, 2),
            "context": _text(r, 8, 12) + ".", "question": _text(r, 3, 5),
            "answers": {"text": answers, "answer_start": [0] * len(answers)}}


def _math(r, i):
    return {"problem": f"What is {i} + {i}?",
            "solution": rf"It is $\boxed{{{2 * i}}}$." if i % 2 else
            rf"So $\boxed{{\frac{{{i}}}{{2}}}}$."}


DOCS = {
    # glue
    "cola": lambda r, i: {"sentence": _text(r, 3, 6), "label": i % 2},
    "sst": lambda r, i: {"sentence": _text(r, 3, 6) + " , ok", "label":
                         i % 2},
    "mnli": lambda r, i: {"premise": _text(r, 3, 6), "hypothesis":
                          _text(r, 2, 4) + ("." if i % 2 else ""),
                          "label": i % 3},
    "mnli_mismatched": lambda r, i: {"premise": _text(r, 3, 6),
                                     "hypothesis": _text(r, 2, 4),
                                     "label": i % 3},
    "mrpc": _glue_pair("sentence1", "sentence2", [0, 1]),
    "rte": _glue_pair("sentence1", "sentence2", [0, 1]),
    "qnli": _glue_pair("question", "sentence", [0, 1]),
    "qqp": _glue_pair("question1", "question2", [0, 1]),
    "wnli": _glue_pair("sentence1", "sentence2", [0, 1]),
    # superglue
    "cb": lambda r, i: {"premise": _text(r, 3, 6), "hypothesis":
                        _text(r, 2, 4), "label": i % 3},
    "copa": lambda r, i: {"premise": _text(r, 3, 6) + ".",
                          "question": ["cause", "effect"][i % 2],
                          "choice1": "The " + _text(r, 2, 4) + ".",
                          "choice2": "A " + _text(r, 2, 4) + ".",
                          "label": r.randint(0, 1)},
    "multirc": lambda r, i: {"paragraph": _text(r, 6, 10),
                             "question": _text(r, 3, 5) + "?",
                             "answer": _text(r, 1, 3), "label": r.randint(
                                 0, 1), "idx": {"paragraph": 0,
                                                "question": i // 2}},
    "record": lambda r, i: {"passage": _text(r, 5, 8) + "\n@highlight\n"
                            + _text(r, 3, 5), "query": "X met @placeholder",
                            "entities": ["Bob", "Eve", "Ann"],
                            "answers": [r.choice(["Bob", "Eve", "Ann"])]},
    "wic": lambda r, i: {"sentence1": "the cat jumps over the dog",
                         "sentence2": _text(r, 3, 6), "start1": 4,
                         "end1": 7, "label": i % 2},
    "wsc": lambda r, i: {"text": "Mark told Pete many lies. He is stupid.",
                         "span1_index": 0, "span1_text": "Mark",
                         "span2_index": 5, "span2_text": "He",
                         "label": i % 2},
    # QA families
    "openbookqa": lambda r, i: {"question_stem": _text(r, 3, 6) + "?",
                                "choices": _arc_choices(r, i),
                                "answerKey": r.choice("ABCD")},
    "sciq": lambda r, i: {"support": _text(r, 4, 8) + ".", "question":
                          _text(r, 3, 5) + "?", "distractor1": "d1 " + str(i),
                          "distractor2": "d2", "distractor3": "d3",
                          "correct_answer": _text(r, 1, 2)},
    "race": None,     # collated rows: see _raw
    "logiqa": lambda r, i: {"context": _text(r, 5, 8), "question":
                            _text(r, 3, 5), "options": _mc4(r, i),
                            "label": r.choice("abcd")},
    "headqa_en": lambda r, i: {"qtext": _text(r, 3, 6) + "?", "answers": [
        {"atext": t} for t in _mc4(r, i)], "ra": r.randint(1, 4)},
    "headqa_es": lambda r, i: {"qtext": _text(r, 3, 6) + "?", "answers": [
        {"atext": t} for t in _mc4(r, i)], "ra": r.randint(1, 4)},
    "mathqa": lambda r, i: {"Problem": f"{i} + 1 ?", "correct": r.choice(
        "abcde"), "options": "a ) 1 , b ) 2 , c ) 3 , d ) 4 , e ) 5"},
    "prost": lambda r, i: {"context": _text(r, 4, 8), "ex_question":
                           _text(r, 3, 5), "A": "a", "B": "b", "C": "c",
                           "D": "d", "label": r.randint(0, 3)},
    "pubmedqa": lambda r, i: {"context": {"contexts": [_text(r, 3, 6),
                                                       _text(r, 3, 6)]},
                              "question": _text(r, 3, 5) + "?",
                              "final_decision": r.choice(
                                  ["yes", "no", "maybe"])},
    "qa4mre_2011": lambda r, i: {"document_str": _text(r, 6, 10) + " 'ok'",
                                 "question_str": _text(r, 3, 5) + "?",
                                 "answer_options": {"answer_str": _mc4(r, i)},
                                 "correct_answer_id": str(r.randint(1, 4))},
    "qa4mre_2012": lambda r, i: {"document_str": _text(r, 6, 10),
                                 "question_str": _text(r, 3, 5) + "?",
                                 "answer_options": {"answer_str": _mc4(r, i)},
                                 "correct_answer_id": str(r.randint(1, 4))},
    "qa4mre_2013": lambda r, i: {"document_str": _text(r, 6, 10),
                                 "question_str": _text(r, 3, 5) + "?",
                                 "answer_options": {"answer_str": _mc4(r, i)},
                                 "correct_answer_id": str(r.randint(1, 4))},
    "mc_taco": lambda r, i: {"sentence": _text(r, 4, 6) + ".", "question":
                             _text(r, 3, 5) + "?", "answer": _text(r, 1, 2),
                             "label": i % 2},
    "triviaqa": lambda r, i: {"question": _text(r, 3, 6) + "?", "answer": {
        "value": "Paris", "aliases": ["Paris", "Paris, France", "Lutetia"]}},
    "webqs": lambda r, i: {"question": _text(r, 3, 6) + "?",
                           "answers": ["Alpha", "Beta", "Alphabet"]},
    "swag": lambda r, i: {"startphrase": _text(r, 4, 6), **{
        f"ending{j}": _text(r, 2, 3) + f" {j}" for j in range(4)},
        "label": str(r.randint(0, 3))},
    "storycloze_2016": _story,
    "storycloze_2018": _story,
    "sat": lambda r, i: {"stem": "ostrich bird large", "solution": r.choice(
        "abcde"), "choices": ["lion cat big", "primate monkey small",
                              "bird crow big", "dog horse big",
                              "fish trout big"], "source": "src"},
    "mutual": _mutual,
    "mutual_plus": _mutual,
    "anli_r1": _anli,
    "anli_r2": _anli,
    "anli_r3": _anli,
    "wsc273": _wsc273,
    "truthfulqa_mc": _truthful_mc,
    "ethics_cm": lambda r, i: {"input": _text(r, 4, 8) + ".", "label":
                               str(i % 2)},
    "ethics_justice": lambda r, i: {"scenario": _text(r, 4, 8), "label":
                                    i % 2, "group_id": i // 4},
    "ethics_deontology": lambda r, i: {"scenario": _text(r, 4, 8) + "?",
                                       "excuse": _text(r, 3, 5) + ".",
                                       "label": i % 2, "group_id": i // 4},
    "ethics_utilitarianism": lambda r, i: {"activity": _text(r, 4, 8) + ".",
                                           "baseline": _text(r, 4, 8) + "."},
    "ethics_utilitarianism_original": lambda r, i: {
        "activity": _text(r, 4, 8) + ".", "baseline": _text(r, 4, 8) + "."},
    "ethics_virtue": lambda r, i: {"scenario": f"scenario {i // 5}",
                                   "trait": f"trait {i % 5}",
                                   "label": int(i % 5 == 0),
                                   "group_id": i // 5},
    "cbt-cn": lambda r, i: {"sentences": [_text(r, 3, 5) + " .",
                                          "He said `` hi '' ."],
                            "question": "The XXXXX sat on the mat .",
                            "options": ["dog", "cat", "owl"],
                            "answer": r.choice(["dog", "cat", "owl"])},
    "cbt-ne": lambda r, i: {"sentences": [_text(r, 3, 5) + " ."],
                            "question": "XXXXX ran away .",
                            "options": ["Bob", "Ann"],
                            "answer": r.choice(["Bob", "Ann"])},
    "qasper": _qasper,
    "truthfulqa_gen": lambda r, i: {"question": " " + _text(r, 3, 5) + "?",
                                    "correct_answers": [_text(r, 2, 4)],
                                    "incorrect_answers": [_text(r, 2, 4)]},
    # MATH and ASDiv
    "math_algebra": _math,
    "math_geometry": _math,
    "math_precalc": _math,
    "math_counting_and_prob": _math,
    "math_intermediate_algebra": _math,
    "math_num_theory": _math,
    "math_prealgebra": _math,
    "math_asdiv": lambda r, i: {"body": _text(r, 4, 8) + ".", "question":
                                " How many " + _text(r, 1, 2) + "?",
                                "answer": f"{i + 2} (apples)"},
    # generation
    "gsm8k": lambda r, i: {"question": f"{i}+{i}?",
                           "answer": f"think\n#### {2 * i}"},
    "drop": _drop,
    "coqa": lambda r, i: {"story": _text(r, 6, 10) + ".",
                          "questions": {"input_text": ["q1", "q2"]},
                          "answers": {"input_text": ["a1", "a2"]},
                          "additional_answers": None},
    "squad2": _squad,
    "anagrams1": lambda r, i: {"context": "Unscramble: ttesr =",
                               "completion": " trest"},
    "anagrams2": lambda r, i: {"context": "Unscramble: atc =",
                               "completion": " cat"},
    "cycle_letters": lambda r, i: {"context": "Unscramble: ogd =",
                                   "completion": " dog"},
    "random_insertion": lambda r, i: {"context": "Unscramble: c.a.t =",
                                      "completion": " cat"},
    "reversed_words": lambda r, i: {"context": "Unscramble: tac =",
                                    "completion": " cat"},
    # pairs
    "blimp_causative": lambda r, i: {"sentence_good": _text(r, 3, 5) + ".",
                                     "sentence_bad": _text(r, 3, 5) + "."},
    "blimp_wh_island": lambda r, i: {"sentence_good": _text(r, 3, 5) + "?",
                                     "sentence_bad": _text(r, 3, 5) + "?"},
    "crows_pairs_english": lambda r, i: {
        "sent_more": _text(r, 3, 5), "sent_less": _text(r, 3, 5),
        "bias_type": ["race-color", "gender"][i % 2]},
    "crows_pairs_french_race_color": lambda r, i: {
        "sent_more": _text(r, 3, 5), "sent_less": _text(r, 3, 5),
        "bias_type": ["race-color", "gender"][i % 2]},
    "toxigen": lambda r, i: {"text": _text(r, 3, 6), "toxicity_ai":
                             float(i % 5), "toxicity_human": float(i % 4)},
    # translation (sacrebleu scores the corpus)
    "wmt14-fr-en": lambda r, i: {"src": _text(r, 3, 6),
                                 "ref": _text(r, 3, 6)},
    "wmt20-en-zh": lambda r, i: {"src": _text(r, 3, 6), "ref": "猫咬狗"},
    "iwslt17-ar-en": lambda r, i: {"src": _text(r, 3, 6),
                                   "ref": _text(r, 3, 6)},
    # pile, arithmetic, cloze, wikitext
    "pile_github": lambda r, i: _text(r, 20, 40),
    "arithmetic_2da": lambda r, i: {"context": f"Question: What is {i} plus "
                                    f"{i}?\nAnswer:", "completion":
                                    f" {2 * i}"},
    "arithmetic_1dc": lambda r, i: {"context": f"Question: What is ({i} + 1)"
                                    " * 2?\nAnswer:", "completion":
                                    f" {2 * i + 2}"},
    "lambada_standard": lambda r, i: {"text": _text(r, 13, 18)},
    "lambada_openai_cloze": lambda r, i: {"text": _text(r, 13, 18)},
    "lambada_standard_cloze": lambda r, i: {"text": _text(r, 13, 18)},
    "lambada_openai_mt_de": lambda r, i: {"text": _text(r, 13, 18)},
    "wikitext": lambda r, i: " = " + _text(r, 2, 3) + " = \n " + _text(
        r, 20, 40) + " @-@ " + _text(r, 5, 9) + " . \n",
}
STUBS = {"naturalqs": {"question": {"text": "q"}, "annotations": {},
                       "document": {}},
         "quac": {"title": "t", "section_title": "s", "paragraph": "p",
                  "question": "q", "answer": "a"},
         "stsb": {"sentence1": "a", "sentence2": "b", "label": 3.2}}
# generation results the scripted LM and the seeded results draw from
GEN_TEXTS = ["lol", " 4", "#### 4", "Paris", "$2$", " Neither", " trest",
             "the cat jumps", "a1", "\\frac{1}{2}", "3", "Alpha"]


def _race_rows(r, n):
    rows = []
    for i in range(n):
        art = f"ART {i // 2}"
        rows.append({"article": art, "question": _text(r, 3, 5),
                     "answer": r.choice("ABCD"), "options": _mc4(r, i)})
    return rows


def _raw(name, n, seed):
    r = random.Random(seed)
    if name == "race":
        return _race_rows(r, n)
    return [DOCS[name](r, i) for i in range(n)]


def _make(reg, name, raw, train=None):
    """``reg.TASK_REGISTRY[name]`` on a deep copy of ``raw`` (some
    ``convert``s write into their rows), with a training pool where the
    class keeps one."""
    cls = reg.TASK_REGISTRY[name]
    raw = copy.deepcopy(raw)
    if name == "race":
        raw = cls.collate(raw)
    task = cls(raw)
    if train is not None and hasattr(task, "_raw_train"):
        task._raw_train = copy.deepcopy(train)
    return task


def _plain(x):
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, dataclasses.asdict(x))
    return x


def _req(r):
    return (r.type, r.args) if dataclasses.is_dataclass(r) else r


def _call(fn, *args):
    """``fn(*args)``, or the exception it raised (held by type and text)."""
    try:
        return fn(*args)
    except Exception as e:   # noqa: BLE001
        return (type(e).__name__, str(e))


def _results(task, doc, reqs, rng):
    """Seeded results in each request's shape; a greedy result is now and
    then the doc's own target, so that exact-match metrics see both
    outcomes."""
    out = []
    for r in reqs:
        kind = r.type if dataclasses.is_dataclass(r) else task.request_type
        if kind == "loglikelihood":
            out.append((float(-rng.random() * 10), bool(rng.random() < .5)))
        elif kind == "greedy_until":
            target = _call(task.doc_to_target, doc)
            out.append(target if isinstance(target, str) and rng.random()
                       < .5 else GEN_TEXTS[rng.integers(len(GEN_TEXTS))])
        else:
            out.append(float(-rng.random() * 100))
    return out


class ScriptedLM:
    """A deterministic LM of the three-method surface: each score is a
    hash of its tokens, each generation one of GEN_TEXTS by a hash of its
    context. Both packages' tasks get the same answers for the same
    requests."""

    def loglikelihood(self, requests):
        out = []
        for ctx, cont in requests:
            h = zlib.crc32(bytes(list(ctx) + [255] + list(cont)))
            out.append((-(h % 1000) / 100.0, h % 3 == 0))
        return out

    def loglikelihood_rolling(self, documents):
        return [-(zlib.crc32(bytes(d)) % 5000) / 10.0 for d in documents]

    def greedy_until(self, requests, detokenize=None, **kw):
        return [GEN_TEXTS[zlib.crc32(bytes(ctx)) % len(GEN_TEXTS)]
                for ctx, _ in requests]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    """Every name, and each one's class name, ``VERSION``, task name and
    request type."""
    assert treg.ALL_TASKS == jreg.ALL_TASKS
    assert sorted(treg.TASK_REGISTRY) == sorted(jreg.TASK_REGISTRY)
    assert len(treg.ALL_TASKS) == 297
    for name, jcls in jreg.TASK_REGISTRY.items():
        tcls = treg.get_task_class(name)
        assert tcls.__name__ == jcls.__name__, name
        for attr in ("VERSION", "name", "request_type"):
            assert getattr(tcls, attr, None) == getattr(jcls, attr, None), \
                (name, attr)
    with pytest.raises(KeyError, match="unknown task 'nope'"):
        treg.get_task_class("nope")


@pytest.mark.parametrize("patterns", [
    ["anli_r?"], ["gsm8k", "anli_*"], ["blimp_*"], ["hendrycksTest-*"],
    ["pile_*", "wmt1[46]-*", "pile_github"], ["*cloze*"], ["no_such_*"]],
    ids=lambda p: ",".join(p))
def test_pattern_match_matches_jax(patterns):
    assert treg.pattern_match(patterns) == jreg.pattern_match(patterns)
    source = treg.ALL_TASKS[::3]
    assert treg.pattern_match(patterns, source) == \
        jreg.pattern_match(patterns, source)


def test_every_class_of_the_ten_modules_is_held():
    """Each registry class of the ten modules outside the generated
    families (BLiMP, CrowS-Pairs, pile, arithmetic, translation, LAMBADA
    multilingual: one or more of each; the MMLU subjects are
    tests/test_torch_tasks.py's) has its case here."""
    held = {type(_make(treg, n, _raw(n, 2, 0))).__name__ for n in DOCS}
    held |= {treg.TASK_REGISTRY[n].__name__ for n in STUBS}
    generated = ("Blimp_", "CrowsPairs_", "Pile_", "Arithmetic_",
                 "Translation_", "LambadaMultilingual_", "MMLU_")
    missing = sorted({c.__name__ for c in treg.TASK_REGISTRY.values()
                      if c.__module__.rsplit(".", 1)[-1] in MODULES
                      and not c.__name__.startswith(generated)} - held)
    assert not missing, missing


# ---------------------------------------------------------------------------
# each task against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DOCS))
def test_task_matches_jax(name):
    """Converted docs; zero- and one-shot contexts (a training pool where
    the class keeps one; a seeded ``random.Random`` walking the docs, as
    ``evaluate_tasks`` does); requests; ``process_results`` on seeded
    results; the decontamination queries; the metric tables; and
    ``evaluate_tasks`` with a scripted LM, one-shot where the task allows
    it."""
    raw, train = _raw(name, 6, 1), _raw(name, 4, 2)
    jt, tt = (_make(reg, name, raw, train) for reg in (jreg, treg))
    assert type(tt).__name__ == type(jt).__name__
    jdocs, tdocs = jt.docs(), tt.docs()
    assert len(tdocs) == len(jdocs) > 0
    assert [_plain(d) for d in tdocs] == [_plain(d) for d in jdocs]
    rng = np.random.default_rng(6)
    for shots in (0, 1):
        jr, tr = random.Random(5), random.Random(5)
        for jd, td in zip(jdocs, tdocs):
            jctx = _call(jt.fewshot_context, jd, shots, jr, "Answer well.")
            tctx = _call(tt.fewshot_context, td, shots, tr, "Answer well.")
            assert tctx == jctx
            if not isinstance(jctx, str):
                continue
            jreq = _call(jt.construct_requests, jd, jctx)
            treq = _call(tt.construct_requests, td, tctx)
            assert [_req(r) for r in treq] == [_req(r) for r in jreq]
            results = _results(jt, jd, jreq, rng)
            assert _call(tt.process_results, td, results) == \
                _call(jt.process_results, jd, results)
    assert tt.should_decontaminate() == jt.should_decontaminate()
    if jt.should_decontaminate():
        assert [tt.doc_to_decontamination_query(d) for d in tdocs] == \
            [jt.doc_to_decontamination_query(d) for d in jdocs]
    assert tt.higher_is_better() == jt.higher_is_better()
    assert {k: f.__name__ for k, f in tt.aggregation().items()} == \
        {k: f.__name__ for k, f in jt.aggregation().items()}
    # one-shot, or zero-shot for the tasks that are zero-shot only
    # (perplexity, truthfulqa_gen)
    shots = int(isinstance(_call(jt.fewshot_context, jdocs[0], 1,
                                 random.Random(0)), str))
    kw = dict(detokenize=char_detokenize, num_fewshot=shots,
              bootstrap_iters=100)
    got = tbase.evaluate_tasks(None, None, [_make(treg, name, raw, train)],
                               char_tokenize, lm=ScriptedLM(), **kw)
    want = jbase.evaluate_tasks(None, None, [_make(jreg, name, raw, train)],
                                char_tokenize, lm=ScriptedLM(), **kw)
    assert got == want


@pytest.mark.parametrize("name", sorted(STUBS))
def test_stub_tasks_raise_like_jax(name):
    """Registered upstream without requests: ``construct_requests`` raises
    ``NotImplementedError`` on both sides, with the same text."""
    doc = STUBS[name]
    jt, tt = (reg.TASK_REGISTRY[name]([dict(doc)]) for reg in (jreg, treg))
    assert tt.doc_to_text(doc) == jt.doc_to_text(doc)
    for t in (jt, tt):
        with pytest.raises(NotImplementedError):
            t.construct_requests(doc, "ctx")
    assert _call(tt.construct_requests, doc, "ctx") == \
        _call(jt.construct_requests, doc, "ctx")


# one task of each module: DummyLM's random scores, bootstrap stderrs
DUMMY = ["rte", "copa", "openbookqa", "gsm8k", "math_algebra",
         "blimp_causative", "wmt14-fr-en", "pile_github", "arithmetic_2da",
         "lambada_standard_cloze", "wikitext"]


@pytest.mark.parametrize("name", DUMMY)
def test_dummy_lm_matches_jax(name):
    raw = _raw(name, 8, 3)
    kw = dict(detokenize=char_detokenize, limit=7,
              decontamination_ngrams=[d if isinstance(d, str) else
                                      str(d) for d in raw[:2]])
    got = tbase.evaluate_tasks(None, None, [_make(treg, name, raw)],
                               char_tokenize, lm=tdummy.DummyLM(), **kw)
    want = jbase.evaluate_tasks(None, None, [_make(jreg, name, raw)],
                                char_tokenize, lm=jdummy.DummyLM(), **kw)
    assert got == want
    assert all(f"{m}_stderr" in got[name] for m in got[name]
               if not m.endswith(("_stderr", "_decontaminate"))
               and m != "contaminated")
    assert tbase.make_table(got) == jbase.make_table(want)


# ---------------------------------------------------------------------------
# the tiny model: a log-likelihood, a rolling and a greedy task
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jc = JaxConfig.named("tiny")
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(5)))
    c = BitLlamaConfig.named("tiny")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), c, device="cpu")
    return jc, jp, c, tp


def _recording(monkeypatch, base):
    calls = []
    real = base._run_requests

    def run(params, config, rtype, payloads, *args, **kw):
        out = real(params, config, rtype, payloads, *args, **kw)
        calls.append((rtype, list(payloads), list(out)))
        return out
    monkeypatch.setattr(base, "_run_requests", run)
    return calls


TINY_TASKS = ["copa", "pile_github", "triviaqa", "gsm8k"]


def test_tiny_model_tasks_match_jax(tiny, monkeypatch):
    """COPA and TriviaQA (log-likelihoods and greedy flags), a pile subset
    (rolling) and GSM8K (greedy-until, generated in fp32 on both sides as
    in tests/test_torch_tasks.py) on the tiny model in fp32: each request
    within 1e-4, the same greedy texts, the 0/1 metrics exact and the
    perplexities within 1e-4 relative; then ``lm=NativeLM(...)`` gives the
    direct run's results and requests, bit for bit."""
    jc, jp, c, tp = tiny
    monkeypatch.setattr(jgenerate, "generate", functools.partial(
        jgenerate.generate, compute_dtype=jnp.float32))
    monkeypatch.setattr(trolling, "generate", functools.partial(
        trolling.generate, compute_dtype=torch.float32))
    raws = {n: _raw(n, 3, 7) for n in TINY_TASKS}
    kw = dict(batch_size=8, detokenize=char_detokenize, max_new_tokens=6)
    jcalls = _recording(monkeypatch, jbase)
    want = jbase.evaluate_tasks(jp, jc, [_make(jreg, n, raws[n])
                                         for n in TINY_TASKS],
                                char_tokenize, **kw)
    tcalls = _recording(monkeypatch, tbase)
    got = tbase.evaluate_tasks(tp, c, [_make(treg, n, raws[n])
                                       for n in TINY_TASKS],
                               char_tokenize, compute_dtype=torch.float32,
                               **kw)
    assert [r for r, _, _ in tcalls] == [r for r, _, _ in jcalls] == [
        "loglikelihood", "loglikelihood_rolling", "loglikelihood",
        "greedy_until"]
    assert [p for _, p, _ in tcalls] == [p for _, p, _ in jcalls]
    for (rtype, _, a), (_, _, w) in zip(tcalls, jcalls):
        if rtype == "greedy_until":
            assert a == w
            continue
        ll_a = np.array([x[0] if rtype == "loglikelihood" else x for x in a])
        ll_w = np.array([x[0] if rtype == "loglikelihood" else x for x in w])
        np.testing.assert_allclose(ll_a, ll_w, rtol=LL_TOL, atol=LL_TOL)
        if rtype == "loglikelihood":
            assert [x[1] for x in a] == [x[1] for x in w]
    assert sorted(got) == sorted(want) == sorted(TINY_TASKS)
    for task in want:
        assert sorted(got[task]) == sorted(want[task])
        for metric, w in want[task].items():
            if "perplexity" in metric or "bits_per_byte" in metric:
                np.testing.assert_allclose(got[task][metric], w,
                                           rtol=LL_TOL, err_msg=metric)
            else:
                assert got[task][metric] == w, (task, metric)

    direct = list(tcalls)
    ncalls = _recording(monkeypatch, tbase)
    lm = NativeLM(tp, c, batch_size=8, compute_dtype=torch.float32)
    again = tbase.evaluate_tasks(None, None, [_make(treg, n, raws[n])
                                              for n in TINY_TASKS],
                                 char_tokenize, lm=lm, **kw)
    assert again == got
    assert ncalls == direct
