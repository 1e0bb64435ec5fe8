"""Generation-scored tasks (reference evaluation/lm_eval/tasks/{gsm8k,drop,
coqa,squad,unscramble}.py) driven by the ``greedy_until`` request type —
prompt formats byte-identical to the reference for score parity.

A copy of ``onebit_tpu/eval/tasks/generation.py`` with its imports pointed
at the port; its optional imports stay lazy, where the JAX module has them.
"""

from __future__ import annotations

import re
import string
from typing import List

import numpy as np

from onebit_tpu_torch.eval.tasks.base import DocTask, rf
from onebit_tpu_torch.eval.tasks.metrics import (compute_exact, compute_f1,
                                                 squad_em_f1)


class GSM8K(DocTask):
    """reference gsm8k.py: generate to newline; compare '#### N' answers."""
    name = "gsm8k"
    request_type = "greedy_until"
    DATASET_PATH, DATASET_NAME, DEFAULT_SPLIT = "gsm8k", "main", "test"

    ANS_RE = re.compile(r"#### (\-?[0-9\.\,]+)")
    INVALID_ANS = "[invalid]"

    def doc_to_text(self, doc):
        return "Question: " + doc["question"] + "\nAnswer:"

    def doc_to_target(self, doc):
        return " " + doc["answer"]

    def construct_requests(self, doc, ctx):
        return [rf.greedy_until(ctx, ["\n"])]

    def _extract_answer(self, completion):
        match = self.ANS_RE.search(completion)
        if match:
            return match.group(1).strip().replace(",", "")
        return self.INVALID_ANS

    def process_results(self, doc, results):
        gold = self._extract_answer(doc["answer"])
        assert gold != self.INVALID_ANS, \
            "No ground truth answer found in the document."
        return {"acc": float(self._extract_answer(results[0]) == gold)}

    def higher_is_better(self):
        return {"acc": True}


class DROP(DocTask):
    """reference drop.py: generate to '.'; DROP EM/F1 with number-aware bag
    alignment over the validated answer set."""
    name = "drop"
    VERSION = 1
    request_type = "greedy_until"

    _ARTICLES = re.compile(r"\b(a|an|the)\b", re.UNICODE)

    def convert(self, doc):
        return {"id": doc["query_id"], "passage": doc["passage"],
                "question": doc["question"], "answers": self.get_answers(doc)}

    @classmethod
    def get_answers(cls, qa):
        answers, seen = [], set()
        candidates = [qa["answer"]]
        va = qa.get("validated_answers")
        if va:
            candidates += [{"number": va["number"][i], "date": va["date"][i],
                            "spans": va["spans"][i]}
                           for i in range(len(va["number"]))]
        for candidate in candidates:
            answer = cls.parse_answer(candidate)
            if answer in seen:
                continue
            seen.add(answer)
            answers.append(answer)
        return answers

    @classmethod
    def parse_answer(cls, answer):
        if answer["number"] != "":
            return (str(answer["number"]),)
        if answer["spans"] != []:
            return tuple(answer["spans"])
        return (" ".join([answer["date"]["day"], answer["date"]["month"],
                          answer["date"]["year"]]).strip(),)

    def doc_to_text(self, doc):
        return (f"Passage: {doc['passage']}\nQuestion: {doc['question']}"
                "\nAnswer:")

    def doc_to_target(self, doc):
        return " " + ", ".join(doc["answers"][0])

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["passage"] + " " + doc["question"]

    def construct_requests(self, doc, ctx):
        return [rf.greedy_until(ctx, ["."])]

    def process_results(self, doc, results):
        max_em, max_f1 = 0.0, 0.0
        for gold_answer in doc["answers"]:
            em, f1 = self.get_metrics(results, gold_answer)
            if gold_answer[0].strip():
                max_em, max_f1 = max(max_em, em), max(max_f1, f1)
        return {"em": max_em, "f1": max_f1}

    # -- DROP official metric (number-aware bag alignment) -------------------
    def get_metrics(self, predicted, gold):
        predicted_bags = self._answer_to_bags(predicted)
        gold_bags = self._answer_to_bags(gold)
        exact = float(set(predicted_bags[0]) == set(gold_bags[0])
                      and len(predicted_bags[0]) == len(gold_bags[0]))
        f1_per_bag = self._align_bags(predicted_bags[1], gold_bags[1])
        return exact, round(float(np.mean(f1_per_bag)), 2)

    def _answer_to_bags(self, answer):
        raw_spans = answer if isinstance(answer, (list, tuple)) else [answer]
        spans, bags = [], []
        for raw in raw_spans:
            norm = self._normalize(raw)
            spans.append(norm)
            bags.append(set(norm.split()))
        return spans, bags

    def _align_bags(self, predicted, gold):
        from scipy.optimize import linear_sum_assignment
        scores = np.zeros([len(gold), len(predicted)])
        for gi, g in enumerate(gold):
            for pi, p in enumerate(predicted):
                if self._match_numbers_if_present(g, p):
                    scores[gi, pi] = self._bag_f1(p, g)
        row_ind, col_ind = linear_sum_assignment(-scores)
        max_scores = np.zeros([max(len(gold), len(predicted))])
        for row, col in zip(row_ind, col_ind):
            max_scores[row] = max(max_scores[row], scores[row, col])
        return max_scores

    @staticmethod
    def _bag_f1(predicted_bag, gold_bag):
        intersection = len(gold_bag & predicted_bag)
        precision = intersection / len(predicted_bag) if predicted_bag else 1.0
        recall = intersection / len(gold_bag) if gold_bag else 1.0
        return (2 * precision * recall / (precision + recall)
                if precision + recall else 0.0)

    def _match_numbers_if_present(self, gold_bag, predicted_bag):
        gold_numbers = {w for w in gold_bag if self._is_number(w)}
        pred_numbers = {w for w in predicted_bag if self._is_number(w)}
        return not gold_numbers or bool(gold_numbers & pred_numbers)

    @staticmethod
    def _is_number(text):
        try:
            float(text)
            return True
        except ValueError:
            return False

    def _normalize(self, answer):
        tokens = []
        for token in answer.lower().split():
            token = self._ARTICLES.sub(" ", token)
            # strip punctuation unless numeric
            if not self._is_number(token):
                token = "".join(c for c in token
                                if c not in set(string.punctuation))
            else:
                token = str(float(token)) if "." in token else \
                    str(int(float(token)))
            token = " ".join(token.split())
            if token:
                tokens.append(token)
        return " ".join(tokens).strip()

    def higher_is_better(self):
        return {"em": True, "f1": True}


class CoQA(DocTask):
    """reference coqa.py: conversational QA; generate to '\\nQ:', SQuAD-style
    EM/F1 against the final-turn answer set."""
    name = "coqa"
    VERSION = 1
    request_type = "greedy_until"

    def doc_to_text(self, doc):
        text = doc["story"] + "\n\n"
        questions = doc["questions"]["input_text"]
        answers = doc["answers"]["input_text"][:-1]
        for i, q in enumerate(questions):
            text += f"Q: {q}\n\n"
            text += f"A: {answers[i]}\n\n" if i < len(answers) else "A:"
        return text

    def doc_to_target(self, doc):
        return " " + doc["answers"]["input_text"][-1]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["story"] + " " + "\n".join(doc["questions"]["input_text"])

    @classmethod
    def get_answers(cls, doc):
        turn_id = len(doc["questions"]["input_text"])
        answers = [doc["answers"]["input_text"][turn_id - 1]]
        for key, extra in (doc.get("additional_answers") or {}).items():
            cand = extra["input_text"][turn_id - 1]
            if cand.lower() not in map(str.lower, answers):
                answers.append(cand)
        return answers

    def construct_requests(self, doc, ctx):
        return [rf.greedy_until(ctx, ["\nQ:"])]

    def process_results(self, doc, results):
        gold_list = self.get_answers(doc)
        pred = results[0].strip().split("\n")[0]
        # leave-one-out when multiple golds (official CoQA scorer)
        if len(gold_list) > 1:
            em = f1 = 0.0
            for i in range(len(gold_list)):
                rest = gold_list[:i] + gold_list[i + 1:]
                e, f = squad_em_f1(pred, rest)
                em, f1 = em + e, f1 + f
            n = len(gold_list)
            return {"em": em / n, "f1": f1 / n}
        em, f1 = squad_em_f1(pred, gold_list)
        return {"em": em, "f1": f1}

    def higher_is_better(self):
        return {"em": True, "f1": True}


class SQuAD2(DocTask):
    """reference squad.py SQuAD2: generation + an ' unanswerable'
    loglikelihood probe — a mixed-request-type task."""
    name = "squad2"
    VERSION = 1
    DATASET_PATH, DATASET_NAME = "squad_v2", None

    def doc_to_text(self, doc):
        return ("Title: " + doc["title"] + "\n\n" + "Background: "
                + doc["context"] + "\n\n" + "Question: " + doc["question"]
                + "\n\n" + "Answer:")

    def doc_to_target(self, doc):
        answers = doc["answers"]["text"]
        return " " + (answers[0] if answers else "unanswerable")

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["context"]

    def construct_requests(self, doc, ctx):
        return [rf.greedy_until(ctx, ["\n"]),
                rf.loglikelihood(ctx, " unanswerable")]

    def process_results(self, doc, results):
        continuation, (ll_unanswerable, _) = results
        pred = continuation.strip()
        golds = doc["answers"]["text"]
        unanswerable = not golds
        if unanswerable:
            em = f1 = float(
                pred.lower() in ("unanswerable", "no answer")
                or np.exp(ll_unanswerable) > 0.5)
        else:
            em = max(compute_exact(g, pred) for g in golds)
            f1 = max(compute_f1(g, pred) for g in golds)
        return {"exact": float(em), "f1": float(f1)}

    def higher_is_better(self):
        return {"exact": True, "f1": True}


class WordUnscramble(DocTask):
    """reference unscramble.py: exact-match of the unscrambled completion."""
    name = "anagrams1"
    request_type = "greedy_until"
    DATASET_NAME = "mid_word_1_anagrams"
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
        return [rf.greedy_until(ctx, ["\n"])]

    def process_results(self, doc, results):
        return {"acc": float(results[0] == doc["completion"])}

    def higher_is_better(self):
        return {"acc": True}


class Anagrams2(WordUnscramble):
    name = "anagrams2"
    DATASET_NAME = "mid_word_2_anagrams"


class CycleLetters(WordUnscramble):
    name = "cycle_letters"
    DATASET_NAME = "cycle_letters_in_word"


class RandomInsertion(WordUnscramble):
    name = "random_insertion"
    DATASET_NAME = "random_insertion_in_word"


class ReversedWords(WordUnscramble):
    name = "reversed_words"
    DATASET_NAME = "reversed_words"
