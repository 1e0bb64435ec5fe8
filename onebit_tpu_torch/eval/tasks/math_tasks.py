"""MATH (Hendrycks et al.) + ASDiv tasks.

Reference: evaluation/lm_eval/tasks/hendrycks_math.py (7 subject tasks,
generation + LaTeX answer equivalence) and tasks/asdiv.py (zero-shot
loglikelihood exact-greedy accuracy).  The answer-normalization rules
(``strip_math_string`` et al.) are the MATH paper's official grading
algorithm (github.com/hendrycks/math) which the reference also vendors —
they must match for metric parity.

A copy of ``onebit_tpu/eval/tasks/math_tasks.py`` with its imports pointed
at the port; its optional imports stay lazy, where the JAX module has them.
"""

from __future__ import annotations

from typing import Optional

from onebit_tpu_torch.eval.tasks.base import DocTask, rf
from onebit_tpu_torch.eval.tasks.metrics import mean


# -- official MATH answer grading ------------------------------------------

def last_boxed_only_string(s: str) -> Optional[str]:
    """The last ``\\boxed{...}`` / ``\\fbox{...}`` group, braces balanced."""
    idx = s.rfind("\\boxed")
    if "\\boxed " in s:
        return "\\boxed " + s.split("\\boxed ")[-1].split("$")[0]
    if idx < 0:
        idx = s.rfind("\\fbox")
        if idx < 0:
            return None
    depth = 0
    for i in range(idx, len(s)):
        if s[i] == "{":
            depth += 1
        elif s[i] == "}":
            depth -= 1
            if depth == 0:
                return s[idx:i + 1]
    return None


def remove_boxed(s: str) -> str:
    if "\\boxed " in s:
        assert s.startswith("\\boxed ")
        return s[len("\\boxed "):]
    assert s.startswith("\\boxed{") and s.endswith("}")
    return s[len("\\boxed{"):-1]


def _fix_fracs(s: str) -> str:
    parts = s.split("\\frac")
    out = parts[0]
    for p in parts[1:]:
        out += "\\frac"
        if not p:
            return s
        if p[0] == "{":
            out += p
            continue
        if len(p) < 2:
            return s
        a, b, rest = p[0], p[1], p[2:]
        if b != "{":
            out += "{" + a + "}{" + b + "}" + rest
        else:
            out += "{" + a + "}" + b + rest
    return out


def _fix_a_slash_b(s: str) -> str:
    halves = s.split("/")
    if len(halves) != 2:
        return s
    try:
        a, b = int(halves[0]), int(halves[1])
        if s == f"{a}/{b}":
            return "\\frac{" + str(a) + "}{" + str(b) + "}"
    except ValueError:
        pass
    return s


def _remove_right_units(s: str) -> str:
    if "\\text{ " in s:
        parts = s.split("\\text{ ")
        if len(parts) == 2:
            return parts[0]
    return s


def _fix_sqrt(s: str) -> str:
    if "\\sqrt" not in s:
        return s
    parts = s.split("\\sqrt")
    out = parts[0]
    for p in parts[1:]:
        if p and p[0] != "{":
            out += "\\sqrt{" + p[0] + "}" + p[1:]
        else:
            out += "\\sqrt" + p
    return out


def strip_math_string(s: str) -> str:
    """Canonicalize a LaTeX answer (official MATH grading, mirrored by
    reference hendrycks_math.py:231-283)."""
    s = s.replace("\n", "")
    s = s.replace("\\!", "")
    s = s.replace("\\\\", "\\")
    s = s.replace("tfrac", "frac").replace("dfrac", "frac")
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("^{\\circ}", "").replace("^\\circ", "")
    s = s.replace("\\$", "")
    s = _remove_right_units(s)
    s = s.replace("\\%", "").replace("%", "")
    s = s.replace(" .", " 0.").replace("{.", "{0.")
    if not s:
        return s
    if s[0] == ".":
        s = "0" + s
    eq = s.split("=")
    if len(eq) == 2 and len(eq[0]) <= 2:
        s = eq[1]
    s = _fix_sqrt(s)
    s = s.replace(" ", "")
    s = _fix_fracs(s)
    if s == "0.5":
        s = "\\frac{1}{2}"
    return _fix_a_slash_b(s)


def is_equiv(a: Optional[str], b: Optional[str]) -> bool:
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    try:
        return strip_math_string(a) == strip_math_string(b)
    except Exception:
        return a == b


# -- tasks ------------------------------------------------------------------

class MathTask(DocTask):
    """Generation task graded by LaTeX equivalence
    (reference hendrycks_math.py:27-86)."""

    DATASET_PATH = "EleutherAI/hendrycks_math"
    DEFAULT_SPLIT = "test"
    request_type = "greedy_until"

    def convert(self, d):
        d = dict(d)
        boxed = last_boxed_only_string(d["solution"])
        d["answer"] = remove_boxed(boxed) if boxed else None
        return d

    def doc_to_text(self, doc):
        return "Problem: " + doc["problem"] + "\nAnswer:"

    def doc_to_target(self, doc):
        return " " + doc["solution"]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["problem"]

    def construct_requests(self, doc, ctx):
        return [rf.greedy_until(ctx, ["\n"])]

    def process_results(self, doc, results):
        text = results[0]
        # answers framed in $...$ (reference :68-75)
        dollars = [i for i, c in enumerate(text) if c == "$"]
        answer = text if len(dollars) <= 1 else \
            text[dollars[0] + 1:dollars[-1]]
        return {"acc": float(is_equiv(answer, doc["answer"]))}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class MathAlgebra(MathTask):
    name = "math_algebra"
    DATASET_NAME = "algebra"


class MathCountingAndProbability(MathTask):
    name = "math_counting_and_prob"
    DATASET_NAME = "counting_and_probability"


class MathGeometry(MathTask):
    name = "math_geometry"
    DATASET_NAME = "geometry"


class MathIntermediateAlgebra(MathTask):
    name = "math_intermediate_algebra"
    DATASET_NAME = "intermediate_algebra"


class MathNumberTheory(MathTask):
    name = "math_num_theory"
    DATASET_NAME = "number_theory"


class MathPrealgebra(MathTask):
    name = "math_prealgebra"
    DATASET_NAME = "prealgebra"


class MathPrecalculus(MathTask):
    name = "math_precalc"
    DATASET_NAME = "precalculus"


class Asdiv(DocTask):
    """ASDiv diverse math word problems — zero-shot only, accuracy =
    continuation is the exact greedy decode (reference asdiv.py:35-95)."""

    name = "math_asdiv"
    DATASET_PATH = "EleutherAI/asdiv"
    DEFAULT_SPLIT = "validation"
    TRAIN_SPLIT = None

    def fewshot_context(self, doc, num_fewshot, rnd, description=""):
        assert num_fewshot == 0, \
            "ASDiv is intended only for the zero-shot setting."
        return super().fewshot_context(doc, num_fewshot, rnd, description)

    def doc_to_text(self, doc):
        return (doc["body"] + "\n" + "Question:" + doc["question"]
                + "\n" + "Answer:")

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["body"] + " " + doc["question"]

    def doc_to_target(self, doc):
        return " " + doc["answer"].split(" (")[0]

    def construct_requests(self, doc, ctx):
        return [(ctx, self.doc_to_target(doc))]

    def process_results(self, doc, results):
        _, greedy = results[0]
        return {"acc": float(greedy)}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}
