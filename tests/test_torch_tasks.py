"""The port's zero-shot task harness (``onebit_tpu_torch/eval/tasks``,
``eval/dummy.py``, ``eval/task_source.py``, ``eval/raw_formats.py``,
``tools/decontam/janitor.py``) against the JAX package's on the CPU.

Every suite task and an MMLU subject get synthetic raw docs in their
published schemas, made from a seed: few-shot contexts, requests and
per-doc metrics must equal JAX's; ``evaluate_tasks`` with ``DummyLM`` must
return JAX's dict exactly (stderrs too: both draw from the same seeded
generators), and on the tiny model (JAX packed params carried over by
``params_from_jax``) in fp32 its metrics, stderrs and contamination counts
must equal JAX's, with every request's log-likelihood within 1e-4 (the
bound of tests/test_torch_eval.py) and the same greedy flags and texts.
Metrics that are means of 0/1 values are held exactly; perplexities built
from the log-likelihoods to 1e-4 relative.
"""

import dataclasses
import functools
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.engine import generate as jgenerate
from onebit_tpu.eval import dummy as jdummy
from onebit_tpu.eval import raw_formats as jraw
from onebit_tpu.eval import task_source as jsrc
from onebit_tpu.eval.tasks import base as jbase
from onebit_tpu.eval.tasks import metrics as jmetrics
from onebit_tpu.eval.tasks import mmlu as jmmlu
from onebit_tpu.eval.tasks import suite as jsuite
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu.tools.decontam import janitor as jjan
from onebit_tpu_torch import params_from_jax
from onebit_tpu_torch.eval import dummy as tdummy
from onebit_tpu_torch.eval import raw_formats as traw
from onebit_tpu_torch.eval import rolling as trolling
from onebit_tpu_torch.eval import task_source as tsrc
from onebit_tpu_torch.eval.tasks import base as tbase
from onebit_tpu_torch.eval.tasks import metrics as tmetrics
from onebit_tpu_torch.eval.tasks import mmlu as tmmlu
from onebit_tpu_torch.eval.tasks import suite as tsuite
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.tools.decontam import janitor as tjan

LL_TOL = 1e-4
WORDS = ("the a cat dog river stone blue quickly jumps over under lazy bright "
         "house tree wind seven wizards watch quietly tonight small green "
         "paper runs sings carefully into market bread").split()
TASKS = ["piqa", "arc_easy", "arc_challenge", "boolq", "hellaswag",
         "winogrande", "lambada_openai", "mmlu"]
# (task, subject) of the MMLU subjects: three categories
MMLU_SUBJECTS = ["college_mathematics", "philosophy", "marketing"]


def char_tokenize(s):
    return [ord(c) % 500 for c in s]


def char_detokenize(toks):
    return "".join(chr(32 + t % 95) for t in toks)


def _text(rnd, lo, hi):
    return " ".join(rnd.choice(WORDS) for _ in range(rnd.randint(lo, hi)))


def raw_docs(name, n, seed):
    """``n`` raw rows of task ``name`` in its published schema."""
    rnd = random.Random(seed)
    rows = []
    for i in range(n):
        if name == "piqa":
            rows.append({"goal": _text(rnd, 3, 6), "sol1": _text(rnd, 2, 4),
                         "sol2": _text(rnd, 2, 4), "label": rnd.randint(0, 1)})
        elif name in ("arc_easy", "arc_challenge"):
            k = rnd.choice([3, 4])
            numeric = i % 3 == 0
            labels = ([str(j + 1) for j in range(k)] if numeric
                      else "ABCD"[:k])
            rows.append({"question": _text(rnd, 3, 7) + "?",
                         "choices": {"text": [_text(rnd, 1, 3)
                                              for _ in range(k)],
                                     "label": list(labels)},
                         "answerKey": rnd.choice(labels)})
        elif name == "boolq":
            rows.append({"passage": _text(rnd, 6, 12) + ".",
                         "question": _text(rnd, 3, 5),
                         "label": rnd.randint(0, 1)})
        elif name == "hellaswag":
            rows.append({"activity_label": rnd.choice(["Cooking", "Running"]),
                         "ctx_a": _text(rnd, 3, 6) + " [title] done",
                         "ctx_b": _text(rnd, 1, 3),
                         "endings": [_text(rnd, 2, 4) + " [step]"
                                     for _ in range(4)],
                         "label": str(rnd.randint(0, 3))})
        elif name == "winogrande":
            rows.append({"sentence": _text(rnd, 2, 4) + " _ "
                         + _text(rnd, 2, 4) + ".",
                         "option1": _text(rnd, 1, 2),
                         "option2": _text(rnd, 1, 2),
                         "answer": str(rnd.randint(1, 2))})
        elif name == "lambada_openai":
            rows.append({"text": _text(rnd, 13, 18)})
        else:
            ans = rnd.randint(0, 3)
            rows.append({"question": _text(rnd, 3, 6) + "?",
                         "choices": [_text(rnd, 1, 2) for _ in range(4)],
                         "answer": "ABCD"[ans] if i % 2 else ans})
    for r in rows:   # distinct choices: no exact ties between them
        for key in ("endings",):
            if key in r:
                r[key] = [f"{e} {j}" for j, e in enumerate(r[key])]
    return rows


SUITE = {"piqa": "PIQA", "arc_easy": "ARCEasy",
         "arc_challenge": "ARCChallenge", "boolq": "BoolQ",
         "hellaswag": "HellaSwag", "winogrande": "Winogrande",
         "lambada_openai": "Lambada"}


def make_task(side, name, raw, train=None, subject=None):
    """Task ``name`` of the JAX package (side "jax") or the port."""
    suite, mmlu = (jsuite, jmmlu) if side == "jax" else (tsuite, tmmlu)
    if name == "mmlu":
        t = mmlu.MMLUSubject(raw, subject or MMLU_SUBJECTS[0])
        t._raw_train = train
        return t
    return getattr(suite, SUITE[name])(raw, train)


def extra_tasks(base):
    """A greedy-until task and a rolling-perplexity task on ``base`` (the
    JAX or the port's ``eval/tasks/base.py``): the two request types the
    suite does not send."""
    class Gen(base.DocTask):
        name = "gen_until"
        request_type = "greedy_until"

        def doc_to_text(self, d):
            return d["text"]

        def doc_to_target(self, d):
            return " " + d["target"]

        def construct_requests(self, d, ctx):
            return [base.rf.greedy_until(ctx, ["\n", "q"])]

        def process_results(self, d, results):
            return {"exact": float(results[0].strip() == d["target"]),
                    "chars": float(len(results[0]))}

    class Ppl(base.PerplexityTask, base.DocTask):
        name = "rolling_ppl"

    rnd = random.Random(11)
    gen = Gen([{"text": _text(rnd, 3, 6), "target": _text(rnd, 1, 1)}
               for _ in range(3)])
    return [gen, Ppl([_text(rnd, 20, 40) for _ in range(2)])]


def _plain(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


# ---------------------------------------------------------------------------
# each task's docs, contexts, requests and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shots,train", [(0, False), (2, False), (2, True)],
                         ids=["zero", "two-from-eval", "two-from-train"])
@pytest.mark.parametrize("name", TASKS)
def test_task_requests_match_jax(name, shots, train):
    """Converted docs, ``fewshot_context`` (one seeded ``random.Random``
    walking the docs, as ``evaluate_tasks`` does), ``construct_requests``,
    ``process_results`` on seeded results, the decontamination query and
    the metric tables: Winogrande's option swap in a few-shot context,
    HellaSwag's preprocessing and ARC's numeric answer keys among them."""
    raw = raw_docs(name, 6, seed=1)
    raw_train = raw_docs(name, 4, seed=2) if train else None
    jt, tt = (make_task(s, name, raw, raw_train) for s in ("jax", "port"))
    assert tt.name == jt.name and tt.request_type == jt.request_type
    jdocs, tdocs = jt.docs(), tt.docs()
    assert [_plain(d) for d in tdocs] == [_plain(d) for d in jdocs]
    jr, tr = random.Random(5), random.Random(5)
    res_rng = np.random.default_rng(6)
    for jd, td in zip(jdocs, tdocs):
        jctx = jt.fewshot_context(jd, shots, jr, "Answer well.")
        tctx = tt.fewshot_context(td, shots, tr, "Answer well.")
        assert tctx == jctx
        jreq = jt.construct_requests(jd, jctx)
        assert tt.construct_requests(td, tctx) == jreq
        results = [(float(-res_rng.random() * 10), bool(res_rng.random() < .5))
                   for _ in jreq]
        assert tt.process_results(td, results) == \
            jt.process_results(jd, results)
        assert tt.doc_to_decontamination_query(td) == \
            jt.doc_to_decontamination_query(jd)
    assert tt.should_decontaminate() == jt.should_decontaminate()
    assert tt.higher_is_better() == jt.higher_is_better()
    assert {k: f.__name__ for k, f in tt.aggregation().items()} == \
        {k: f.__name__ for k, f in jt.aggregation().items()}
    if name == "winogrande" and shots:
        a, b = tt.construct_requests(td, tctx)
        assert a[0].rsplit("\n\n", 1)[0] == b[0].rsplit("\n\n", 1)[0]
    if name == "hellaswag":
        assert all("[" not in c for d in tdocs for c in d.choices)


def test_mmlu_taxonomy_and_aggregate_match_jax():
    assert tmmlu.SUBJECTS == jmmlu.SUBJECTS and len(tmmlu.SUBJECTS) == 57
    assert tmmlu.SUBCATEGORIES == jmmlu.SUBCATEGORIES
    assert tmmlu.CATEGORIES == jmmlu.CATEGORIES
    rng = np.random.default_rng(3)
    results = {f"hendrycksTest-{s}": {"acc": float(rng.random())}
               for s in tmmlu.SUBJECTS[::5]}
    results["piqa"] = {"acc": 0.5}
    results["hendrycksTest-unknown_subject"] = {"acc": 1.0}
    assert tmmlu.aggregate_mmlu(results) == jmmlu.aggregate_mmlu(results)


# ---------------------------------------------------------------------------
# metrics and the bootstrap
# ---------------------------------------------------------------------------

PAIRS = [(1, 1), (0, 1), (1, 0), (0, 0), (1, 1), (1, 1), (0, 1)]
MULTIRC = [(True, {"idx": {"paragraph": 0, "question": q}, "label": lab})
           for q, lab in ((0, 1), (0, 1), (1, 0), (1, 1), (2, 0))]


@pytest.mark.parametrize("fn,args", [
    ("mean", ([0.25, 1.0, 0.5],)),
    ("yesno", (True,)),
    ("matthews_corrcoef", (PAIRS,)),
    ("f1_score", (PAIRS,)),
    ("acc_all", (MULTIRC,)),
    ("general_detokenize", ('He said " hi " ( ok ) , it is n\'t .',)),
    ("normalize_answer", ("The  Quick, brown FOX!",)),
    ("compute_exact", ("the fox", "Fox")),
    ("compute_f1", ("a quick brown fox", "the quick red fox")),
    ("compute_f1", ("", "")),
    ("squad_em_f1", ("brown fox", ["the brown fox", "a dog"])),
], ids=lambda v: v if isinstance(v, str) else "")
def test_metrics_match_jax(fn, args):
    assert getattr(tmetrics, fn)(*args) == getattr(jmetrics, fn)(*args)


def test_bootstrap_stderrs_equal_jax_bitwise():
    vals = np.random.default_rng(0).integers(0, 2, 57).astype(float).tolist()
    assert tbase.bootstrap_stderr(vals) == jbase.bootstrap_stderr(vals)
    assert tbase.bootstrap_stderr([1.0]) == 0.0
    items = [(float(-v), int(w)) for v, w in zip(
        np.random.default_rng(1).random(23) * 40,
        np.random.default_rng(2).integers(1, 30, 23))]
    for t_agg, j_agg in ((tbase.weighted_perplexity,
                          jbase.weighted_perplexity),
                         (tbase.bits_per_byte, jbase.bits_per_byte)):
        assert t_agg(items) == j_agg(items)
        assert tbase.bootstrap_stderr_agg(t_agg, items) == \
            jbase.bootstrap_stderr_agg(j_agg, items)
    lls = [i[0] for i in items]
    assert tbase.bootstrap_stderr_agg(tbase.perplexity, lls) == \
        jbase.bootstrap_stderr_agg(jbase.perplexity, lls)


# ---------------------------------------------------------------------------
# evaluate_tasks
# ---------------------------------------------------------------------------

def _suite(side, n=8, seed=0, rolling=True):
    """All suite tasks and the MMLU subjects, ``n`` docs each, then the
    greedy-until task and (zero-shot only) the rolling-perplexity task."""
    base = jbase if side == "jax" else tbase
    tasks = [make_task(side, name, raw_docs(name, n, seed + i))
             for i, name in enumerate(TASKS) if name != "mmlu"]
    tasks += [make_task(side, "mmlu", raw_docs("mmlu", n, 20 + i), subject=s)
              for i, s in enumerate(MMLU_SUBJECTS)]
    return tasks + extra_tasks(base)[:2 if rolling else 1]


def _dirty(tasks):
    """Training texts holding every other LAMBADA doc (in raw order) and
    the first rolling-perplexity doc: each shares 13-grams with them."""
    texts = [d["text"] for t in tasks if t.name == "lambada_openai"
             for d in t.docs()][::2]
    return texts + [d + " tail" for t in tasks if t.name == "rolling_ppl"
                    for d in t.docs()[:1]]


@pytest.mark.parametrize("shots", [0, 1])
def test_evaluate_tasks_dummy_lm_matches_jax(shots):
    """``DummyLM`` on both sides: JAX's dict exactly, decontamination
    counts and ``_decontaminate`` metrics included; ``make_table`` and
    ``aggregate_mmlu`` on it give JAX's text and numbers."""
    kw = dict(num_fewshot=shots, limit=6,
              description_dict={"piqa": "Pick the better solution."})
    jt, tt = (_suite(side, rolling=not shots) for side in ("jax", "port"))
    want = jbase.evaluate_tasks(None, None, jt, char_tokenize,
                                detokenize=char_detokenize,
                                lm=jdummy.DummyLM(),
                                decontamination_ngrams=_dirty(jt), **kw)
    got = tbase.evaluate_tasks(None, None, tt, char_tokenize,
                               detokenize=char_detokenize,
                               lm=tdummy.DummyLM(),
                               decontamination_ngrams=_dirty(tt), **kw)
    assert got == want
    assert 0 < got["lambada_openai"]["contaminated"] < 6
    assert "acc_decontaminate" in got["lambada_openai"]
    assert got.get("rolling_ppl", {"contaminated": 1.0})["contaminated"] == 1
    assert tbase.make_table(got) == jbase.make_table(want)
    assert tmmlu.aggregate_mmlu(got) == jmmlu.aggregate_mmlu(want)


@pytest.fixture(scope="module")
def tiny():
    jc = JaxConfig.named("tiny")
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(3)))
    c = BitLlamaConfig.named("tiny")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), c, device="cpu")
    return jc, jp, c, tp


def _recording(monkeypatch, base):
    """Record every ``_run_requests`` call's type and results."""
    calls = []
    real = base._run_requests

    def run(params, config, rtype, payloads, *args, **kw):
        out = real(params, config, rtype, payloads, *args, **kw)
        calls.append((rtype, list(payloads), list(out)))
        return out
    monkeypatch.setattr(base, "_run_requests", run)
    return calls


def test_evaluate_tasks_tiny_model_matches_jax(tiny, monkeypatch):
    """The tiny model in fp32, zero-shot, with decontamination: each
    request's log-likelihood within 1e-4 and its greedy flag equal, the
    greedy-until texts and rolling log-likelihoods too; the 0/1 metrics
    and their stderrs exactly, the perplexities to 1e-4; the
    contamination counts equal. ``greedy_until`` generates in
    ``generate``'s default bf16 on both sides, where the two packages'
    roundings may part at a near-tie (tests/test_torch_generate.py holds
    bf16 tokens on its own prompts); here both generate in fp32, like the
    rest of the run."""
    jc, jp, c, tp = tiny
    monkeypatch.setattr(jgenerate, "generate", functools.partial(
        jgenerate.generate, compute_dtype=jnp.float32))
    monkeypatch.setattr(trolling, "generate", functools.partial(
        trolling.generate, compute_dtype=torch.float32))
    jt, tt = _suite("jax", n=3, seed=40), _suite("port", n=3, seed=40)
    kw = dict(batch_size=8, detokenize=char_detokenize, max_new_tokens=6)
    jcalls = _recording(monkeypatch, jbase)
    want = jbase.evaluate_tasks(jp, jc, jt, char_tokenize,
                                decontamination_ngrams=_dirty(jt), **kw)
    tcalls = _recording(monkeypatch, tbase)
    got = tbase.evaluate_tasks(tp, c, tt, char_tokenize,
                               compute_dtype=torch.float32,
                               decontamination_ngrams=_dirty(tt), **kw)
    assert [(r, p) for r, p, _ in tcalls] == [(r, p) for r, p, _ in jcalls]
    for (rtype, _, a), (_, _, w) in zip(tcalls, jcalls):
        if rtype == "greedy_until":
            assert a == w
            continue
        ll_a = np.array([x[0] if rtype == "loglikelihood" else x for x in a])
        ll_w = np.array([x[0] if rtype == "loglikelihood" else x for x in w])
        np.testing.assert_allclose(ll_a, ll_w, rtol=LL_TOL, atol=LL_TOL)
        if rtype == "loglikelihood":
            assert [x[1] for x in a] == [x[1] for x in w]
    assert sorted(got) == sorted(want)
    relative = ("ppl", "perplexity", "bits_per_byte")
    for task in want:
        assert sorted(got[task]) == sorted(want[task]), task
        for metric, w in want[task].items():
            if any(k in metric for k in relative):
                np.testing.assert_allclose(got[task][metric], w,
                                           rtol=LL_TOL, err_msg=metric)
            else:
                assert got[task][metric] == w, (task, metric)
    assert got["lambada_openai"]["contaminated"] == 2.0
    assert got["rolling_ppl"]["contaminated"] == 1.0


def test_run_requests_rejects_unknown_types_and_missing_detokenize(tiny):
    _, _, c, tp = tiny
    kw = dict(batch_size=2, impl="auto", compute_dtype=torch.float32,
              max_new_tokens=2)
    with pytest.raises(ValueError, match="unknown request type"):
        tbase._run_requests(tp, c, "beam", [], char_tokenize, None, **kw)
    with pytest.raises(ValueError, match="detokenize"):
        tbase._run_requests(tp, c, "greedy_until", [("ab", ("\n",))],
                            char_tokenize, None, **kw)


# ---------------------------------------------------------------------------
# task sources, raw formats and the janitor
# ---------------------------------------------------------------------------

RAW_DROP = {"nfl_1": {"passage": "Tom scored 3 touchdowns.", "qa_pairs": [
    {"question": "How many?", "query_id": "q1",
     "answer": {"number": "3", "date": {"day": "", "month": "", "year": ""},
                "spans": []},
     "validated_answers": [{"number": "", "date": {}, "spans": ["3"]}]}]}}
RAW_SQUAD = {"version": "v2.0", "data": [{"title": "Paris", "paragraphs": [
    {"context": "Paris is the capital of France.", "qas": [
        {"id": "s1", "question": "Capital?", "answers": [
            {"text": "Paris", "answer_start": 0}]},
        {"id": "s2", "question": "Mars?", "answers": [],
         "is_impossible": True}]}]}]}
LOGIQA = ("a\nThe sky.Is blue.\nWhat colour.\nA.blue\nB.red\nC.green\nD.grey"
          "\n\nc\nCats sleep.\nWhen.\nA.day\nB.never\nC.night\nD.noon\n")


def _write_sources(root):
    rows = raw_docs("piqa", 5, seed=3)
    piqa = root / "piqa"
    piqa.mkdir()
    with open(piqa / "validation.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    (piqa / "train.json").write_text(json.dumps(rows[:3]))
    boolq = root / "boolq"
    boolq.mkdir()
    for split, sep in (("validation.csv", ","), ("train.tsv", "\t")):
        (boolq / split).write_text(
            sep.join(["passage", "question", "label"]) + "\n" + "\n".join(
                sep.join([r["passage"], r["question"], str(r["label"])])
                for r in raw_docs("boolq", 3, seed=4)) + "\n")
    (root / "drop").mkdir()
    (root / "drop" / "drop_dataset_dev.json").write_text(json.dumps(RAW_DROP))
    (root / "squad2").mkdir()
    (root / "squad2" / "validation.json").write_text(json.dumps(RAW_SQUAD))
    (root / "logiqa").mkdir()
    (root / "logiqa" / "Eval.txt").write_text(LOGIQA)
    (root / "bad").mkdir()
    (root / "bad" / "validation.json").write_text(json.dumps({"x": 1}))


@pytest.mark.parametrize("name,split", [
    ("piqa", "validation"), ("piqa", "train"), ("boolq", "validation"),
    ("boolq", "train"), ("drop", "validation"), ("squad2", "validation"),
    ("logiqa", "validation")])
def test_load_split_matches_jax(tmp_path, name, split):
    """jsonl, json, csv and tsv rows; DROP by its published filename,
    SQuAD v2 as a raw object in ``<split>.json``, LogiQA's txt records."""
    _write_sources(tmp_path)
    got = tsrc.load_split(str(tmp_path), name, split)
    assert got and got == jsrc.load_split(str(tmp_path), name, split)


def test_task_sources_fail_as_jax_does(tmp_path):
    _write_sources(tmp_path)
    for fn in (lambda m: m.load_split(str(tmp_path), "missing", "test"),
               lambda m: m.read_rows(str(tmp_path / "bad" /
                                         "validation.json")),
               lambda m: m.read_rows(str(tmp_path / "x.xml"))):
        with pytest.raises((FileNotFoundError, ValueError)) as t_err:
            fn(tsrc)
        with pytest.raises(t_err.type) as j_err:
            fn(jsrc)
        assert str(t_err.value) == str(j_err.value)
    assert traw.convert_raw("drop", RAW_DROP) == \
        jraw.convert_raw("drop", RAW_DROP)
    assert traw.convert_raw("squad2", RAW_DROP) is None
    assert traw.convert_raw("piqa", RAW_DROP) is None


def test_from_source_matches_jax(tmp_path):
    """``DocTask.from_source`` with its training pool: the same docs and
    the same one-shot contexts."""
    _write_sources(tmp_path)
    jt = jsuite.PIQA.from_source(str(tmp_path), "piqa", with_train=True)
    tt = tsuite.PIQA.from_source(str(tmp_path), "piqa", with_train=True)
    assert [_plain(d) for d in tt.docs()] == [_plain(d) for d in jt.docs()]
    assert [_plain(d) for d in tt.training_docs()] == \
        [_plain(d) for d in jt.training_docs()]
    jr, tr = random.Random(1), random.Random(1)
    for jd, td in zip(jt.docs(), tt.docs()):
        assert tt.fewshot_context(td, 1, tr) == jt.fewshot_context(jd, 1, jr)
    assert tsuite.PIQA.from_source(str(tmp_path), "piqa").training_docs() \
        is None


def test_janitor_matches_jax_python_path(tmp_path):
    """The port's ``Janitor`` with ``use_native=False`` (the Python scan;
    ``use_native=True``, the default, scans in the C core, held by
    tests/test_torch_decontam.py) against JAX's Python scan: n-grams with
    their spans, contamination counts, cleaned chunks, too-dirty
    documents, and the pickled n-gram set read back."""
    rnd = random.Random(9)
    dirt = _text(rnd, 30, 30)
    clean_doc = _text(rnd, 300, 300)
    doc = clean_doc[:900] + " " + dirt.upper() + "! " + clean_doc[900:]
    kw = dict(ngram_n=5, window_to_remove=20, minimum_slice_length=30)
    tj = tjan.Janitor(use_native=False, **kw)
    jj = jjan.Janitor(use_native=False, **kw)
    assert not tj.native and tjan.Janitor().native
    for j in (tj, jj):
        j.register_contaminant(dirt)
    assert tj.dirt_ngrams == jj.dirt_ngrams
    assert tj._ngrams_with_indices(doc) == jj._ngrams_with_indices(doc)
    for s in (doc, clean_doc, dirt):
        assert tj.contamination_count(s) == jj.contamination_count(s)
        assert tj.clean(s) == jj.clean(s)
    assert tj.contamination_count(doc) > 0 and tj.clean(dirt) == []
    path = str(tmp_path / "ngrams.pkl")
    tj.save_contamination_ngrams(path)
    back = tjan.Janitor(**kw)
    back.load_contamination_ngrams(path)
    assert back.dirt_ngrams == jj.dirt_ngrams
