"""Task framework: the lm-eval-harness Task API, on the port's scorers.

Port of ``onebit_tpu/eval/tasks/base.py``. Mirrors the reference's task
machinery (evaluation/lm_eval/base.py Task / MultipleChoiceTask +
evaluator.py) re-designed around batched device scoring:

* ``Task`` exposes ``doc_to_text`` / ``doc_to_target`` /
  ``fewshot_context`` (reference base.py:576-642 semantics, including the
  draw-k-from-training vs draw-k+1-minus-self fallback) and
  ``construct_requests`` returning *string* payloads; tokenization and
  batching happen centrally, so each request type is one batched run.
* three request types (reference base.py LM API): ``loglikelihood``,
  ``greedy_until``, ``loglikelihood_rolling``.
* ``evaluate_tasks`` is the evaluator (reference evaluator.py:96-281):
  seed-42 shuffle, ``num_fewshot``, ``description_dict``, per-metric
  aggregation with bootstrap stderr, and optional decontamination
  (reference evaluator.py:215-221) that reports ``<metric>_decontaminate``
  over the uncontaminated subset.

Docs are plain dicts or ``MCDoc``; each task ships a converter from its
public dataset schema (so HF datasets plug in when present) and tests
inject synthetic docs — data acquisition is decoupled from scoring.

Requests go to the port's ``eval/loglikelihood.py`` (padded fp32 batches:
K3 fp32, never B11, on the card), ``eval/rolling.py``'s
``loglikelihood_rolling`` and ``greedy_until`` (``generate``: K1, K2, K3
and B9 on the card); the stderrs draw from the same seeded generators as
JAX's, so they equal its to the bit.
"""

from __future__ import annotations

import dataclasses
import random
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from onebit_tpu_torch.eval.loglikelihood import loglikelihood
from onebit_tpu_torch.eval.rolling import greedy_until, loglikelihood_rolling
from onebit_tpu_torch.eval.task_source import task_from_source
from onebit_tpu_torch.tools.decontam.janitor import Janitor


@dataclasses.dataclass(frozen=True)
class Request:
    """A typed scoring request (reference base.py Request + RequestFactory).

    ``type`` ∈ {loglikelihood, greedy_until, loglikelihood_rolling}; ``args``
    is the payload for that type.  Tasks may mix types in one
    ``construct_requests`` (e.g. squad: generation + an unanswerable
    loglikelihood probe) — the evaluator groups by type, batches each group
    through the model once, and scatters results back into per-doc order.
    """
    type: str
    args: Tuple


class rf:
    """Request factory (reference base.py ``rf``)."""

    @staticmethod
    def loglikelihood(ctx: str, cont: str) -> Request:
        return Request("loglikelihood", (ctx, cont))

    @staticmethod
    def greedy_until(ctx: str, stops: Sequence[str]) -> Request:
        return Request("greedy_until", (ctx, tuple(stops)))

    @staticmethod
    def loglikelihood_rolling(doc: str) -> Request:
        return Request("loglikelihood_rolling", (doc,))


@dataclasses.dataclass
class MCDoc:
    """A multiple-choice doc: context + N choice continuations.

    ``choices`` hold the RAW choice strings (no leading space) — the space
    is added at request-build time and excluded from acc_norm length
    normalization, exactly like the reference (MultipleChoiceTask
    construct_requests adds " {}" while process_results normalizes by
    len(doc["choices"][i]), base.py:649-661).
    """
    query: str
    choices: List[str]
    gold: int
    extra: Optional[dict] = None   # task-specific fields (e.g. the raw
    #   passage for decontamination queries)


def mean(items):
    return float(np.mean(items))


class Task:
    """Base task (reference base.py Task).

    ``construct_requests(doc, ctx)`` returns a list of payloads whose shape
    depends on ``request_type``:

    * ``loglikelihood``: ``(context_str, continuation_str)`` pairs; the
      result per payload is ``(ll_sum, is_greedy)``.
    * ``greedy_until``: ``(context_str, [stop_str, ...])``; result is the
      generated string (truncated at the first stop).
    * ``loglikelihood_rolling``: a document string; result is the total
      loglikelihood (float).
    """

    name: str = "task"
    VERSION: int = 0
    request_type: str = "loglikelihood"

    # -- documents ---------------------------------------------------------
    def docs(self):
        raise NotImplementedError

    def training_docs(self) -> Optional[List]:
        """Few-shot example pool (converted docs); None if the task has no
        training split (then few-shot draws from the eval docs, reference
        base.py:615-629)."""
        return None

    # -- few-shot rendering (reference base.py:576-642) ---------------------
    def doc_to_text(self, doc) -> str:
        raise NotImplementedError

    def doc_to_target(self, doc) -> str:
        raise NotImplementedError

    def fewshot_context(self, doc, num_fewshot: int, rnd: random.Random,
                        description: str = "") -> str:
        description = description + "\n\n" if description else ""
        if num_fewshot == 0:
            labeled = ""
        else:
            train = self.training_docs()
            if train:
                shots = rnd.sample(list(train), num_fewshot)
            else:
                # no training docs: draw k+1 from the eval pool and drop the
                # current doc if sampled (reference base.py:615-629)
                pool = list(self.docs())
                shots = rnd.sample(pool, min(num_fewshot + 1, len(pool)))
                shots = [x for x in shots if x != doc][:num_fewshot]
            labeled = "\n\n".join(
                self.doc_to_text(ex) + self.doc_to_target(ex)
                for ex in shots) + "\n\n"
        return description + labeled + self.doc_to_text(doc)

    # -- decontamination hooks (reference base.py:506-510) ------------------
    def should_decontaminate(self) -> bool:
        return False

    def doc_to_decontamination_query(self, doc) -> str:
        return self.doc_to_text(doc)

    # -- requests & metrics --------------------------------------------------
    def construct_requests(self, doc, ctx: str) -> List:
        raise NotImplementedError

    def process_results(self, doc, results) -> Dict[str, float]:
        raise NotImplementedError

    def aggregation(self) -> Dict[str, Callable]:
        """Per-metric aggregator; metrics not listed aggregate by mean."""
        return {}

    def higher_is_better(self) -> Dict[str, bool]:
        return {}


class MultipleChoiceTask(Task):
    """Zero/few-shot multiple choice via loglikelihood comparison.

    Metrics follow the reference MultipleChoiceTask.process_results
    (base.py:654-661): ``acc`` = argmax of raw loglikelihood, ``acc_norm``
    = argmax of byte-length-normalized loglikelihood.
    """

    name = "mc_task"

    def doc_to_text(self, doc: MCDoc) -> str:
        return doc.query

    def doc_to_target(self, doc: MCDoc) -> str:
        return " " + doc.choices[doc.gold]

    def construct_requests(self, doc: MCDoc, ctx: str):
        return [(ctx, " " + choice) for choice in doc.choices]

    def process_results(self, doc: MCDoc, results) -> Dict[str, float]:
        lls = np.asarray([r[0] for r in results])
        lens = np.asarray([max(len(c), 1) for c in doc.choices])
        return {"acc": float(np.argmax(lls) == doc.gold),
                "acc_norm": float(np.argmax(lls / lens) == doc.gold)}

    def higher_is_better(self):
        return {"acc": True, "acc_norm": True}


class DocTask(Task):
    """Injectable-doc task: eval docs (and optionally a few-shot training
    pool) are raw dataset rows passed to the constructor; ``convert``
    translates the public dataset schema.  ``from_datasets`` is the
    convenience loader when the corpus is on local disk (offline-first —
    data acquisition is decoupled from scoring, unlike the reference whose
    Task.__init__ downloads from the hub)."""

    DATASET_PATH: Optional[str] = None
    DATASET_NAME: Optional[str] = None
    DEFAULT_SPLIT: str = "validation"
    TRAIN_SPLIT: Optional[str] = "train"

    def __init__(self, raw_docs: Sequence, raw_train: Optional[Sequence] = None):
        self._raw = list(raw_docs)
        self._raw_train = list(raw_train) if raw_train is not None else None

    def convert(self, doc):
        return doc

    def docs(self) -> List:
        return [self.convert(d) for d in self._raw]

    def training_docs(self) -> Optional[List]:
        if self._raw_train is None:
            return None
        return [self.convert(d) for d in self._raw_train]

    @classmethod
    def from_source(cls, source_dir: str, name: str,
                    split: Optional[str] = None, with_train: bool = False):
        """Load raw rows from local files under ``source_dir/name``
        (eval/task_source.py conventions) — the offline path replacing the
        reference's 13 vendored HF dataset builders
        (evaluation/lm_eval/datasets/)."""
        return task_from_source(cls, name, source_dir, split=split,
                                with_train=with_train)

    @classmethod
    def from_datasets(cls, split: Optional[str] = None,
                      with_train: bool = False, **load_kwargs):
        import datasets
        split = split or cls.DEFAULT_SPLIT
        ds = datasets.load_dataset(cls.DATASET_PATH, cls.DATASET_NAME,
                                   split=split, **load_kwargs)
        train = None
        if with_train and cls.TRAIN_SPLIT:
            train = list(datasets.load_dataset(
                cls.DATASET_PATH, cls.DATASET_NAME, split=cls.TRAIN_SPLIT,
                **load_kwargs))
        return cls(list(ds), train)


class PerplexityTask(Task):
    """Whole-document perplexity via rolling windows (reference base.py
    PerplexityTask, :674-760): metrics ``word_perplexity``,
    ``byte_perplexity``, ``bits_per_byte`` with weighted aggregation."""

    request_type = "loglikelihood_rolling"

    def doc_to_text(self, doc) -> str:
        return ""

    def doc_to_target(self, doc) -> str:
        return doc

    def fewshot_context(self, doc, num_fewshot, rnd, description=""):
        assert num_fewshot == 0, "perplexity tasks are zero-shot only"
        return ""

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc

    def count_words(self, doc: str) -> int:
        return len(re.split(r"\s+", doc))

    def count_bytes(self, doc: str) -> int:
        return len(doc.encode("utf-8"))

    def construct_requests(self, doc, ctx):
        assert not ctx
        return [self.doc_to_target(doc)]

    def process_results(self, doc, results):
        (ll,) = results
        return {"word_perplexity": (ll, self.count_words(self.doc_to_target(doc))),
                "byte_perplexity": (ll, self.count_bytes(self.doc_to_target(doc))),
                "bits_per_byte": (ll, self.count_bytes(self.doc_to_target(doc)))}

    def aggregation(self):
        return {"word_perplexity": weighted_perplexity,
                "byte_perplexity": weighted_perplexity,
                "bits_per_byte": bits_per_byte}

    def higher_is_better(self):
        return {"word_perplexity": False, "byte_perplexity": False,
                "bits_per_byte": False}


def perplexity(items) -> float:
    """exp(-mean(ll)) (reference metrics.py perplexity)."""
    return float(np.exp(-np.mean(items)))


def weighted_perplexity(items) -> float:
    """exp(-sum(ll)/sum(weight)) (reference metrics.py weighted_perplexity)."""
    lls, weights = zip(*items)
    return float(np.exp(-np.sum(lls) / np.sum(weights)))


def bits_per_byte(items) -> float:
    lls, weights = zip(*items)
    return float(-np.sum(lls) / np.sum(weights) / np.log(2))


def bootstrap_stderr(values: Sequence[float], iters: int = 1000,
                     seed: int = 1234) -> float:
    """Bootstrap standard error of the mean (reference metrics.py)."""
    values = np.asarray(values, np.float64)
    if len(values) <= 1:
        return 0.0
    rng = np.random.default_rng(seed)
    means = [rng.choice(values, size=len(values), replace=True).mean()
             for _ in range(iters)]
    return float(np.std(means, ddof=1))


def bootstrap_stderr_agg(agg: Callable, items: List, iters: int = 200,
                         seed: int = 1234) -> float:
    """Bootstrap stderr of an arbitrary aggregation over items (reference
    metrics.stderr_for_metric / bootstrap_stderr)."""
    if len(items) <= 1:
        return 0.0
    rng = random.Random(seed)
    stats = []
    for _ in range(iters):
        sample = [items[rng.randrange(len(items))] for _ in range(len(items))]
        try:
            stats.append(agg(sample))
        except Exception:
            return 0.0
    return float(np.std(np.asarray(stats, np.float64), ddof=1))


@torch.no_grad()
def _run_requests(params, config, request_type: str, payloads: List,
                  tokenize, detokenize, *, batch_size: int, impl: str,
                  compute_dtype, max_new_tokens: int, lm=None):
    """Dispatch a homogeneous batch of request payloads to the scorers.

    ``lm`` overrides the backend with any object exposing the three-method
    LM surface (e.g. :class:`onebit_tpu_torch.eval.dummy.DummyLM`),
    mirroring the reference's model registry (models/dummy.py is its only
    fake)."""
    if request_type == "loglikelihood":
        reqs = []
        for ctx, cont in payloads:
            ctx_toks = tokenize(ctx)
            cont_toks = tokenize(cont)
            if not cont_toks:
                cont_toks = tokenize(cont.strip())
            reqs.append((ctx_toks, cont_toks))
        if lm is not None:
            return lm.loglikelihood(reqs)
        return loglikelihood(params, config, reqs, batch_size=batch_size,
                             impl=impl, compute_dtype=compute_dtype,
                             max_length=config.max_position_embeddings)
    if request_type == "loglikelihood_rolling":
        docs_toks = [tokenize(text) for text in payloads]
        if lm is not None:
            return lm.loglikelihood_rolling(docs_toks)
        return loglikelihood_rolling(
            params, config, docs_toks, batch_size=batch_size,
            compute_dtype=compute_dtype,
            max_length=config.max_position_embeddings, impl=impl)
    if request_type == "greedy_until":
        reqs = [(tokenize(ctx), stops) for ctx, stops in payloads]
        if lm is not None:
            return lm.greedy_until(reqs, detokenize=detokenize,
                                   max_new_tokens=max_new_tokens)
        if detokenize is None:
            raise ValueError("greedy_until tasks need a detokenize fn")
        return greedy_until(params, config, reqs, detokenize,
                            max_new_tokens=max_new_tokens,
                            batch_size=batch_size, impl=impl)
    raise ValueError(f"unknown request type {request_type!r}")


def _find_contaminated(task, docs, ngrams_source, n: int = 13) -> set:
    """Doc indices whose decontamination query shares an n-gram with the
    training source (reference decontamination/decontaminate.py semantics,
    13-gram Janitor scan)."""
    janitor = Janitor(ngram_n=n)
    if isinstance(ngrams_source, str):
        ngrams_source = [ngrams_source]
    for text in ngrams_source:
        janitor.register_contaminant(text)
    dirty = set()
    for i, doc in enumerate(docs):
        query = task.doc_to_decontamination_query(doc)
        if janitor.contamination_count(query) > 0:
            dirty.add(i)
    return dirty


def evaluate_tasks(params, config, tasks, tokenize, *, batch_size: int = 16,
                   limit: Optional[int] = None, impl: str = "auto",
                   compute_dtype=None, seed: int = 42, num_fewshot: int = 0,
                   description_dict: Optional[Dict[str, str]] = None,
                   detokenize: Optional[Callable] = None,
                   max_new_tokens: int = 256,
                   decontamination_ngrams=None,
                   bootstrap_iters: int = 1000, lm=None) -> Dict[str, Dict]:
    """Run tasks → {task: {metric: value, metric_stderr: err}}.

    Doc order is shuffled with the reference's seed-42 convention and the
    same ``random.Random`` instance then drives few-shot sampling
    (evaluator.py:176-196).  ``decontamination_ngrams``: training text(s)
    to scan for 13-gram overlap; adds ``<metric>_decontaminate`` computed
    over clean docs only plus a ``contaminated`` count
    (evaluator.py:215-221,252-260).
    """
    compute_dtype = compute_dtype or torch.float32
    out: Dict[str, Dict] = {}
    for task in tasks:
        docs = list(task.docs())
        rnd = random.Random()
        rnd.seed(seed)
        rnd.shuffle(docs)
        if limit:
            docs = docs[:limit]
        description = (description_dict or {}).get(task.name, "")

        requests, spans = [], []
        for doc in docs:
            ctx = task.fewshot_context(doc, num_fewshot, rnd, description)
            reqs = [r if isinstance(r, Request) else Request(task.request_type,
                                                             tuple(r) if isinstance(r, (tuple, list)) else (r,))
                    for r in task.construct_requests(doc, ctx)]
            spans.append((len(requests), len(requests) + len(reqs)))
            requests.extend(reqs)

        # group by request type; one batched device dispatch per type
        results: List = [None] * len(requests)
        by_type: Dict[str, List[int]] = {}
        for i, r in enumerate(requests):
            by_type.setdefault(r.type, []).append(i)
        for rtype, idxs in by_type.items():
            payloads = [requests[i].args if rtype != "loglikelihood_rolling"
                        else requests[i].args[0] for i in idxs]
            res = _run_requests(
                params, config, rtype, payloads, tokenize, detokenize,
                batch_size=batch_size, impl=impl,
                compute_dtype=compute_dtype, max_new_tokens=max_new_tokens,
                lm=lm)
            for i, v in zip(idxs, res):
                results[i] = v

        dirty = set()
        if decontamination_ngrams is not None and task.should_decontaminate():
            dirty = _find_contaminated(task, docs, decontamination_ngrams)

        vals: Dict[str, List] = {}
        clean_vals: Dict[str, List] = {}
        for i, (doc, (s, e)) in enumerate(zip(docs, spans)):
            metrics = task.process_results(doc, results[s:e])
            for metric, value in metrics.items():
                vals.setdefault(metric, []).append(value)
                if decontamination_ngrams is not None and i not in dirty:
                    clean_vals.setdefault(metric, []).append(value)

        aggs = task.aggregation()
        entry: Dict[str, float] = {}
        for metric, items in vals.items():
            agg = aggs.get(metric, mean)
            entry[metric] = float(agg(items))
            if agg is mean:
                entry[f"{metric}_stderr"] = bootstrap_stderr(
                    [float(v) for v in items], iters=min(bootstrap_iters, 1000))
            else:
                entry[f"{metric}_stderr"] = bootstrap_stderr_agg(agg, items)
        if decontamination_ngrams is not None:
            entry["contaminated"] = float(len(dirty))
            for metric, items in clean_vals.items():
                agg = aggs.get(metric, mean)
                entry[f"{metric}_decontaminate"] = float(agg(items))
        out[task.name] = entry
    return out


def make_table(results: Dict[str, Dict]) -> str:
    """Markdown results table (reference evaluator.make_table,
    evaluator.py:283-314)."""
    lines = ["|Task|Metric|Value|Stderr|", "|---|---|---:|---:|"]
    for task in sorted(results):
        for metric in sorted(results[task]):
            if metric.endswith("_stderr"):
                continue
            err = results[task].get(f"{metric}_stderr", 0.0)
            lines.append(f"|{task}|{metric}|{results[task][metric]*100:.2f}"
                         f"|±{err*100:.2f}|")
    return "\n".join(lines)
