"""Machine-translation tasks (WMT14/16/20, IWSLT'17).

Reference: evaluation/lm_eval/tasks/translation.py — per-(benchmark,
language-pair) generation tasks scored with corpus-level sacreBLEU /
chrF / TER, registered as ``{dataset}-{src}-{tgt}`` (e.g. ``wmt14-fr-en``,
tasks/__init__.py:61-76).  The reference downloads test sets through
sacrebleu at construction; here docs are injectable ``{"src", "ref"}``
rows (offline-first), with ``from_sacrebleu`` available where the
downloaded test sets already exist on disk.

A copy of ``onebit_tpu/eval/tasks/translation.py`` with its imports pointed
at the port; its optional imports stay lazy, where the JAX module has them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from onebit_tpu_torch.eval.tasks.base import DocTask, rf

# language code -> English name for the prompt (the reference resolves
# these via pycountry; the fixed benchmark set below needs only this table)
LANG_NAMES = {
    "en": "English", "fr": "French", "de": "German", "ro": "Romanian",
    "cs": "Czech", "ru": "Russian", "zh": "Chinese", "ja": "Japanese",
    "pl": "Polish", "ta": "Tamil", "iu": "Inuktitut", "km": "Khmer",
    "ps": "Pashto", "ar": "Arabic",
}

# reference tasks/__init__.py:61-71
GPT3_TRANSLATION_BENCHMARKS = {
    "wmt14": ["en-fr", "fr-en"],
    "wmt16": ["en-ro", "ro-en", "de-en", "en-de"],
}
EXTRA_BENCHMARKS = {
    "wmt20": ["cs-en", "de-en", "de-fr", "en-cs", "en-de", "en-iu",
              "en-ja", "en-km", "en-pl", "en-ps", "en-ru", "en-ta",
              "en-zh", "fr-de", "iu-en", "ja-en", "km-en", "pl-en",
              "ps-en", "ru-en", "ta-en", "zh-en"],
    "iwslt17": ["en-ar", "ar-en"],
}
SELECTED_BENCHMARKS = {**GPT3_TRANSLATION_BENCHMARKS, **EXTRA_BENCHMARKS}


def _char_split(texts: Sequence[str]) -> List[str]:
    """Space-join tokens for no-space scripts so n-gram metrics see words.

    The reference shells into jieba (zh) / nagisa (ja) segmenters; those
    aren't vendored here, so segmentation falls back to character splits —
    the same convention as train/gen_metrics.py rouge for CJK.
    """
    return [" ".join(t.replace(" ", "")) for t in texts]


NO_SPACE_LANG = {"zh", "ja"}


def _corpus_metric(kind: str):
    def agg(items):
        import sacrebleu
        refs = [[r for r, _ in items]]
        preds = [p for _, p in items]
        fn = {"bleu": sacrebleu.corpus_bleu, "chrf": sacrebleu.corpus_chrf,
              "ter": sacrebleu.corpus_ter}[kind]
        return fn(preds, refs).score
    agg.__name__ = kind
    return agg


class TranslationTask(DocTask):
    """One benchmark + language pair; docs are ``{"src", "ref"}`` rows."""

    request_type = "greedy_until"
    benchmark: str = ""
    language_pair: str = ""

    def doc_to_text(self, doc):
        src, tgt = self.language_pair.split("-")
        return (f"{LANG_NAMES[src]} phrase: " + doc["src"]
                + f"\n{LANG_NAMES[tgt]} phrase:")

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["src"]

    def doc_to_target(self, doc):
        ref = doc["ref"]
        return " " + (ref if isinstance(ref, str) else ref[0])

    def construct_requests(self, doc, ctx):
        return [rf.greedy_until(ctx, ["\n"])]

    def process_results(self, doc, results):
        ref, pred = doc["ref"], results[0]
        if self.language_pair.split("-")[-1] in NO_SPACE_LANG:
            ref = _char_split([ref])[0]
            pred = _char_split([pred])[0]
        pair = (ref, pred)
        return {"bleu": pair, "chrf": pair, "ter": pair}

    def aggregation(self):
        return {"bleu": _corpus_metric("bleu"),
                "chrf": _corpus_metric("chrf"),
                "ter": _corpus_metric("ter")}

    def higher_is_better(self):
        return {"bleu": True, "chrf": True, "ter": False}

    @classmethod
    def from_sacrebleu(cls):
        """Load the benchmark test set via sacrebleu's local cache
        (requires the reference's downloaded data; zero-egress safe only
        when already present)."""
        import sacrebleu
        src_file, ref_file = sacrebleu.download_test_set(
            cls.benchmark, cls.language_pair)
        read = lambda f: [line.rstrip("\n")
                          for line in sacrebleu.smart_open(f)]
        docs = [{"src": s, "ref": r}
                for s, r in zip(read(src_file), read(ref_file))]
        return cls(docs)


def make_translation_task(benchmark: str, language_pair: str):
    src, tgt = language_pair.split("-")
    cls = type(
        f"Translation_{benchmark}_{src}_{tgt}", (TranslationTask,),
        {"name": f"{benchmark}-{language_pair}", "benchmark": benchmark,
         "language_pair": language_pair,
         # reference version_of: zh/ja targets are v1 (segmented scoring)
         "VERSION": 1 if tgt in NO_SPACE_LANG else 0})
    return cls


def benchmark_tasks() -> Dict[str, type]:
    """``{task_name: task_class}`` across all selected benchmarks
    (reference create_tasks_from_benchmarks + selected set)."""
    return {f"{b}-{pair}": make_translation_task(b, pair)
            for b, pairs in SELECTED_BENCHMARKS.items() for pair in pairs}
