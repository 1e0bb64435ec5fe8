"""Pile per-subset perplexity tasks (reference evaluation/lm_eval/tasks/
pile.py): rolling-window word/byte perplexity + bits-per-byte over raw
documents of one Pile component.

A copy of ``onebit_tpu/eval/tasks/pile.py`` with its imports pointed at the
port; its optional imports stay lazy, where the JAX module has them.
"""

from __future__ import annotations

from typing import Optional, Sequence

from onebit_tpu_torch.eval.tasks.base import PerplexityTask


class PilePerplexityTask(PerplexityTask):
    """Docs are raw text strings of one Pile subset (injected, or loaded
    from a local jsonl dump via ``from_jsonl``)."""
    name = "pile_arxiv"
    VERSION = 1
    PILE_SET_NAME = "ArXiv"

    def __init__(self, docs: Sequence[str]):
        self._docs = list(docs)

    def docs(self):
        return list(self._docs)

    @classmethod
    def from_jsonl(cls, path: str, limit: Optional[int] = None):
        """Load from a Pile-format jsonl(.zst) dump: rows
        {"text": ..., "meta": {"pile_set_name": ...}} filtered to this
        subset."""
        import json
        opener = open
        if path.endswith(".zst"):
            import zstandard

            def opener(p):  # noqa: ANN001
                return zstandard.open(p, "rt")
        docs = []
        with opener(path) as fh:
            for line in fh:
                row = json.loads(line)
                meta = row.get("meta", {})
                if meta.get("pile_set_name") == cls.PILE_SET_NAME:
                    docs.append(row["text"])
                    if limit and len(docs) >= limit:
                        break
        return cls(docs)


# registry name suffix → Pile subset name (reference datasets/pile/pile.py)
PILE_SUBSETS = {
    "arxiv": "ArXiv", "books3": "Books3", "bookcorpus2": "BookCorpus2",
    "dm-mathematics": "DM Mathematics", "enron": "Enron Emails",
    "europarl": "EuroParl", "freelaw": "FreeLaw", "github": "Github",
    "gutenberg": "Gutenberg (PG-19)", "hackernews": "HackerNews",
    "nih-exporter": "NIH ExPorter", "opensubtitles": "OpenSubtitles",
    "openwebtext2": "OpenWebText2", "philpapers": "PhilPapers",
    "pile-cc": "Pile-CC", "pubmed-abstracts": "PubMed Abstracts",
    "pubmed-central": "PubMed Central", "stackexchange": "StackExchange",
    "uspto": "USPTO Backgrounds", "ubuntu-irc": "Ubuntu IRC",
    "wikipedia": "Wikipedia (en)", "youtubesubtitles": "YoutubeSubtitles",
}


def make_pile_task(suffix: str):
    return type(f"Pile_{suffix}", (PilePerplexityTask,), {
        "name": f"pile_{suffix}", "PILE_SET_NAME": PILE_SUBSETS[suffix]})
