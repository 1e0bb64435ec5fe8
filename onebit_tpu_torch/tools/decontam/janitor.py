"""Train/test decontamination: 13-gram overlap scan + window removal.

Capability parity with the reference decontamination subsystem
(evaluation/lm_eval/decontamination/janitor.py): register test-set strings
as contaminant n-grams, then ``clean`` training documents by excising a
window around every contaminated n-gram (dropping documents that are too
dirty).

The pure-Python path of ``onebit_tpu/tools/decontam/janitor.py``. The JAX
package also builds a C core for the scanning loop on first use, which
yields the same n-grams; the port has none yet (ROADMAP.md), so
``Janitor(use_native=True)`` scans in Python, as JAX's does when its core
is absent.
"""

from __future__ import annotations

import pickle
import re
import string
from typing import Iterable, List, Tuple


def _py_words_with_indices(s: str) -> Iterable[Tuple[str, int, int]]:
    for m in re.finditer(r"\S+", s):
        yield m.group(0), m.start(), m.end() - 1


class Janitor:
    """13-gram decontaminator (reference defaults, janitor.py:106-120)."""

    def __init__(self, ngram_n: int = 13, window_to_remove: int = 200,
                 too_dirty_cutoff: int = 10,
                 minimum_slice_length: int = 200,
                 delete_chars: str = string.punctuation,
                 use_native: bool = True):
        self.ngram_n = ngram_n
        self.window_to_remove = window_to_remove
        self.too_dirty_cutoff = too_dirty_cutoff
        self.minimum_slice_length = minimum_slice_length
        self.delete_chars = delete_chars
        self.native = False   # no C core yet: use_native scans in Python
        self.dirt_ngrams = set()
        self._table = str.maketrans(
            string.ascii_uppercase, string.ascii_lowercase, delete_chars)

    # -- persistence --------------------------------------------------------
    def save_contamination_ngrams(self, filename: str) -> None:
        with open(filename, "wb") as f:
            pickle.dump(self.dirt_ngrams, f)

    def load_contamination_ngrams(self, filename: str) -> None:
        with open(filename, "rb") as f:
            self.dirt_ngrams = pickle.load(f)

    # -- core ---------------------------------------------------------------
    def normalize(self, s: str) -> str:
        return s.translate(self._table)

    def _ngrams(self, s: str) -> List[str]:
        words = [self.normalize(w) for w in s.split()]
        return [" ".join(words[i:i + self.ngram_n])
                for i in range(len(words) - self.ngram_n + 1)]

    def _ngrams_with_indices(self, s: str):
        out = []
        wi = list(_py_words_with_indices(s))
        for i in range(len(wi) - self.ngram_n + 1):
            span = wi[i:i + self.ngram_n]
            ngram = " ".join(self.normalize(w) for w, _, _ in span)
            out.append((ngram, span[0][1], span[-1][2]))
        return out

    def register_contaminant(self, dirt_string: str) -> None:
        self.dirt_ngrams.update(self._ngrams(dirt_string))

    def contamination_count(self, dirty_string: str) -> int:
        """Number of registered dirt n-grams appearing in the string."""
        return sum(1 for g in self._ngrams(dirty_string)
                   if g in self.dirt_ngrams)

    def clean(self, dirty_string: str) -> List[str]:
        """Remove contaminated windows; [] if too dirty (≥cutoff hits)."""
        hits = [(g, s, e) for g, s, e in
                self._ngrams_with_indices(dirty_string)
                if g in self.dirt_ngrams]
        return self._split_chunks(dirty_string, hits)

    def _split_chunks(self, dirty_string: str, dirty_parts) -> List[str]:
        # reference janitor.py:170-187 window-splice logic
        clean_chunks = []
        splice_idx = 0
        end = -1
        for i, (_, start, end) in enumerate(dirty_parts):
            if i >= self.too_dirty_cutoff:
                return []
            start = max(0, start - self.window_to_remove)
            end = min(len(dirty_string), end + self.window_to_remove)
            if start - splice_idx > self.minimum_slice_length:
                clean_chunks.append(dirty_string[splice_idx:start])
            splice_idx = end
        if end < len(dirty_string) - self.minimum_slice_length:
            clean_chunks.append(dirty_string[end + 1:])
        return clean_chunks
