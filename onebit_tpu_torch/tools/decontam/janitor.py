"""Train/test decontamination: 13-gram overlap scan + window removal.

Capability parity with the reference decontamination subsystem
(evaluation/lm_eval/decontamination/janitor.py): register test-set strings
as contaminant n-grams, then ``clean`` training documents by excising a
window around every contaminated n-gram (dropping documents that are too
dirty).

Port of ``onebit_tpu/tools/decontam/janitor.py``. The scanning loop has a
C core (``janitor_core.c``, a CPython extension, the JAX package's source
copied). ``Janitor(use_native=True)``, the default, builds it at first use
with the host's C compiler (``$CC``, else Python's own) and Python's
headers (``sysconfig``), into ``build/decontam/`` at the root of the
checkout, and scans in C; a failed build raises with the compiler's
output. ``use_native=False`` is the Python scan, which yields the same
n-grams. Nothing is built when the module is imported.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import pickle
import re
import shlex
import string
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Iterable, List, Tuple

SOURCE = Path(__file__).with_name("janitor_core.c")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "decontam"
CFLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_CORE = None


def _compiler() -> List[str]:
    return shlex.split(os.environ.get("CC")
                       or sysconfig.get_config_var("CC") or "cc")


def core_path() -> Path:
    """Where the built core lives: its name carries a hash of the source,
    the compiler, the flags and the Python it is built for."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(_compiler() + list(CFLAGS)).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    digest.update(suffix.encode())
    return BUILD_DIR / f"_janitor_core-{digest.hexdigest()[:12]}{suffix}"


def build_core() -> Path:
    """Compile ``janitor_core.c`` unless its library exists; returns its
    path. Raises ``RuntimeError`` with the compiler's output when the build
    fails, and when Python's headers are missing."""
    out = core_path()
    if out.exists():
        return out
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"the decontamination C core needs Python's "
                           f"headers, and {include}/Python.h is missing")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = _compiler() + list(CFLAGS) + [f"-I{include}", "-o", str(tmp),
                                        str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except OSError as e:
        raise RuntimeError(f"building the decontamination C core: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the decontamination C core failed "
                           f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def native_core():
    """The C core's module, built first if needed (once a process)."""
    global _CORE
    with _LOCK:
        if _CORE is None:
            path = str(build_core())
            loader = importlib.machinery.ExtensionFileLoader("_janitor_core",
                                                             path)
            spec = importlib.util.spec_from_file_location(
                "_janitor_core", path, loader=loader)
            module = importlib.util.module_from_spec(spec)
            loader.exec_module(module)
            _CORE = module
        return _CORE


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
        self.native = use_native
        self._core = native_core() if use_native else None
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
        if self.native:
            return self._core.clean_ngram(s, self.delete_chars, self.ngram_n)
        words = [self.normalize(w) for w in s.split()]
        return [" ".join(words[i:i + self.ngram_n])
                for i in range(len(words) - self.ngram_n + 1)]

    def _ngrams_with_indices(self, s: str):
        if self.native:
            return self._core.clean_ngram_with_indices(
                s, self.delete_chars, self.ngram_n)
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
