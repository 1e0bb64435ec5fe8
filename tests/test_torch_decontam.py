"""The port's decontamination tools (``onebit_tpu_torch/tools/decontam``:
the janitor with its C core, the archiver, the overlap scan over pre-built
n-gram buckets) against the JAX package's on the CPU.

The C core is built from the port's own ``janitor_core.c`` into
``build/decontam/`` at the root of the checkout; its n-grams and spans must
equal the port's Python scan and JAX's on the texts of
tests/test_decontam.py, and a build that fails must raise with the
compiler's output, never fall back to Python.
"""

import json
import random

import pytest

from onebit_tpu.tools.decontam import archiver as jarch
from onebit_tpu.tools.decontam import janitor as jjan
from onebit_tpu.tools.decontam import overlap as jover
from onebit_tpu_torch.tools.decontam import archiver as tarch
from onebit_tpu_torch.tools.decontam import janitor as tjan
from onebit_tpu_torch.tools.decontam import overlap as tover

TEXTS = [
    "The QUICK brown fox, jumped over the lazy dog! Twice more.",
    "  leading spaces   multiple   gaps\nnewlines\ttabs here too",
    "short",
    "punct-only !!! ... ??? between words here now",
    "",
    "a b c d e f g h i j k l m n o p q r s t u v w x y z " * 3,
]
KW = dict(window_to_remove=5, too_dirty_cutoff=3, minimum_slice_length=5)


def _spans(j, text):
    return [tuple(t) for t in j._ngrams_with_indices(text)]


def test_core_builds_into_the_build_directory():
    """The core's library lies under ``build/decontam/`` at the root of the
    checkout, named by a hash of its source and toolchain, and it is
    loaded once a process."""
    core = tjan.native_core()
    path = tjan.core_path()
    assert path.exists() and path.parent == tjan.BUILD_DIR
    assert tjan.BUILD_DIR.parts[-2:] == ("build", "decontam")
    assert tjan.BUILD_DIR.parent.parent == tjan.SOURCE.parents[3]
    assert tjan.native_core() is core
    assert tjan.Janitor().native and not tjan.Janitor(use_native=False).native


@pytest.mark.parametrize("n", [1, 3, 13])
@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_core_matches_python_and_jax(text, n):
    """n-grams and their [start, end] spans: the C core = the port's
    Python scan = JAX's Python scan (= JAX's own C core)."""
    tn = tjan.Janitor(ngram_n=n, **KW)
    tp = tjan.Janitor(ngram_n=n, use_native=False, **KW)
    jp = jjan.Janitor(ngram_n=n, use_native=False, **KW)
    jn = jjan.Janitor(ngram_n=n, use_native=True, **KW)
    assert tn.native and not tp.native
    assert tn._ngrams(text) == tp._ngrams(text) == jp._ngrams(text)
    assert _spans(tn, text) == _spans(tp, text) == _spans(jp, text)
    if jn.native:
        assert tn._ngrams(text) == jn._ngrams(text)
        assert _spans(tn, text) == _spans(jn, text)


def test_core_cleans_as_jax_does():
    """Registering, counting and cleaning through the C core: JAX's Python
    scan's n-gram set, counts and chunks, a too-dirty document among
    them."""
    rnd = random.Random(4)
    words = "the quick brown fox jumps over a lazy dog".split()
    dirt = " ".join(rnd.choice(words) for _ in range(12))
    clean = " ".join(rnd.choice(words + ["x", "y"]) for _ in range(200))
    docs = [clean[:400] + " " + dirt.upper() + "! " + clean[400:],
            clean, (dirt + " ") * 5]
    tn = tjan.Janitor(ngram_n=4, **KW)
    jp = jjan.Janitor(ngram_n=4, use_native=False, **KW)
    for j in (tn, jp):
        j.register_contaminant(dirt)
    assert tn.dirt_ngrams == jp.dirt_ngrams
    for doc in docs:
        assert tn.contamination_count(doc) == jp.contamination_count(doc)
        assert tn.clean(doc) == jp.clean(doc)
    assert tn.clean(docs[2]) == [] and tn.contamination_count(docs[0]) > 0


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that is missing, and one that fails on the source: each
    raises ``RuntimeError`` naming the command and giving its output; no
    Janitor falls back to the Python scan."""
    monkeypatch.setattr(tjan, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tjan, "_CORE", None)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="no-such-cc"):
        tjan.Janitor()
    bad = tmp_path / "janitor_core.c"
    bad.write_text("this is not C;\n")
    monkeypatch.setattr(tjan, "SOURCE", bad)
    monkeypatch.delenv("CC")
    with pytest.raises(RuntimeError, match="error") as err:
        tjan.Janitor(ngram_n=3)
    assert "failed" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))
    assert not tjan.Janitor(use_native=False).native


def test_zstd_archive_round_trip_matches_jax(tmp_path):
    """The port writes what JAX reads and reads what JAX writes: texts,
    joined paragraph lists, metadata, plain text archives."""
    for write, read in ((tarch, jarch), (jarch, tarch)):
        path = str(tmp_path / f"{write.__name__}.jsonl.zst")
        arch = write.Archive(path)
        arch.add_data("hello world", meta={"id": 1})
        arch.add_data(["para one", "para two"])
        arch.commit()
        assert list(read.Reader().read(path)) == \
            list(write.Reader().read(path)) == \
            ["hello world", "para one\n\npara two"]
        assert list(read.Reader().read(path, get_meta=True))[0] == \
            ("hello world", {"id": 1})
        txt = str(tmp_path / f"{write.__name__}.txt")
        ta = write.TextArchive(txt)
        ta.add_data("line one")
        ta.add_data("line two")
        ta.commit()
        assert list(read.read_text_lines(txt)) == ["line one", "line two"]
        zst = str(tmp_path / f"{write.__name__}.sorted.zst")
        write.write_sorted_ngrams(zst, ["a b 0", "c d 1"])
        assert list(read.ZstTextReader(zst).read()) == ["a b 0", "c d 1"]


def test_get_train_overlap_matches_jax(tmp_path):
    """Pre-built sorted buckets in a tmp dir: the contaminated doc ids per
    task equal JAX's, and the port's cache reads back the same."""
    ngrams = tmp_path / "ngrams"
    ngrams.mkdir()
    (ngrams / "info.json").write_text(json.dumps({"ngram_size": 4}))
    tarch.write_sorted_ngrams(str(ngrams / "ngrams_0.bkt.txt.sorted.zst"),
                              sorted(["alpha beta gamma delta 0",
                                      "alpha beta gamma delta 7",
                                      "epsilon zeta eta theta 3"]))
    jarch.write_sorted_ngrams(str(ngrams / "ngrams_1.bkt.txt.sorted.zst"),
                              sorted(["one two three four 1",
                                      "x y z w 2"]))
    docs = {"taskA": ["intro Alpha BETA gamma delta outro",
                      "totally unrelated clean words here",
                      "so ONE two, three four!"],
            "taskB": ["nothing matches in this one at all",
                      "epsilon zeta eta theta"]}
    want = jover.get_train_overlap(docs, str(ngrams))
    got = tover.get_train_overlap(docs, str(ngrams),
                                  cache_dir=str(tmp_path / "cache"))
    assert got == want == {"taskA": {0, 2}, "taskB": {1}}
    assert tover.get_train_overlap(docs, str(ngrams),
                                   cache_dir=str(tmp_path / "cache")) == want
    assert tover.build_task_lookup(docs["taskA"], 4) == \
        jover.build_task_lookup(docs["taskA"], 4)
