"""The port's perplexity corpora and calibration crops
(``onebit_tpu_torch/eval/datasets.py``) against the JAX package's on the
same local text and jsonl files: the same int32 arrays, element for
element, and the same errors."""

import json

import numpy as np
import pytest

from onebit_tpu.eval import datasets as jds
from onebit_tpu_torch.eval import datasets as tds

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu "
         "nu xi omicron pi rho sigma tau upsilon").split()


def toks(s):
    return [ord(c) % 97 for c in s]


def _docs(n, seed, lo=2, hi=60):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))
            for _ in range(n)]


@pytest.fixture
def files(tmp_path):
    """A text file, a jsonl of ``text`` docs (short and long), and a jsonl
    of ``sentence`` rows (the PTB schema)."""
    (tmp_path / "wiki.txt").write_text("\n\n".join(_docs(5, 0)))
    with open(tmp_path / "c4.jsonl", "w") as f:
        f.writelines(json.dumps({"text": d}) + "\n" for d in _docs(12, 1))
    with open(tmp_path / "ptb.jsonl", "w") as f:
        f.writelines(json.dumps({"sentence": d}) + "\n"
                     for d in _docs(9, 2, 1, 12))
    return {k: str(tmp_path / f"{k}.{ext}") for k, ext in
            (("wiki", "txt"), ("c4", "jsonl"), ("ptb", "jsonl"))}


def _same(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


CASES = {
    "wikitext2": lambda m, f: m.wikitext2_tokens(toks, f["wiki"]),
    "wikitext2_jsonl": lambda m, f: m.wikitext2_tokens(toks, f["c4"]),
    "c4_eval": lambda m, f: m.c4_eval_tokens(toks, f["c4"], seqlen=64,
                                             n_windows=5, seed=3),
    "c4_new_eval": lambda m, f: m.c4_new_eval_tokens(toks, f["c4"],
                                                     seqlen=40, n_windows=3),
    "ptb": lambda m, f: m.ptb_tokens(toks, f["ptb"]),
    "ptb_val": lambda m, f: m.ptb_val_tokens(toks, f["ptb"]),
    "pile": lambda m, f: m.pile_tokens(toks, f["c4"], n_docs=4),
    "crops": lambda m, f: m.calibration_crops(
        m.wikitext2_tokens(toks, f["wiki"]), nsamples=6, seqlen=32, seed=5),
    "c4_crops": lambda m, f: m.c4_calibration_crops(
        toks, f["c4"], nsamples=4, seqlen=48, seed=2),
    "c4_new_crops": lambda m, f: m.c4_calibration_crops(
        toks, f["c4"], nsamples=4, seqlen=48, seed=2, min_len_plus=0),
    "mix_crops": lambda m, f: m.mix_calibration_crops(
        toks, 6, 16, 4, wiki_source=f["wiki"], ptb_source=f["ptb"],
        c4_source=f["c4"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_corpus_matches_jax(files, case):
    got, want = CASES[case](tds, files), CASES[case](jds, files)
    _same(got, want)


@pytest.mark.parametrize("name", ["wikitext2", "ptb", "ptb_new", "c4",
                                  "c4_new", "pile", "mix"])
def test_get_eval_tokens_matches_jax(files, name):
    source = {"w": files["wiki"], "p": files["ptb"], "c": files["c4"],
              "m": files["c4"]}[name[0]]
    got = tds.get_eval_tokens(name, toks, source=source, seqlen=32)
    want = jds.get_eval_tokens(name, toks, source=source, seqlen=32)
    if want is None:
        assert got is None
    else:
        _same(got, want)


@pytest.mark.parametrize("name,source", [("nonsense", "x"), ("c4", None)])
def test_get_eval_tokens_errors_match_jax(name, source):
    with pytest.raises(ValueError) as t_err:
        tds.get_eval_tokens(name, toks, source=source)
    with pytest.raises(ValueError) as j_err:
        jds.get_eval_tokens(name, toks, source=source)
    assert str(t_err.value) == str(j_err.value)
