"""The port's text data (``onebit_tpu_torch/train/data.py``,
``train/templates.py``) against ``onebit_tpu/train/data.py`` and
``onebit_tpu/train/templates.py`` on the cases of tests/test_data.py: the
same inputs through both, arrays equal (``np.array_equal``) and every
template's rendering the same string."""

import hashlib
import json

import numpy as np
import pytest

from onebit_tpu.train import data as jdata
from onebit_tpu.train import templates as jtpl
from onebit_tpu_torch.train import data as tdata
from onebit_tpu_torch.train import templates as ttpl

CHAR = lambda s: [ord(c) % 50 for c in s]          # noqa: E731
CHAR_SFT = lambda s: [ord(c) % 90 + 3 for c in s]  # noqa: E731


def _equal(a, b):
    assert a.dtype == b.dtype and np.array_equal(a, b), (a, b)


@pytest.mark.parametrize("lists, cutoff, eos", [
    ([[1, 2, 3], [4, 5], [6, 7, 8, 9]], 4, 0),   # concat + EOS per doc
    ([[1, 2, 3, 4, 5]], 4, None),                 # the remainder dropped
    ([[1, 2]], 4, None),                          # no whole block
], ids=["reference_semantics", "drops_remainder", "empty"])
def test_chunk_tokens(lists, cutoff, eos):
    _equal(tdata.chunk_tokens(lists, cutoff, eos_id=eos),
           jdata.chunk_tokens(lists, cutoff, eos_id=eos))


def _registry(tmp_path, sha, suffix=".json"):
    rows = [{"text": "hello world"}, {"text": "second doc"}]
    p = tmp_path / f"corpus{suffix}"
    if suffix == ".jsonl":
        p.write_text("".join(json.dumps(r) + "\n" for r in rows))
    else:
        p.write_text(json.dumps(rows) if suffix == ".json" else "raw text")
    if sha is True:
        sha = hashlib.sha1(p.read_bytes()).hexdigest()
    spec = {"file_name": p.name, "columns": {"prompt": "text"}}
    if sha:
        spec["file_sha1"] = sha
    (tmp_path / "dataset_info.json").write_text(json.dumps({"kd": spec}))
    return p


@pytest.mark.parametrize("suffix", [".json", ".jsonl", ".txt"])
def test_registry_sha1(tmp_path, suffix):
    p = _registry(tmp_path, True, suffix)
    assert tdata.checksum(str(p)) == jdata.checksum(str(p))
    info = str(tmp_path / "dataset_info.json")
    assert (vars(tdata.load_registry(info)["kd"])
            == vars(jdata.load_registry(info)["kd"]))
    texts = tdata.load_texts(str(tmp_path), "kd")
    assert texts == jdata.load_texts(str(tmp_path), "kd")
    if suffix != ".txt":
        assert texts == ["hello world", "second doc"]


def test_registry_sha1_mismatch(tmp_path):
    _registry(tmp_path, "0" * 40)
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="checksum"):
            mod.load_texts(str(tmp_path), "kd")
        assert mod.load_texts(str(tmp_path), "kd", verify=False)


@pytest.mark.parametrize("texts, cutoff, template", [
    (["abcd", "ef"], 4, "vanilla"),               # tests/test_data.py's case
    (["abcd", "ef", "ghijklmnop"], 3, "vanilla"),
    (["do x", "do y"], 16, "alpaca"),
    (["q"], 64, "vicuna"),
])
def test_prepare_kd_dataset(texts, cutoff, template):
    got = tdata.prepare_kd_dataset(texts, CHAR, cutoff_len=cutoff, eos_id=2,
                                   template=template)
    _equal(got, jdata.prepare_kd_dataset(texts, CHAR, cutoff_len=cutoff,
                                         eos_id=2, template=template))
    if texts == ["abcd", "ef"]:
        assert got.shape == (2, 4) and got.dtype == np.int32


@pytest.mark.parametrize("cutoff, template", [
    (32, "vanilla"), (5, "vanilla"), (1, "vanilla"), (64, "default")])
def test_prepare_sft_dataset_masks_prompt(cutoff, template):
    pairs = [("ab", "xyz"), ("long prompt", "r")]
    got = tdata.prepare_sft_dataset(pairs, CHAR_SFT, cutoff_len=cutoff,
                                    eos_id=2, pad_id=0, template=template)
    want = jdata.prepare_sft_dataset(pairs, CHAR_SFT, cutoff_len=cutoff,
                                     eos_id=2, pad_id=0, template=template)
    assert tdata.IGNORE_INDEX == jdata.IGNORE_INDEX == -100
    assert set(got) == set(want) == {"input_ids", "labels", "attention_mask"}
    for key in got:
        _equal(got[key], want[key])
    if (cutoff, template) == (32, "vanilla"):
        labels = got["labels"][0]
        resp = labels[labels != tdata.IGNORE_INDEX]
        assert (labels[:2] == tdata.IGNORE_INDEX).all()
        assert resp[-1] == 2 and len(resp) == 4


def test_template_registry():
    assert sorted(ttpl.REGISTRY) == sorted(jtpl.REGISTRY)
    assert len(ttpl.REGISTRY) == 18
    for name, tpl in ttpl.REGISTRY.items():
        assert dataclass_fields(tpl) == dataclass_fields(jtpl.REGISTRY[name])
    assert ttpl.get_template("vanilla").render("hi") == "hi"
    assert tdata.TEMPLATES["alpaca"]("do x").startswith(
        "Below is an instruction")
    assert "alpaca" in tdata.TEMPLATES and "nope" not in tdata.TEMPLATES


def dataclass_fields(tpl):
    return (tpl.name, tpl.prefix, tpl.prompt, tpl.system, tpl.sep,
            tpl.use_history)


RENDERS = [
    dict(query="hi"),
    dict(query="q2", history=[("q1", "a1")]),
    dict(query="q3", history=[("q1", "a1"), ("q2", "a2")],
         system="be brief"),
    dict(query="多语言 query", system=""),
]


@pytest.mark.parametrize("case", range(len(RENDERS)))
@pytest.mark.parametrize("name", sorted(jtpl.REGISTRY))
def test_template_render(name, case):
    kw = RENDERS[case]
    got = ttpl.get_template(name).render(**kw)
    assert got == jtpl.get_template(name).render(**kw)
    assert tdata.TEMPLATES[name](kw["query"]) == (
        jdata.TEMPLATES[name](kw["query"]))


def test_register_template():
    name = "test_torch_data_upper"
    try:
        for mod in (tdata, jdata):
            mod.register_template(name, lambda q: q.upper() + "!")
        assert tdata.TEMPLATES[name]("ab") == jdata.TEMPLATES[name]("ab")
        _equal(tdata.prepare_kd_dataset(["ab"], CHAR, cutoff_len=2,
                                        template=name),
               jdata.prepare_kd_dataset(["ab"], CHAR, cutoff_len=2,
                                        template=name))
    finally:
        ttpl.REGISTRY.pop(name, None)
        jtpl.REGISTRY.pop(name, None)


def test_split_and_batches():
    blocks = np.arange(40, dtype=np.int32).reshape(10, 4)
    got = tdata.split_dataset(blocks, val_size=0.2)
    want = jdata.split_dataset(blocks, val_size=0.2)
    for a, b in zip(got, want):
        _equal(a, b)
    for a, b in zip(tdata.batch_iterator(got[0], 3, epochs=2),
                    jdata.batch_iterator(want[0], 3, epochs=2)):
        _equal(a["input_ids"], b["input_ids"])
        _equal(a["labels"], b["labels"])
