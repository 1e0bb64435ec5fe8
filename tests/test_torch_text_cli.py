"""The port's text entry points against the JAX package's command lines, on
the CPU: ``eval --tasks/--task-source/--num-fewshot/--decontaminate/
--corpus/--corpus-source/--wikitext/--tokenizer``, ``generate
--tokenizer``, ``serve --tokenizer`` and ``EngineServer`` text requests,
and ``train --data --dataset --tokenizer``.

One byte-level BPE tokenizer is trained here with ``tokenizers`` on a few
strings and saved with ``PreTrainedTokenizerFast.save_pretrained`` (nothing
is downloaded; ``<s>`` opens every encoding made with special tokens, as
LLaMA's tokenizer does). Both command lines read it and a tiny native
checkpoint that the JAX writer wrote. Metrics that are means of 0/1 values
and their stderrs must equal JAX's exactly; perplexities are held to 1e-4
relative (the bound of tests/test_torch_tasks.py).
"""

import io
import json
import os
import urllib.request

os.environ.setdefault("HF_HUB_OFFLINE", "1")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from onebit_tpu.ckpt.writer import save_native as jsave  # noqa: E402
from onebit_tpu.cli import main as jmain  # noqa: E402
from onebit_tpu.core.build_start import build_start_params as jbuild  # noqa
from onebit_tpu.model import bitllama as jb  # noqa: E402
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig  # noqa: E402
from onebit_tpu.train import data as jdata  # noqa: E402
from onebit_tpu_torch import cli as tcli  # noqa: E402
from onebit_tpu_torch.engine.batching import \
    ContinuousBatchingEngine  # noqa: E402
from onebit_tpu_torch.engine.sampler import SamplingConfig  # noqa: E402
from onebit_tpu_torch.engine.server import EngineServer  # noqa: E402
from onebit_tpu_torch.train import run_kd as trun  # noqa: E402

REL_TOL = 1e-4
WORDS = ("the a cat dog river stone blue quickly jumps over under lazy bright "
         "house tree wind seven wizards watch quietly tonight small green "
         "paper runs sings carefully into market bread").split()


def _text(rng, lo, hi):
    return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi + 1))))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one torch thread each, beside the other test workers."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """The hub stays out of reach, whatever this process read before."""
    import huggingface_hub
    from transformers.utils import hub
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(hub, "_is_offline_mode", True)


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """A byte-level BPE tokenizer directory of 320 ids: <unk> 0, <s> 1,
    </s> 2 (the tiny config's BOS and EOS)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import processors, trainers
    from transformers import PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("tok")
    bpe = Tokenizer(models.BPE(unk_token="<unk>"))
    bpe.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    bpe.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=320, special_tokens=["<unk>", "<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    rng = np.random.default_rng(0)
    bpe.train_from_iterator([_text(rng, 5, 30) for _ in range(200)],
                            trainer)
    bpe.post_processor = processors.TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", 1)])
    fast = PreTrainedTokenizerFast(tokenizer_object=bpe, unk_token="<unk>",
                                   bos_token="<s>", eos_token="</s>")
    fast.save_pretrained(str(d))
    return str(d)


@pytest.fixture(scope="module")
def tok(tok_dir):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(tok_dir)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    jc = JaxConfig.named("tiny")
    jsave(str(d), jc, jb.pack_model_params(
        jb.init_params(jc, jax.random.PRNGKey(21))))
    return str(d)


def test_tokenizer_round_trip(tok, tok_dir, ckpt):
    """The tokenizer directory loads through the command line's loader;
    a directory without one (the checkpoint's) exits nonzero naming it."""
    ids = tok("the cat jumps")["input_ids"]
    assert ids[0] == 1 and max(ids) < 320
    assert tok.decode(ids[1:]) == "the cat jumps"
    assert tok("the cat", add_special_tokens=False)["input_ids"][0] != 1
    assert tcli._load_tokenizer(tok_dir)("the cat jumps")["input_ids"] == ids
    with pytest.raises(SystemExit, match="no tokenizer could be loaded from"
                       ) as exit_:
        tcli._load_tokenizer(ckpt)
    assert ckpt in str(exit_.value.code)


def _write_task_source(root, rng):
    """PIQA (validation, train), HeadQA-en (test, train) and RTE
    (validation, train) rows in their published schemas; HeadQA's
    questions are long enough to be scanned for 13-grams."""
    def rows(name, n):
        if name == "piqa":
            return [{"goal": _text(rng, 3, 6), "sol1": _text(rng, 1, 3),
                     "sol2": _text(rng, 1, 3), "label": int(rng.integers(2))}
                    for _ in range(n)]
        if name == "headqa_en":
            return [{"qtext": _text(rng, 14, 18) + "?", "answers": [
                {"atext": _text(rng, 1, 2)} for _ in range(4)],
                "ra": int(rng.integers(1, 5))} for _ in range(n)]
        return [{"sentence1": _text(rng, 4, 8) + ".", "sentence2":
                 _text(rng, 2, 4), "label": int(rng.integers(2))}
                for _ in range(n)]
    splits = {"piqa": "validation", "headqa_en": "test", "rte": "validation"}
    evals = {}
    for name, split in splits.items():
        os.makedirs(root / name)
        evals[name] = rows(name, 5)
        for s, data in ((split, evals[name]), ("train", rows(name, 3))):
            with open(root / name / f"{s}.jsonl", "w") as f:
                f.writelines(json.dumps(r) + "\n" for r in data)
    return evals


def _out(capsys):
    """(the make_table lines, the last line's JSON) of a command's
    output."""
    lines = capsys.readouterr().out.strip().splitlines()
    return [x for x in lines if x.startswith("|")], json.loads(lines[-1])


def test_eval_text_flags_match_jax(ckpt, tok_dir, tmp_path, capsys):
    """One ``eval`` with every text flag, on the same checkpoint,
    tokenizer and local files as the JAX command line: the same table,
    the same 0/1 metrics, stderrs and contamination counts (HeadQA-en's
    docs in the training text are counted), and the corpus and WikiText
    perplexities within 1e-4."""
    rng = np.random.default_rng(5)
    src = tmp_path / "tasks"
    evals = _write_task_source(src, rng)
    (tmp_path / "train.txt").write_text("\n".join(
        [r["qtext"] for r in evals["headqa_en"][:2]] + [_text(rng, 40, 60)]))
    (tmp_path / "wiki2.txt").write_text(
        "\n".join(_text(rng, 30, 60) for _ in range(8)))
    (tmp_path / "pages.txt").write_text("\n\n".join(
        f" = {_text(rng, 1, 2)} = \n {_text(rng, 20, 40)} @-@ "
        f"{_text(rng, 10, 50)} . \n" for _ in range(3)))
    args = ["eval", "--ckpt", ckpt, "--tokenizer", tok_dir, "--tasks",
            "piqa,headqa_en,rte", "--task-source", str(src),
            "--num-fewshot", "1", "--decontaminate",
            str(tmp_path / "train.txt"), "--corpus", "wikitext2",
            "--corpus-source", str(tmp_path / "wiki2.txt"), "--wikitext",
            str(tmp_path / "pages.txt"), "--seqlen", "32", "--batch-size",
            "4"]
    jmain(args)
    want_table, want = _out(capsys)
    tcli.main(args + ["--device", "cpu"])
    got_table, got = _out(capsys)
    assert sorted(got) == sorted(want) == sorted(
        ["piqa", "headqa_en", "rte", "ppl_wikitext2", "wikitext"])
    for task in ("piqa", "headqa_en", "rte"):
        assert got[task] == want[task], task
    assert got["headqa_en"]["contaminated"] == 2.0
    assert "acc_decontaminate" in got["headqa_en"]
    assert got_table == want_table and len(got_table) > 6
    np.testing.assert_allclose(got["ppl_wikitext2"], want["ppl_wikitext2"],
                               rtol=REL_TOL)
    for metric, w in want["wikitext"].items():
        np.testing.assert_allclose(got["wikitext"][metric], w, rtol=REL_TOL)


def test_generate_tokenizer_matches_jax(ckpt, tok_dir, capsys):
    """``generate --tokenizer``: the prompt is encoded with ``<s>``, the
    greedy output decoded, as the JAX command line does."""
    args = ["generate", "--ckpt", ckpt, "--tokenizer", tok_dir, "--prompt",
            "the cat jumps over", "--greedy", "--max-new-tokens", "8"]
    jmain(args)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    tcli.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode()


def test_engine_server_text_requests(ckpt, tok):
    """A server holding the tokenizer answers ``{"text": ...}`` with the
    tokens of the ``{"prompt": ...}`` request of its encoding, and with
    their decoding, in the sync and the streamed replies."""
    loaded = tcli._load_any_ckpt(ckpt, "cpu")
    eng = ContinuousBatchingEngine(
        loaded["params"], loaded["config"], max_batch=2, max_len=64,
        sampling=SamplingConfig(greedy=True), device="cpu")
    server = EngineServer(eng, tokenizer=tok)
    port = server.start(port=0)
    try:
        text = "the quick cat sings"
        ids = tok(text)["input_ids"]
        by_ids = json.loads(_post(port, {"prompt": ids,
                                         "max_new_tokens": 6}))
        by_text = json.loads(_post(port, {"text": text,
                                          "max_new_tokens": 6}))
        assert by_text == by_ids
        assert by_text["text"] == tok.decode(by_text["tokens"])
        assert len(by_text["tokens"]) >= 1
        lines = [json.loads(x) for x in _post(port, {
            "text": text, "max_new_tokens": 6, "stream": True}).splitlines()
            if x]
        assert [x["token"] for x in lines[:-1]] == by_text["tokens"]
        assert lines[-1] == {"done": True, **by_text}
    finally:
        server.stop()


def test_serve_stdin_text(ckpt, tok_dir, tok, monkeypatch, capsys):
    """``serve --tokenizer`` on stdin text lines: each completion is the
    decoding of the engine's tokens for the line's encoding."""
    prompts = ["the cat jumps", "a small green tree", "wind"]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(prompts) + "\n"))
    tcli.main(["serve", "--ckpt", ckpt, "--tokenizer", tok_dir,
               "--max-batch", "2", "--max-len", "64", "--max-new-tokens",
               "5", "--greedy", "--device", "cpu"])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    loaded = tcli._load_any_ckpt(ckpt, "cpu")
    eng = ContinuousBatchingEngine(
        loaded["params"], loaded["config"], max_batch=2, max_len=64,
        sampling=SamplingConfig(greedy=True), device="cpu")
    uids = [eng.add_request(tok(p)["input_ids"], max_new_tokens=5)
            for p in prompts]
    done = eng.run()
    assert out == [{"prompt": p, "completion": tok.decode(done[u])}
                   for p, u in zip(prompts, uids)]


def test_train_text_dataset_matches_jax(tmp_path, tok_dir, tok,
                                        monkeypatch):
    """``train --data DIR --dataset NAME --tokenizer TOK``: the blocks are
    JAX's (``load_texts`` + ``prepare_kd_dataset`` with the tokenizer's
    ``input_ids``, as the JAX command builds them), equal in shape and
    ids, and one KD step runs."""
    jc = JaxConfig.named("tiny")
    teacher = jb.init_params(jc, jax.random.PRNGKey(4), mode="linear")
    jsave(str(tmp_path / "teacher"), jc, teacher)
    jsave(str(tmp_path / "start"), jc, jbuild(teacher))
    rng = np.random.default_rng(9)
    data = tmp_path / "data"
    data.mkdir()
    with open(data / "kd.jsonl", "w") as f:
        f.writelines(json.dumps({"text": _text(rng, 20, 60)}) + "\n"
                     for _ in range(12))
    (data / "dataset_info.json").write_text(json.dumps(
        {"kd": {"file_name": "kd.jsonl", "columns": {"prompt": "text"}}}))
    want = jdata.prepare_kd_dataset(
        jdata.load_texts(str(data), "kd"), lambda s: tok(s)["input_ids"],
        cutoff_len=32, eos_id=jc.eos_token_id)
    seen = {}
    real = trun.run_kd

    def run_kd(config, student, teacher, blocks, **kw):
        seen["blocks"] = blocks
        return real(config, student, teacher, blocks, **kw)
    monkeypatch.setattr(trun, "run_kd", run_kd)
    tcli.main(["train", "--student", str(tmp_path / "start"), "--teacher",
               str(tmp_path / "teacher"), "--data", str(data), "--dataset",
               "kd", "--tokenizer", tok_dir, "--cutoff-len", "32",
               "--batch-size", "2", "--max-steps", "1", "--warmup-steps",
               "0", "--output-dir", str(tmp_path / "out"), "--device",
               "cpu"])
    got = seen["blocks"]
    assert got.shape == want.shape and want.shape[0] >= 4
    assert np.array_equal(got, want)
    with open(tmp_path / "out" / "trainer_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [e["current_steps"] for e in log] == [1]
    assert np.isfinite(log[0]["loss"])
