"""The port's SFT stage against the JAX package's on the CPU: the
generation metrics (``train/gen_metrics.py``), ``run_sft``,
``save_predictions`` and ``train --config``.

``run_sft`` is held step by step to JAX's ``make_train_step`` with every
distillation term off, fed the rows that the seed draws from JAX's
``prepare_sft_dataset`` (JAX's own ``run_sft`` loop is slow-marked in
tests/test_data.py), on the tiny config in fp32: each step's loss within
1e-4 relative; g and h within 1e-5 in norm (the bound of
tests/test_torch_train.py), the latent weights within 1e-4. Adam divides
each gradient by its magnitude plus 1e-8, so where a gradient lies near 0
fp32 summation noise moves the update by up to a few percent of the
learning rate (tests/test_torch_train.py); the prompt mask leaves many
latent gradients near 0, and after two steps the worst leaf (v_proj) lies
1.2e-5 of its norm from JAX's, while g and h lie within 1e-8. The
generation metrics are pure Python on both sides and must be equal to the
last float.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from onebit_tpu.ckpt.writer import save_native as jsave
from onebit_tpu.core.build_start import build_start_params as jbuild
from onebit_tpu.engine import generate as jgenerate
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu.train import data as jdata
from onebit_tpu.train import gen_metrics as jgm
from onebit_tpu.train import losses as jlosses
from onebit_tpu.train import run_sft as jsft
from onebit_tpu.train import trainer as jt
from onebit_tpu_torch import cli as tcli
from onebit_tpu_torch.convert import params_from_jax, params_to_numpy
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.train import gen_metrics as tgm
from onebit_tpu_torch.train import run_sft as tsft
from onebit_tpu_torch.train.run_kd import KDRunConfig
from onebit_tpu_torch.train.trainer import TrainConfig

LOSS_TOL = 1e-4
LEAF_TOL = 1e-5
LATENT_TOL = 1e-4


def char_tokenize(s):
    """tests/test_data.py's SFT tokenizer."""
    return [ord(c) % 200 + 5 for c in s]


# ---------------------------------------------------------------------------
# generation metrics
# ---------------------------------------------------------------------------

METRIC_CASES = {
    "cjk": (["今天天气很好，我们去公园", "机器学习 model 很有趣"],
            ["今天天气不错，我们去公园散步", "深度学习 model 很有意思"]),
    "english": (["the cat sat on the mat", "a quick brown fox"],
                ["the cat is on the mat today", "the quick brown fox jumps"]),
    "empty_prediction": (["", "x"], ["some label words", "x y"]),
    "identical": (["same words here 同样", "ok"],
                  ["same words here 同样", "ok"]),
    "short": (["a b", "c"], ["a b c d e", "c"]),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_generation_metrics_equal_jax(case):
    preds, labels = METRIC_CASES[case]
    got = tgm.compute_generation_metrics(preds, labels)
    assert got == jgm.compute_generation_metrics(preds, labels)
    assert sorted(got) == ["bleu-4", "rouge-1", "rouge-2", "rouge-l"]
    for p, lab in zip(preds, labels):
        hyp, ref = tgm.segment(p), tgm.segment(lab)
        assert hyp == jgm.segment(p)
        for n in (1, 2):
            assert tgm.rouge_n_f1(hyp, ref, n) == jgm.rouge_n_f1(hyp, ref, n)
        assert tgm.rouge_l_f1(hyp, ref) == jgm.rouge_l_f1(hyp, ref)
        assert tgm.bleu4(list(p), [list(lab)]) == \
            jgm.bleu4(list(p), [list(lab)])
    if case == "identical":
        assert got["rouge-1"] == 100.0


# ---------------------------------------------------------------------------
# run_sft against JAX's train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jc = JaxConfig.named("tiny")
    student = jb.init_params(jc, jax.random.PRNGKey(0), mode="latent")
    return jc, student, BitLlamaConfig.named("tiny")


def _port(tree, c):
    return params_from_jax(jax.tree.map(np.asarray, tree), c, device="cpu")


PAIRS = [("what is", "an answer"), ("compute", "42"),
         ("name a colour", "blue, or green"), ("say hi", "hi there"),
         ("count to three", "one two three")]


@pytest.mark.parametrize("n_pairs,batch,cutoff,template", [
    (5, 2, 64, "vanilla"), (3, 4, 30, "belle")],
    ids=["draw-without-replacement", "replace-and-truncate"])
def test_run_sft_matches_jax_steps(tiny, tmp_path, n_pairs, batch, cutoff,
                                   template):
    """Two fp32 steps without warmup; with 3 pairs at batch 4 the seed
    draws with replacement, and the belle template's rows are cut at 30
    tokens, inside each response."""
    jc, student, c = tiny
    pairs = PAIRS[:n_pairs]
    seed, steps = 3, 2
    kw = dict(learning_rate=1e-3, warmup_steps=0)
    state = tsft.run_sft(
        c, _port(student, c), pairs, char_tokenize, cutoff_len=cutoff,
        template=template, train_cfg=TrainConfig(**kw),
        run_cfg=KDRunConfig(output_dir=str(tmp_path), batch_size=batch,
                            max_steps=steps, log_steps=1, plot=False,
                            compute_dtype=torch.float32, seed=seed))
    assert state.step == steps
    with open(tmp_path / "trainer_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [e["current_steps"] for e in log] == [1, 2]

    data = jdata.prepare_sft_dataset(pairs, char_tokenize, cutoff_len=cutoff,
                                     eos_id=jc.eos_token_id or 2,
                                     template=template)
    tcfg = jt.TrainConfig(total_steps=steps, **kw)
    jstate = jt.init_train_state(jax.tree.map(jnp.copy, student), tcfg)
    step = jt.make_train_step(jc, jlosses.KDConfig(0.0, 0.0, 0.0, 0.0), tcfg,
                              compute_dtype=jnp.float32, donate=False)
    rng = np.random.default_rng(seed)
    n = len(data["input_ids"])
    for entry in log:
        idx = rng.choice(n, size=batch, replace=n < batch)
        jstate, m = step(jstate, None,
                         {k: jnp.asarray(v[idx]) for k, v in data.items()})
        assert sorted(k for k in entry if k in m) == sorted(m)
        for k in m:
            np.testing.assert_allclose(entry[k], float(m[k]), rtol=LOSS_TOL,
                                       err_msg=k)
        assert entry["loss"] == entry["student_loss"]
    got = params_to_numpy(state.params)
    for name in jb.PROJ_NAMES:
        for field in ("latent", "weight_scale", "input_factor"):
            a = got["layers"][name][field]
            w = np.asarray(getattr(jstate.params["layers"][name], field))
            tol = LATENT_TOL if field == "latent" else LEAF_TOL
            assert np.linalg.norm(a - w) <= tol * np.linalg.norm(w), field
    with pytest.raises(NotImplementedError, match="one device"):
        tsft.run_sft(c, _port(student, c), pairs, char_tokenize,
                     run_cfg=KDRunConfig(output_dir=str(tmp_path / "x"),
                                         mesh_shape=(2, 1)))


def test_save_predictions_matches_jax(tiny, tmp_path, monkeypatch):
    """The same jsonl text (ensure_ascii off: a CJK label) and the same
    ``predict_results.json`` from the same latent params. Both sides
    generate in fp32 here (``generate``'s default is bf16, where the two
    packages' roundings may part at a near-tie of the tiny model's
    logits; tests/test_torch_generate.py holds bf16 tokens)."""
    jc, student, c = tiny
    monkeypatch.setattr(jgenerate, "generate", functools.partial(
        jgenerate.generate, compute_dtype=jnp.float32))
    monkeypatch.setattr(tsft, "generate", functools.partial(
        tsft.generate, compute_dtype=torch.float32))

    def detok(toks):
        return " ".join(map(str, toks))

    prompts = ["a prompt", "another, longer prompt", "ok"]
    first = jsft.save_predictions(str(tmp_path / "probe"), student, jc,
                                  prompts, [""] * 3, char_tokenize, detok,
                                  max_new_tokens=5, compute_metrics=False)
    with open(first) as f:
        preds = [json.loads(line)["predict"] for line in f]
    labels = [preds[0], preds[1][:6] + " 金 7", "gold 标签"]
    kw = dict(max_new_tokens=5)
    want = jsft.save_predictions(str(tmp_path / "jax"), student, jc, prompts,
                                 labels, char_tokenize, detok, **kw)
    got = tsft.save_predictions(str(tmp_path / "port"), _port(student, c), c,
                                prompts, labels, char_tokenize, detok, **kw)
    assert got == str(tmp_path / "port" / "generated_predictions.jsonl")
    with open(got, encoding="utf-8") as a, open(want, encoding="utf-8") as b:
        text = a.read()
        assert text == b.read()
    assert "金" in text and len(text.splitlines()) == 3
    results = [json.loads((tmp_path / d / "predict_results.json").read_text())
               for d in ("port", "jax")]
    # the first label is the first prediction: its rouge-1 is 100
    assert results[0] == results[1] and results[0]["rouge-1"] >= 100 / 3
    assert results[0]["bleu-4"] > 0


# ---------------------------------------------------------------------------
# train --config
# ---------------------------------------------------------------------------

FLAGS = ["--batch-size", "2", "--max-steps", "2", "--save-steps", "2",
         "--warmup-steps", "1", "--learning-rate", "0.002", "--kd-beta",
         "0.5", "--remat"]
CONFIG = {"batch_size": 2, "max-steps": 2, "save_steps": 2,
          "warmup_steps": 1, "learning_rate": 0.002, "kd_beta": 0.5,
          "remat": True}


def _write_config(path, data):
    if str(path).endswith(".yaml"):
        path.write_text(yaml.safe_dump(data))
    else:
        path.write_text(json.dumps(data))
    return str(path)


@pytest.mark.parametrize("ext", ["yaml", "json"])
def test_train_config_file_gives_the_flags_args(tmp_path, ext):
    """A yaml and a json file give the ``args`` that the same flags give
    (the file's values override the command line's)."""
    parser = tcli.build_parser()
    paths = ["--student", "s", "--teacher", "t", "--tokens", "b.npy"]
    want = vars(parser.parse_args(["train", *paths, *FLAGS]))
    cfg = _write_config(tmp_path / f"cfg.{ext}", CONFIG)
    args = parser.parse_args(["train", *paths, "--batch-size", "7",
                              "--config", cfg])
    tcli._apply_config_file(args)
    got = vars(args)
    assert got.pop("config") == cfg and want.pop("config") is None
    assert got == want


@pytest.mark.parametrize("data,match", [
    ({"batch_size": 2, "not_a_flag": 1}, "unknown config key"),
    ({"data": "corpus_dir", "dataset": "kd"}, None),
    ({"sharded_ckpt": True}, None),
    ({"batch_size": 2}, None)], ids=["unknown", "data", "sharded", "no-ckpt"])
def test_train_config_file_refusals(tmp_path, data, match, capsys):
    """An unknown key raises ``ValueError``; without ``--student``/
    ``--teacher`` from either source the parser exits nonzero (2), also
    with the text dataset keys and ``sharded_ckpt``, which are ported."""
    cfg = _write_config(tmp_path / "cfg.json", data)
    if match == "unknown config key":
        with pytest.raises(ValueError, match=match):
            tcli.main(["train", "--config", cfg, "--device", "cpu"])
        return
    with pytest.raises(SystemExit) as exit_:
        tcli.main(["train", "--config", cfg, "--device", "cpu"])
    assert exit_.value.code == 2
    assert "--student and --teacher" in capsys.readouterr().err


def test_train_config_runs_as_the_flags_do(tmp_path):
    """``train --config cfg.yaml --device cpu`` on tiny native checkpoints
    (the JAX writer's, a linear teacher and its SVID start) trains as the
    same flags do: the same log, bit for bit."""
    jc = JaxConfig.named("tiny")
    teacher = jb.init_params(jc, jax.random.PRNGKey(4), mode="linear")
    jsave(str(tmp_path / "teacher"), jc, teacher)
    jsave(str(tmp_path / "start"), jc, jbuild(teacher))
    blocks = np.random.default_rng(1).integers(0, jc.vocab_size, (4, 32))
    np.save(tmp_path / "blocks.npy", blocks.astype(np.int32))
    paths = {"student": str(tmp_path / "start"),
             "teacher": str(tmp_path / "teacher"),
             "tokens": str(tmp_path / "blocks.npy")}
    tcli.main(["train", *[a for k, v in paths.items() for a in (f"--{k}", v)],
               *FLAGS, "--output-dir", str(tmp_path / "flags"),
               "--device", "cpu"])
    cfg = _write_config(tmp_path / "cfg.yaml", dict(
        CONFIG, output_dir=str(tmp_path / "file"), **paths))
    tcli.main(["train", "--config", cfg, "--device", "cpu"])
    logs = []
    for d in ("flags", "file"):
        with open(tmp_path / d / "trainer_log.jsonl") as f:
            logs.append([{k: v for k, v in json.loads(line).items()
                          if "time" not in k} for line in f])
    assert logs[0] == logs[1] and logs[0][-1]["current_steps"] == 2
    assert "pkd_loss" in logs[0][-1]
    assert sorted(os.listdir(tmp_path / "file")) == \
        sorted(os.listdir(tmp_path / "flags"))
