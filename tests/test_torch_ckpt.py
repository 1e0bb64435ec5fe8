"""Native checkpoints and the ``eval`` command line of the port against the
JAX package: a checkpoint the JAX writer made loads through the port and
evaluates to the JAX command line's perplexity (1e-5 relative, the bound of
tests/test_torch_eval.py), and the port's writer gives the JAX writer's
arrays byte for byte."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from onebit_tpu.ckpt.writer import load_native as jload
from onebit_tpu.ckpt.writer import save_native as jsave
from onebit_tpu.cli import main as jmain
from onebit_tpu.core.packing import pack_signs_device
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch import (load_native, params_from_jax, perplexity,
                              save_native)
from onebit_tpu_torch.core.packing import (device_to_kmajor, kmajor_to_device,
                                           unpack_signs_device,
                                           unpack_signs_kmajor)
from onebit_tpu_torch.model.config import BitLlamaConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A packed fp32 JAX checkpoint, a token stream, and the JAX command
    line's perplexity of it."""
    d = tmp_path_factory.mktemp("ckpt")
    jc = JaxConfig.named("tiny")
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(11)))
    jsave(str(d / "native"), jc, jp)
    tokens = np.random.default_rng(0).integers(0, jc.vocab_size, 5 * 32
                                               ).astype(np.int32)
    np.save(d / "tokens.npy", tokens)
    return d, jc, jp


def _jax_cli_ppl(d, capsys):
    jmain(["eval", "--ckpt", str(d / "native"), "--tokens",
           str(d / "tokens.npy"), "--seqlen", "32", "--batch-size", "2"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ppl"]


def _port_cli(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "onebit_tpu_torch", *args],
                          cwd=ROOT, capture_output=True, text=True, env=env,
                          timeout=300)


def test_load_native_reads_the_jax_writer(jax_ckpt, capsys):
    d, jc, jp = jax_ckpt
    loaded = load_native(str(d / "native"), device="cpu")
    assert loaded["config"].to_dict() == jc.to_dict()
    params = loaded["params"]
    for name in ("q_proj", "down_proj"):
        np.testing.assert_array_equal(
            unpack_signs_kmajor(params["layers"][name].packed,
                                torch.float32).numpy(),
            unpack_signs_device(torch.from_numpy(np.array(
                jp["layers"][name].packed)), torch.float32).numpy())
    got = perplexity(params, loaded["config"], np.load(d / "tokens.npy"),
                     seqlen=32, batch_size=2)
    np.testing.assert_allclose(got, _jax_cli_ppl(d, capsys), rtol=1e-5)


def test_save_native_writes_the_jax_arrays(jax_ckpt, tmp_path):
    """The port's writer on the port's params of the same fp32 checkpoint:
    every array of params.npz equal to the JAX writer's, byte for byte;
    and the JAX reader loads it."""
    d, jc, jp = jax_ckpt
    c = BitLlamaConfig.named("tiny")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), c, device="cpu")
    save_native(str(tmp_path), c, tp)
    with np.load(d / "native" / "params.npz") as want, \
            np.load(tmp_path / "params.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].tobytes() == want[key].tobytes(), key
    assert json.load(open(tmp_path / "config.json")) == \
        json.load(open(d / "native" / "config.json"))
    back = jload(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(back["params"]["layers"][
        "k_proj"].packed), np.asarray(jp["layers"]["k_proj"].packed))


def test_native_roundtrip_bf16_and_teacher(tmp_path):
    """bf16 leaves are written as the raw 2-byte records of the JAX writer
    and read back as bf16 with the same bits, both ways; a plain
    LinearWeights (teacher) checkpoint round-trips; so does a latent
    (training) checkpoint, byte for byte."""
    from onebit_tpu_torch import host_random_packed_params
    c = BitLlamaConfig.named("tiny")
    tp = host_random_packed_params(c, seed=2, device="cpu")
    save_native(str(tmp_path / "packed"), c, tp)
    back = load_native(str(tmp_path / "packed"), device="cpu")["params"]
    assert back["embed_tokens"].dtype == torch.bfloat16
    assert torch.equal(back["embed_tokens"], tp["embed_tokens"])
    assert torch.equal(back["layers"]["up_proj"].input_factor,
                       tp["layers"]["up_proj"].input_factor)
    assert torch.equal(back["layers"]["up_proj"].packed,
                       tp["layers"]["up_proj"].packed)

    # a bf16 JAX checkpoint: numpy keeps its bf16 arrays as raw 2-byte
    # records, which load as bf16 with the same bits; the port writes the
    # same records, so the JAX reader gets bf16 back
    from onebit_tpu.utils.randinit import host_random_packed_params as jrand
    jc = JaxConfig.named("tiny")
    jp = jrand(jc, seed=2)
    jsave(str(tmp_path / "jax_bf16"), jc, jp)
    back = load_native(str(tmp_path / "jax_bf16"), device="cpu")["params"]
    assert back["lm_head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["lm_head"].view(torch.int16).numpy(),
                                  np.asarray(jp["lm_head"]).view(np.int16))
    assert torch.equal(back["layers"]["gate_proj"].packed,
                       tp["layers"]["gate_proj"].packed)
    # written back: the JAX writer's bytes, but for the weight scales, which
    # the port holds in fp32 (as the kernels read them) with the same values
    save_native(str(tmp_path / "port_bf16"), c, back)
    with np.load(tmp_path / "jax_bf16" / "params.npz") as want, \
            np.load(tmp_path / "port_bf16" / "params.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            if key.endswith(".weight_scale"):
                assert got[key].dtype == np.float32, key
                np.testing.assert_array_equal(
                    got[key], (want[key].view(np.uint16).astype(np.uint32)
                               << 16).view(np.float32))
                continue
            assert got[key].dtype == want[key].dtype, key
            assert got[key].tobytes() == want[key].tobytes(), key

    for mode in ("linear", "latent"):
        jp = jb.init_params(jc, jax.random.PRNGKey(1), mode=mode)
        jsave(str(tmp_path / mode), jc, jp)
    teacher = load_native(str(tmp_path / "linear"), device="cpu")["params"]
    np.testing.assert_array_equal(
        teacher["layers"]["o_proj"].weight.numpy(),
        np.asarray(jax.device_get(
            jload(str(tmp_path / "linear"))["params"]["layers"][
                "o_proj"].weight)))
    save_native(str(tmp_path / "linear2"), c, teacher)
    with np.load(tmp_path / "linear" / "params.npz") as a, \
            np.load(tmp_path / "linear2" / "params.npz") as b:
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)
    latent = load_native(str(tmp_path / "latent"), device="cpu")["params"]
    assert latent["layers"]["q_proj"].mode == "latent"
    save_native(str(tmp_path / "latent2"), c, latent)
    with np.load(tmp_path / "latent" / "params.npz") as a, \
            np.load(tmp_path / "latent2" / "params.npz") as b:
        assert a.files == b.files
        assert all(a[k].dtype == b[k].dtype and a[k].tobytes() ==
                   b[k].tobytes() for k in a.files)


def test_kmajor_to_device_inverts_device_to_kmajor():
    rng = np.random.default_rng(0)
    words = rng.integers(-2 ** 31, 2 ** 31 - 1, (2, 8, 96),
                         dtype=np.int64).astype(np.int32)
    t = torch.from_numpy(words)
    km = torch.stack([device_to_kmajor(w) for w in t])
    assert torch.equal(kmajor_to_device(km), t)
    dense = rng.standard_normal((40, 256)).astype(np.float32)
    np.testing.assert_array_equal(
        kmajor_to_device(device_to_kmajor(torch.from_numpy(np.array(
            pack_signs_device(dense))))).numpy(),
        np.asarray(pack_signs_device(dense)))


def test_cli_eval_matches_the_jax_cli(jax_ckpt, capsys, tmp_path):
    """``python -m onebit_tpu_torch eval --device cpu`` prints the JAX
    command line's ppl; ``--expect`` passes on it and fails 0.1 off."""
    d, _, _ = jax_ckpt
    want = _jax_cli_ppl(d, capsys)
    args = ["eval", "--ckpt", str(d / "native"), "--tokens",
            str(d / "tokens.npy"), "--seqlen", "32", "--batch-size", "2",
            "--device", "cpu"]
    out = _port_cli(*args)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[0])["ppl"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for off, rc in ((0.0, 0), (0.1 + 2 * 1e-5 * want, 1)):
        spec = tmp_path / f"expect{rc}.json"
        spec.write_text(json.dumps({"_note": "pinned", "ppl": {
            "value": got + off, "atol": 0.1}}))
        run = _port_cli(*args, "--expect", str(spec))
        assert run.returncode == rc, run.stdout + run.stderr
        assert ("PASS" if rc == 0 else "FAIL") in run.stdout


@pytest.mark.parametrize("flag", [["--corpus", "wikitext2"],
                                  ["--wikitext", "pages.txt"],
                                  ["--tasks", "piqa"], ["--tokenizer", "t"],
                                  ["--check-engines"],
                                  ["--decontaminate", "train.txt"]])
def test_cli_unported_flags_exit_nonzero(jax_ckpt, flag):
    """Flags not ported yet exit nonzero, saying so. The bare
    ``--check-engines`` (all five engines, pipelined blocks among them) is
    ported: it runs every engine check beside the ppl."""
    d, _, _ = jax_ckpt
    out = _port_cli("eval", "--ckpt", str(d / "native"), "--tokens",
                    str(d / "tokens.npy"), "--device", "cpu", *flag,
                    *(["--seqlen", "32"] if flag == ["--check-engines"]
                      else []))
    if flag == ["--check-engines"]:
        assert out.returncode == 0, out.stderr
        for name in ("dense", "pipelined", "kvq", "int4", "paged"):
            assert f"engine check [{name}]: OK" in out.stdout
        return
    assert out.returncode != 0
    assert "not ported yet" in out.stderr


def test_cli_fails_a_pinned_engine_check(jax_ckpt, tmp_path, capsys):
    """The engine gate is opt-in, as in the JAX command line: without
    --check-engines a pinned engine_check.* is SKIPPED and the plain ppl
    run passes, as the JAX command's does; with it the gate is checked
    (tests/test_torch_hf_ckpt.py)."""
    d, _, _ = jax_ckpt
    spec = tmp_path / "expect.json"
    spec.write_text(json.dumps({"engine_check.ok": {"value": 1.0,
                                                    "atol": 0.0}}))
    args = ["eval", "--ckpt", str(d / "native"), "--tokens",
            str(d / "tokens.npy"), "--seqlen", "32", "--expect", str(spec)]
    jmain(args)
    assert "engine_check.ok: SKIPPED" in capsys.readouterr().out
    out = _port_cli(*args, "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "engine_check.ok: SKIPPED" in out.stdout
