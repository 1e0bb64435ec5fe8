"""Reference Hugging Face checkpoints in the port against the JAX package:
``load_reference_checkpoint`` on the three kinds (latent, int8-packed,
plain LLaMA) in ``pytorch_model.bin``, sharded bins and safetensors;
``export_reference_int8``; and the command lines that read or write them
(``convert --format reference``, ``eval``, ``generate``, and ``eval
--check-engines``).

The port's params must equal the JAX reader's after ``params_from_jax``
(packed words bit for bit), and their fp32 logits agree to 2e-4 (another
summation order in every matmul, as tests/test_torch_forward.py holds
``forward``). The export must write the JAX writer's tensors byte for byte,
and the command lines print what the JAX command lines print (perplexity
to 1e-5 relative, the bound of tests/test_torch_eval.py; tokens exactly).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.ckpt.hf_reader import load_reference_checkpoint as jload_ref
from onebit_tpu.ckpt.writer import export_reference_int8 as jexport
from onebit_tpu.ckpt.writer import save_native as jsave
from onebit_tpu.cli import main as jmain
from onebit_tpu.core.packing import pack_signs_int8_np
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch import (export_reference_int8, forward,
                              load_reference_checkpoint, params_from_jax)
from onebit_tpu_torch.ckpt.hf_reader import (detect_ckpt_kind,
                                             load_hf_state_dict)
from onebit_tpu_torch.cli import main as port_main
from onebit_tpu_torch.engine.beam import beam_generate
from onebit_tpu_torch.kernels.bitlinear import BitLinearWeights
from onebit_tpu_torch.kernels.linear import LinearWeights
from onebit_tpu_torch.model.config import BitLlamaConfig

TOL = dict(rtol=2e-4, atol=2e-4)
PARENT = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
          "o_proj": "self_attn", "gate_proj": "mlp", "up_proj": "mlp",
          "down_proj": "mlp"}


def _state_dict(config, kind):
    """A reference-layout state dict of random tensors, as
    tests/test_ckpt.py:34-72 makes it."""
    rng = np.random.default_rng(0)
    d, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    kv = config.num_key_value_heads * config.head_dim
    dims = {"q_proj": (d, d), "k_proj": (kv, d), "v_proj": (kv, d),
            "o_proj": (d, d), "gate_proj": (i, d), "up_proj": (i, d),
            "down_proj": (d, i)}
    sd = {"model.embed_tokens.weight": rng.standard_normal((v, d)),
          "lm_head.weight": rng.standard_normal((v, d)),
          "model.norm.weight": 1 + 0.1 * rng.standard_normal(d)}
    for li in range(config.num_hidden_layers):
        pre = f"model.layers.{li}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{pre}.{norm}.weight"] = 1 + 0.1 * rng.standard_normal(d)
        for name, (out, inp) in dims.items():
            key = f"{pre}.{PARENT[name]}.{name}"
            w = rng.standard_normal((out, inp))
            if kind == "llama":
                sd[f"{key}.weight"] = w * 0.05
                continue
            sd[f"{key}.weight_scale"] = np.abs(rng.standard_normal(out))
            sd[f"{key}.input_factor"] = np.abs(rng.standard_normal(inp))
            sd[f"{key}.weight"] = (pack_signs_int8_np(np.sign(w))
                                   if kind == "packed" else np.sign(w) * 0.01)
    return {k: a if a.dtype == np.int8 else a.astype(np.float32)
            for k, a in sd.items()}


def _write(path, config, sd, fmt):
    """``bin``: one pytorch_model.bin; ``sharded``: two bins and their
    index; ``safetensors``: model.safetensors."""
    os.makedirs(path, exist_ok=True)
    config.save_json(os.path.join(path, "config.json"))
    if fmt == "safetensors":
        from safetensors.numpy import save_file
        save_file(sd, os.path.join(path, "model.safetensors"))
        return
    tensors = {k: torch.from_numpy(a) for k, a in sd.items()}
    if fmt == "bin":
        torch.save(tensors, os.path.join(path, "pytorch_model.bin"))
        return
    keys = sorted(tensors)
    shards = {"pytorch_model-00001-of-00002.bin": keys[::2],
              "pytorch_model-00002-of-00002.bin": keys[1::2]}
    for name, part in shards.items():
        torch.save({k: tensors[k] for k in part}, os.path.join(path, name))
    with open(os.path.join(path, "pytorch_model.bin.index.json"), "w") as f:
        json.dump({"weight_map": {k: n for n, part in shards.items()
                                  for k in part}}, f)


def _same_params(got, want):
    """Every leaf of the port's params equal to ``want``'s (the JAX
    reader's, converted)."""
    for key in ("embed_tokens", "lm_head", "final_norm"):
        assert torch.equal(got[key], want[key]), key
    for name, w in want["layers"].items():
        g = got["layers"][name]
        assert type(g) is type(w), name
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w), name
            continue
        for field, a in w._asdict().items():
            b = getattr(g, field)
            assert (a is None) == (b is None), (name, field)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), (name, field)


@pytest.mark.parametrize("fmt", ["bin", "sharded", "safetensors"])
@pytest.mark.parametrize("kind", ["latent", "packed", "llama"])
def test_load_reference_matches_jax(tmp_path, kind, fmt):
    jc, c = JaxConfig.named("tiny"), BitLlamaConfig.named("tiny")
    sd = _state_dict(c, kind)
    _write(str(tmp_path), jc, sd, fmt)
    assert detect_ckpt_kind(load_hf_state_dict(str(tmp_path))) == kind
    want = jload_ref(str(tmp_path))
    got = load_reference_checkpoint(str(tmp_path), device="cpu")
    assert got["kind"] == want["kind"] == kind
    assert got["config"].to_dict() == want["config"].to_dict()
    _same_params(got["params"], params_from_jax(
        jax.tree.map(np.asarray, want["params"]), c, device="cpu"))
    proj = got["params"]["layers"]["q_proj"]
    assert isinstance(proj, LinearWeights if kind == "llama"
                      else BitLinearWeights)
    ids = np.arange(3, 19).reshape(2, 8)
    jlogits = jb.forward(want["params"], jnp.asarray(ids), want["config"],
                         compute_dtype=jnp.float32)
    logits = forward(got["params"], torch.from_numpy(ids), c,
                     compute_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """A tiny packed JAX model (and the port's params of it), its
    reference export by the JAX writer, and a token stream."""
    d = tmp_path_factory.mktemp("ref")
    jc = JaxConfig.named("tiny")
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(7)))
    jexport(str(d / "jax_ref"), jc, jp)
    np.save(d / "tokens.npy", np.random.default_rng(1).integers(
        0, jc.vocab_size, 5 * 32).astype(np.int32))
    c = BitLlamaConfig.named("tiny")
    return d, jc, jp, c, params_from_jax(jax.tree.map(np.asarray, jp), c,
                                         device="cpu")


def _same_safetensors(a, b):
    from safetensors.numpy import load_file
    ta, tb = load_file(a), load_file(b)
    assert sorted(ta) == sorted(tb)
    for k in tb:
        assert ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape, k
        assert ta[k].tobytes() == tb[k].tobytes(), k


def test_export_writes_the_jax_tensors(packed, tmp_path):
    """The port's export of the same packed model: the JAX writer's
    tensors byte for byte, and the JAX reader reads it back to the same
    params."""
    d, jc, jp, c, tp = packed
    export_reference_int8(str(tmp_path), c, tp)
    _same_safetensors(str(tmp_path / "model.safetensors"),
                      str(d / "jax_ref" / "model.safetensors"))
    assert json.load(open(tmp_path / "config.json")) == \
        json.load(open(d / "jax_ref" / "config.json"))
    back = jload_ref(str(tmp_path))
    assert back["kind"] == "packed"
    _same_params(load_reference_checkpoint(str(tmp_path), device="cpu")[
        "params"], params_from_jax(jax.tree.map(np.asarray, back["params"]),
                                   c, device="cpu"))
    for name in ("q_proj", "down_proj"):
        np.testing.assert_array_equal(
            np.asarray(back["params"]["layers"][name].packed),
            np.asarray(jp["layers"][name].packed))


def _port_cli(capsys, *args):
    """The port's command line, run in this process; returns what it
    printed."""
    capsys.readouterr()
    port_main([*args, "--device", "cpu"])
    return capsys.readouterr().out


def test_cli_convert_reference(packed, tmp_path, capsys):
    """``convert --format reference`` on a latent native checkpoint writes
    what the JAX command writes, byte for byte."""
    _, jc, _, _, _ = packed
    jsave(str(tmp_path / "latent"), jc,
          jb.init_params(jc, jax.random.PRNGKey(8)))
    _port_cli(capsys, "convert", str(tmp_path / "latent"),
              str(tmp_path / "a"), "--format", "reference")
    jmain(["convert", str(tmp_path / "latent"), str(tmp_path / "b"),
           "--format", "reference"])
    capsys.readouterr()
    _same_safetensors(str(tmp_path / "a" / "model.safetensors"),
                      str(tmp_path / "b" / "model.safetensors"))


def test_cli_eval_and_generate_from_a_reference_dir(packed, capsys):
    """``eval`` and ``generate`` read the JAX writer's reference export and
    print what the JAX command lines print on it."""
    d, _, _, _, _ = packed
    ref, tokens = str(d / "jax_ref"), str(d / "tokens.npy")
    ev = ["eval", "--ckpt", ref, "--tokens", tokens, "--seqlen", "32",
          "--batch-size", "2"]
    jmain(ev)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = json.loads(_port_cli(capsys, *ev).strip().splitlines()[-1])
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)

    gen = ["generate", "--ckpt", ref, "--prompt", "1,2,3,40,7",
           "--greedy", "--max-new-tokens", "6"]
    jmain(gen)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert _port_cli(capsys, *gen).strip().splitlines()[-1] == want
    assert len(want.split(",")) >= 1


def test_cli_check_engines(packed, tmp_path, capsys):
    """``eval --check-engines dense,kvq,int4,paged`` on a packed reference
    checkpoint: every engine agrees with ``generate`` and a pinned
    ``engine_check.ok`` of 1 passes."""
    d, _, _, _, _ = packed
    ref = str(d / "jax_ref")
    spec = tmp_path / "expect.json"
    spec.write_text(json.dumps({"engine_check.ok": {"value": 1.0,
                                                    "atol": 0.0}}))
    out = _port_cli(capsys, "eval", "--ckpt", ref, "--check-engines",
                    "dense,kvq,int4,paged", "--expect", str(spec))
    for name in ("dense", "kvq", "int4", "paged"):
        assert f"engine check [{name}]: OK" in out
    result = json.loads([ln for ln in out.splitlines()
                         if ln.startswith("{")][-1])
    assert result["engine_check"]["ok"] == 1.0
    assert "engine_check.ok: got 1.0000" in out and "PASS" in out
    out = _port_cli(capsys, "eval", "--ckpt", ref, "--check-engines",
                    "dense,pipelined")
    assert "engine check [pipelined]: OK" in out
    # beam search is ported: --num-beams prints beam_generate's best beam
    got = _port_cli(capsys, "generate", "--ckpt", ref, "--prompt", "1,2",
                    "--num-beams", "2", "--max-new-tokens", "4")
    loaded = load_reference_checkpoint(ref, device="cpu")
    want = beam_generate(loaded["params"], loaded["config"], [[1, 2]],
                         num_beams=2, max_new_tokens=4)[0][0][0]
    assert got.strip().splitlines()[-1] == ",".join(map(str, want))


def test_cli_sharded_checkpoint_exits_nonzero(tmp_path, capsys):
    """The JAX package's sharded checkpoint (``metadata.json`` of format
    onebit-sharded, an orbax tree) does not load in the port: every
    command exits nonzero naming why, before it reads anything else (the
    port's own sharded format is ``onebit-sharded-torch``)."""
    (tmp_path / "metadata.json").write_text(json.dumps(
        {"format": "onebit-sharded"}))
    with pytest.raises(SystemExit, match="orbax"):
        _port_cli(capsys, "generate", "--ckpt", str(tmp_path), "--prompt",
                  "1")
