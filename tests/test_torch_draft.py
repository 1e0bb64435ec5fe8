"""The draft recipe of the port (``train/draft.py``) against the JAX
package, and the command lines that make and serve a draft, on the CPU
with one torch thread.

``draft_layer_ids``, ``slice_draft_params`` (on a latent tree, and on a
packed one before and after ``fuse_for_decode``) and ``latentize_params``
must equal JAX's exactly: they select and unpack, and compute nothing
else. ``distill_draft`` runs two KD steps. The command lines run
in-process: ``build-draft`` writes ``build_draft``'s slice, ``serve
--draft --n-draft 3`` prints what the engine with that draft gives, which
is the plain engine's greedy output, and ``serve --prefill-chunk``
without ``--paged`` prints the bucketed engine's.
"""

import io
import json

import jax
import numpy as np
import pytest
import torch

from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu.train import draft as jdraft
from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                              KDConfig, KDRunConfig, TrainConfig,
                              fuse_for_decode, load_native, params_from_jax,
                              save_native)
from onebit_tpu_torch.cli import main as port_main
from onebit_tpu_torch.kernels.bitlinear import BitLinearWeights
from onebit_tpu_torch.train import draft as tdraft


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def student():
    """A 4-layer tiny student, latent and packed, on both sides."""
    jc = JaxConfig.named("tiny", num_hidden_layers=4)
    latent = jb.init_params(jc, jax.random.PRNGKey(0), mode="latent")
    packed = jb.pack_model_params(latent)
    c = BitLlamaConfig.named("tiny", num_hidden_layers=4)
    conv = lambda t: params_from_jax(jax.tree.map(np.asarray, t), c,  # noqa
                                     device="cpu")
    return jc, latent, packed, c, conv(latent), conv(packed)


def _leaves(params):
    """The layers' tensors in a fixed order, by name and field."""
    out = {}
    for name, w in sorted(params["layers"].items()):
        if isinstance(w, tuple):
            for field, a in zip(w._fields, w):
                if a is not None:
                    out[f"{name}.{field}"] = a
        else:
            out[name] = w
    return out


def _same(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for key in g:
        assert torch.equal(g[key], w[key]), key


@pytest.mark.parametrize("n_total,n,strategy", [
    (32, 2, "spread"), (32, 2, "first"), (32, 4, "spread"), (4, 4, "first"),
    (8, 1, "spread"), (6, 4, "spread"), (3, 3, "spread"), (5, 2, "first")])
def test_draft_layer_ids_match_jax(n_total, n, strategy):
    assert tdraft.draft_layer_ids(n_total, n, strategy) == \
        jdraft.draft_layer_ids(n_total, n, strategy)


def test_draft_options_refused_as_in_jax(student):
    _, _, _, c, _, _ = student
    for call in (lambda m: m.draft_layer_ids(8, 2, "nope"),
                 lambda m: m.draft_config(c, 0),
                 lambda m: m.draft_config(c, 5)):
        with pytest.raises(ValueError) as want:
            call(jdraft)
        with pytest.raises(ValueError) as got:
            call(tdraft)
        assert str(got.value) == str(want.value)


def test_slice_and_latentize_match_jax(student):
    """Spread slices of the latent and the packed student (its layers 0
    and 3), the packed one also latentized, equal JAX's converted; the
    head is shared, not copied."""
    _, latent, packed, _, t_latent, t_packed = student
    for jtree, ttree in ((latent, t_latent), (packed, t_packed)):
        jd = jdraft.slice_draft_params(jtree, (0, 3))
        td = tdraft.slice_draft_params(ttree, (0, 3))
        _same(td, params_from_jax(jax.tree.map(np.asarray, jd),
                                  BitLlamaConfig.named("tiny",
                                                       num_hidden_layers=2),
                                  device="cpu"))
        assert td["embed_tokens"] is ttree["embed_tokens"]
        assert td["lm_head"] is ttree["lm_head"]
    jl = jdraft.latentize_params(jdraft.slice_draft_params(packed, (0, 3)))
    tl = tdraft.latentize_params(td)
    for name, w in tl["layers"].items():
        if isinstance(w, BitLinearWeights):
            assert w.packed is None
            np.testing.assert_array_equal(w.latent.numpy(),
                                          np.asarray(jl["layers"][name].latent))


def test_slice_commutes_with_fusion(student):
    """Slicing a tree fused for decode gives the fused slice: the CLI's
    order (load, fuse, slice) and the other one serve the same draft."""
    _, _, _, c, _, t_packed = student
    d_config, _ = tdraft.build_draft(t_packed, c, 2)
    _same(tdraft.slice_draft_params(fuse_for_decode(t_packed, c), (0, 3)),
          fuse_for_decode(tdraft.slice_draft_params(t_packed, (0, 3)),
                          d_config))


def test_distill_draft_two_steps(student, tmp_path):
    """Two logits-only KD steps of a 2-layer draft against the packed
    student; hidden-state losses are refused in JAX's words."""
    _, _, _, c, _, t_packed = student
    blocks = np.random.default_rng(0).integers(
        1, c.vocab_size, (4, 16)).astype(np.int64)
    d_config, state = tdraft.distill_draft(
        t_packed, c, blocks, num_layers=2,
        train_cfg=TrainConfig(warmup_steps=1),
        run_cfg=KDRunConfig(output_dir=str(tmp_path), batch_size=2,
                            max_steps=2, save_steps=100))
    assert d_config.num_hidden_layers == 2 and state.step == 2
    assert state.params["layers"]["q_proj"].latent.shape[0] == 2
    with pytest.raises(ValueError, match="logits-only"):
        tdraft.distill_draft(t_packed, c, blocks,
                             kd_cfg=KDConfig(kd_beta=1.0))


def _serve(monkeypatch, capsys, args, lines):
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    capsys.readouterr()
    port_main(["serve", *args, "--greedy", "--max-batch", "2", "--max-len",
               "64", "--max-new-tokens", "6", "--device", "cpu"])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    return [[int(t) for t in o["completion"].split(",")] for o in out]


def test_build_draft_and_serve_draft_cli(student, tmp_path, capsys,
                                         monkeypatch):
    """``build-draft --num-layers 1`` writes build_draft's slice; ``serve
    --draft --n-draft 3`` prints the in-process speculative engine's
    tokens, which are the plain engine's; ``serve --prefill-chunk 8``
    without pages prints the plain engine's too."""
    _, _, _, c, _, t_packed = student
    ckpt, out = str(tmp_path / "student"), str(tmp_path / "draft")
    save_native(ckpt, c, t_packed)
    port_main(["build-draft", ckpt, out, "--num-layers", "1", "--device",
               "cpu"])
    loaded = load_native(out, device="cpu")
    d_config, d_params = tdraft.build_draft(t_packed, c, 1)
    assert loaded["config"] == d_config
    _same(loaded["params"], d_params)
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [3]]
    lines = [",".join(map(str, p)) for p in prompts]
    got = _serve(monkeypatch, capsys, ["--ckpt", ckpt, "--draft", out,
                                       "--n-draft", "3"], lines)
    kw = dict(max_batch=2, max_len=64, device="cpu")
    eng = ContinuousBatchingEngine(t_packed, c, draft_params=d_params,
                                   draft_config=d_config, n_draft=3, **kw)
    uids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    res = eng.run()
    assert got == [res[u] for u in uids]
    eng = ContinuousBatchingEngine(t_packed, c, **kw)
    uids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    res = eng.run()
    assert got == [res[u] for u in uids]
    assert _serve(monkeypatch, capsys, ["--ckpt", ckpt, "--prefill-chunk",
                                        "8"], lines) == got
