"""Memory plans of the port (``parallel/memplan.py``) against the JAX
package's hand model and the assertions of its ``tests/test_memplan.py``,
restated for 80 GiB cards: the fully sharded 7B KD step at (8, 1) fits a
card and lies within JAX's 0.7-1.3 band of the hand model; a rank of a
(data, model) mesh is planned over its two fake groups; a 13B
tensor-parallel decode rank at TP 8 stays under 4 GiB; overflow raises with
its accounting; both ``--dry-compile`` command lines run. The dry runs
count the kernel path: a plain attention or BitLinear called on fake
tensors fails these tests.
"""

import json

import pytest
import torch

from onebit_tpu_torch.kernels import attention as tattn
from onebit_tpu_torch.kernels import bitlinear_cuda as tbc
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.parallel import memplan
from onebit_tpu_torch.parallel.mesh import DataGroup, Mesh2D, TPGroup
from onebit_tpu_torch.parallel.sharding import mesh_layout, shard_params
from onebit_tpu_torch.train.trainer import TrainConfig, init_train_state


@pytest.fixture
def kernel_path_only(monkeypatch):
    """The plain versions of B11 and of K1-K3 raise: a dry run must take
    the kernels' fake outputs."""
    def refuse(*a, **k):
        raise AssertionError("a dry run took a plain version")
    monkeypatch.setattr(tattn, "flash_causal_attention_torch", refuse)
    for name in ("small_m_torch", "fused_small_m_torch", "large_m_torch"):
        monkeypatch.setattr(tbc, name, refuse)


@pytest.mark.parametrize("mesh", [(8, 1), (4, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("name", ["llama2-7b", "llama2-13b"])
def test_analytic_train_bytes_equals_jax(name, mesh):
    """The hand model is JAX's arithmetic on the same shapes: the same
    bytes on each mesh, batch 8 x 2048."""
    from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
    from onebit_tpu.parallel.memplan import analytic_train_bytes as jax_bytes
    got = memplan.analytic_train_bytes(BitLlamaConfig.named(name), mesh,
                                       8, 2048)
    assert got == jax_bytes(JaxConfig.named(name), mesh, 8, 2048)


def test_7b_sharded_kd_step_fits_a_card(kernel_path_only):
    """One rank's 7B KD step on (8, 1) with remat, global batch 8 x 2048:
    fits 80 GiB, and its peak lies within JAX's band of the hand model
    (the fp32 latents, moments and bf16 teacher split 8 ways, 10.77 GiB,
    plus one layer half's recomputation and the gradient shards)."""
    config = BitLlamaConfig.named("llama2-7b")
    report = memplan.dry_run_train(config, (8, 1), 8, 2048,
                                   train_cfg=TrainConfig(remat=True))
    report.check(80.0)
    model = memplan.analytic_train_bytes(config, (8, 1), 8, 2048)
    assert 10.0 < report.argument_bytes / 2 ** 30 < 11.5, report
    assert 0.7 < report.peak_bytes / model < 1.3, (report.peak_bytes, model)


def test_overflow_raises_with_accounting(kernel_path_only):
    """On (1, 1) a budget the step passes raises ``MemoryError`` naming the
    peak, the budget and the resident and transient parts."""
    report = memplan.dry_run_train(BitLlamaConfig.named("tiny"), (1, 1), 8,
                                   64)
    with pytest.raises(MemoryError, match=r"exceeds the 1e-06 GiB budget "
                       r"\(resident inputs .* \+ transient .* GiB"):
        report.check(1e-6)
    assert report.temp_bytes > 0 and report.argument_bytes > 0


def test_model_axis_plan(kernel_path_only):
    """A rank of (2, 2) is planned over its two fake groups: its resident
    inputs are a quarter of one device's and more (the vectors and norms
    stay whole), and its peak is below one device's."""
    config = BitLlamaConfig.named("tiny")
    report = memplan.dry_run_train(config, (2, 2), 8, 64)
    one = memplan.dry_run_train(config, (1, 1), 8, 64)
    assert isinstance(report, memplan.MemReport)
    assert report.label == "train (2, 2) B=8 S=64"
    assert one.argument_bytes / 4 < report.argument_bytes \
        < one.argument_bytes / 3
    assert 0 < report.peak_bytes < one.peak_bytes


def test_13b_tp8_serving_fits_easily(kernel_path_only):
    """A TP 8 rank of 13B packed serving, 8 rows of 2048, dense cache:
    under 4 GiB (JAX's bound); the paged pool of the same rows too."""
    config = BitLlamaConfig.named("llama2-13b")
    report = memplan.dry_run_serve(config, 8, max_batch=8, max_len=2048)
    report.check(4.0)
    assert report.peak_gb < 4.0, report
    paged = memplan.dry_run_serve(BitLlamaConfig.named("tiny"), 2,
                                  max_batch=4, max_len=64, paged=True)
    assert paged.peak_bytes > 0


def test_moments_are_sharded():
    """The regression the plans exist to catch: each split leaf's AdamW
    moments have the rank's shard's shape, not the leaf's."""
    from onebit_tpu_torch.model.bitllama import init_params
    config = BitLlamaConfig.named("tiny")
    full = init_params(config, mode="latent", device="cpu")
    cpu = torch.device("cpu")
    mesh = Mesh2D((4, 1), 1, DataGroup(None, 1, 4, cpu),
                  TPGroup(None, 0, 1, cpu), cpu)
    layout = mesh_layout(full, config, mesh.shape)
    state = init_train_state(shard_params(full, mesh, layout),
                             TrainConfig())
    latent = state.params["layers"]["q_proj"].latent
    assert latent.shape[1] * 4 == full["layers"]["q_proj"].latent.shape[1]
    shaped = [m for m in state.opt_state.mu if m.shape == latent.shape]
    assert shaped and not any(
        m.shape == full["layers"]["q_proj"].latent.shape
        for m in state.opt_state.mu)


def test_cli_dry_compile(tmp_path, capsys, kernel_path_only):
    """``train --dry-compile`` and ``serve --dry-compile`` on a config.json
    print their reports and the budget line; past the budget they exit
    nonzero with the accounting."""
    from onebit_tpu_torch import cli
    with open(tmp_path / "config.json", "w") as f:
        json.dump(BitLlamaConfig.named("tiny").to_dict(), f)
    d = str(tmp_path)
    cli.main(["train", "--dry-compile", "--student", d, "--mesh", "2x1",
              "--batch-size", "8", "--cutoff-len", "64", "--hbm-gb", "16"])
    cli.main(["serve", "--dry-compile", "--ckpt", d, "--tp", "2",
              "--max-batch", "4", "--max-len", "64", "--hbm-gb", "16"])
    out = capsys.readouterr().out
    assert "train (2, 1) B=8 S=64" in out and "serve tp=2 dense" in out
    assert out.count("fits the 16 GiB/card budget") == 2
    with pytest.raises(SystemExit, match="exceeds the 1e-06 GiB budget"):
        cli.main(["train", "--dry-compile", "--student", d, "--mesh", "1x1",
                  "--batch-size", "2", "--cutoff-len", "64", "--hbm-gb",
                  "1e-6"])
