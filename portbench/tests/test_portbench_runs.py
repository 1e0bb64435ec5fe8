"""Whole runs of tiny cells on the CPU: the result line, what a run
imports, files found by name, and that the check fails under the control
and under each fault that a cell can have."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.tiny import tiny_bench, write

ROOT = Path(__file__).resolve().parents[2]
SEED = 3_000_000_017


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("bench"))


def run(bench, cell, capsys, *extra, trace=0, before=None):
    rc = harness.main(["--workload", cell, "--seed", str(SEED),
                       "--seconds", "1.0", "--trace", str(trace), *extra],
                      time.perf_counter(), bench=bench, require_cuda=False,
                      before=before)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    return json.loads(lines[-1]), lines, err


def test_result_line(bench, capsys):
    res, _, err = run(bench, "tiny.chat", capsys)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"output_tok_s", "ttft_p90_ms",
                                   "tpot_p90_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert err.strip().splitlines()[-1].startswith("check served_gap ")
    assert list(res["check"]) == ["served_gap"]


def test_no_gpu_no_result(bench, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "tiny.chat", "--seed", "1",
                       "--seconds", "1", "--trace", "0"],
                      time.perf_counter(), bench=bench)
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "onebit_tpu_torch_extra",
                        types.ModuleType("x"))
    assert "onebit_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "onebit_tpu.model",
                        types.ModuleType("y"))
    assert harness.forbidden_modules() == ["onebit_tpu.model"]


SCRIPT = """
import sys, time, json
sys.path.insert(0, {root!r})
from pathlib import Path
from portbench.tests.tiny import tiny_bench
from portbench import harness
b = tiny_bench(Path({tmp!r}))
rc = harness.main(["--workload", {cell!r}, "--seed", "5", "--seconds",
                   "2.0", "--trace", "1"], time.perf_counter(), bench=b,
                  require_cuda=False)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
sys.exit(rc)
"""


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.kd"])
def test_a_run_imports_neither_jax_nor_the_jax_package(cell, tmp_path):
    res = subprocess.run([sys.executable, "-c", SCRIPT.format(
        root=str(ROOT), tmp=str(tmp_path), cell=cell)],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "onebit_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "onebit_tpu"}


READER = '''LAYER = "engine"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "ttft_p90_ms"
WORKLOADS = ["tiny.chat"]


def read(ctx):
    import onebit_tpu  # noqa: F401
    return 1.0
'''


def test_a_reader_that_loads_the_jax_package_ends_the_run(tmp_path):
    """The check of loaded modules comes after the per-layer readers: a
    reader that imports (a stand-in for) the JAX package leaves no
    result."""
    stand_in = tmp_path / "stand_in" / "onebit_tpu"
    stand_in.mkdir(parents=True)
    (stand_in / "__init__.py").write_text("")
    script = SCRIPT.replace(
        "from portbench.tests.tiny import tiny_bench\n",
        "from portbench.tests.tiny import tiny_bench\n"
        "sys.path.insert(0, {stand_in!r})\n"
        "b0 = tiny_bench(Path({tmp!r}))\n"
        "(b0.root / 'metrics' / 'jax_reader.py').write_text({reader!r})\n"
    ).replace("b = tiny_bench(Path({tmp!r}))", "b = b0")
    res = subprocess.run([sys.executable, "-c", script.format(
        root=str(ROOT), tmp=str(tmp_path / "b"), cell="tiny.chat",
        stand_in=str(tmp_path / "stand_in"), reader=READER)],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 3, res.stderr[-3000:]
    assert "onebit_tpu" in res.stderr.strip().splitlines()[-1]
    assert '"correct"' not in res.stdout


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference,"
            " portbench.weights, portbench.roofline, portbench.traffic;"
            " print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "onebit_tpu" not in res.stdout and "jax" not in res.stdout


def test_new_files_are_found_without_an_edit(bench, capsys):
    root = bench.root
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "tiny.json").read_text())
    write(root, "configs", "tiny2", dict(cfg, num_hidden_layers=1))
    cell = json.loads((root / "workloads" / "tiny.chat.json").read_text())
    write(root, "workloads", "tiny2.chat", dict(cell, config="tiny2"))
    (root / "metrics" / "tiny_admits.py").write_text(
        'LAYER = "engine"\nUNIT = "ms"\nBETTER = "lower"\n'
        'SOURCE = "program_span"\nMOVES = "ttft_p90_ms"\n'
        'WORKLOADS = ["tiny2.chat"]\n\n\ndef read(ctx):\n'
        '    return 1e3 * ctx.counters["admit_s"]\n')
    assert "tiny2.chat" in bench.names("workloads")
    assert "tiny2" in bench.names("configs")
    assert list(bench.metrics_of("tiny2.chat")) == ["tiny_admits"]
    res, _, _ = run(bench, "tiny2.chat", capsys, trace=1)
    assert set(res["metrics"]) == {"tiny_admits"}
    assert res["metrics"]["tiny_admits"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_serving_control_fails_the_limit(bench, capsys):
    res, lines, _ = run(bench, "tiny.chat", capsys, "--control")
    notes = json.loads(lines[-2])["notes"]
    limit = res["check"]["served_gap"]["limit"]
    assert res["correct"] is False
    assert res["check"]["served_gap"]["value"] > limit
    assert notes["program_served_gap"] <= limit


def test_training_control_fails_a_limit(bench, capsys):
    res, lines, _ = run(bench, "tiny.kd", capsys, "--control")
    assert res["correct"] is False


def _alter_tokens(run):
    """A token altered where it is produced: the lm_head of the paged
    engine puts one id first."""
    from onebit_tpu_torch.engine import paged
    real = paged._lm_head

    def head(x, params, dtype):
        logits = real(x, params, dtype)
        logits[..., 7] += 1e4
        return logits
    run.undo.append((paged, "_lm_head", real))
    paged._lm_head = head


def _state_unchanged(run):
    """A step that returns its state unchanged: no AdamW update."""
    from onebit_tpu_torch.train import trainer
    real = trainer._adamw_update
    run.undo.append((trainer, "_adamw_update", real))
    trainer._adamw_update = lambda cfg, schedule, leaves, grads, opt, \
        norm=None: opt


def _half_batch(run):
    """Half of the batch left out, the mean taken over the rest."""
    from onebit_tpu_torch.train import trainer
    real = trainer._on
    run.undo.append((trainer, "_on", real))

    def on(batch, device):
        out = real(batch, device)
        return {k: v[:v.shape[0] // 2] for k, v in out.items()}
    trainer._on = on


@pytest.mark.parametrize("cell,fault", [
    ("tiny.chat", _alter_tokens), ("tiny.rag", _alter_tokens),
    ("tiny.kd", _state_unchanged), ("tiny.kd", _half_batch)])
def test_a_fault_makes_the_run_incorrect(bench, capsys, cell, fault):
    undo = []

    def before(r):
        r.undo = undo
        fault(r)
    try:
        res, _, _ = run(bench, cell, capsys, before=before)
    finally:
        for mod, attr, real in undo:
            setattr(mod, attr, real)
    assert res["correct"] is False
    clean, _, _ = run(bench, cell, capsys)
    assert clean["correct"] is True


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.rag", "tiny.kd"])
def test_tiny_cells_on_the_card(card, bench, capsys, cell):
    rc = harness.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                       "2", "--trace", "1"], time.perf_counter(),
                      bench=bench)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
