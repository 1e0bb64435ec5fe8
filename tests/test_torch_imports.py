"""The port stands alone: it imports no JAX and nothing of onebit_tpu, and
importing it builds or loads no kernel."""

import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "onebit_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))


def test_port_imports_without_jax():
    code = f"""
import sys
sys.modules["jax"] = None          # any 'import jax' now raises
import importlib
for name in {MODULES!r}:
    importlib.import_module(name)
assert not [m for m in sys.modules if m == "onebit_tpu"
            or m.startswith("onebit_tpu.")], "onebit_tpu was imported"
from onebit_tpu_torch.kernels import build
assert build._LIBS == {{}}, "a kernel was loaded at import"
print("ok", len({MODULES!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py",
                          ROOT / "tests" / "test_torch_cuda.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_line_names_jax_or_the_jax_package(path):
    bad = re.compile(r"onebit_tpu\.|^\s*(import|from)\s+jax\b")
    lines = [ln for ln in path.read_text().splitlines() if bad.search(ln)]
    assert not lines, lines


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """Here (no card) the script exits nonzero and prints no result; alone
    in a directory without the package it does too."""
    runs = [ROOT]
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(tmp_path)
    for cwd in runs:
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
