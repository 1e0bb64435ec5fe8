"""The port imports where the card runs it: every module of
``onebit_tpu_torch`` imports in a process where ``jax``, ``transformers``,
``datasets``, ``sklearn``, ``sacrebleu`` and ``zstandard`` cannot be
imported (the card's machine lacks some of them; each is imported only
where a call needs it). The task registry resolves every name there, and
nothing is built at import: no kernel, no decontamination core."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "onebit_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))
ABSENT = ("jax", "transformers", "datasets", "sklearn", "sacrebleu",
          "zstandard")


def test_port_imports_without_the_optional_packages():
    code = f"""
import sys
for name in {ABSENT!r}:
    sys.modules[name] = None       # any import of it now raises
import importlib
for name in {MODULES!r}:
    importlib.import_module(name)
from onebit_tpu_torch.eval.tasks.registry import ALL_TASKS, get_task_class
from onebit_tpu_torch.engine.server import EngineServer
from onebit_tpu_torch.kernels import build
from onebit_tpu_torch.tools.decontam import janitor
assert all(get_task_class(n).__name__ for n in ALL_TASKS)
assert build._LIBS == {{}} and janitor._CORE is None, "built at import"
print("ok", len({MODULES!r}), len(ALL_TASKS))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(MODULES)), "297"]
