"""One run of one cell: ``run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.

Everything is found by name in files of its own under the benchmark's
folder: ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``), its
engine or recipe options, its end-to-end metrics and the limits of its
check; each per-layer metric is a reader ``metrics/<name>.py`` that lists
the cells it reads in. A new configuration, mix, cell or metric is a new
file.

The last line on standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end ones, or with
``--trace 1`` the per-layer ones), ``device`` and, traced, ``breakdown``;
its last key ``check`` gives each number compared beside its limit, as do
the last lines on standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "onebit_tpu")
UNITS = {"output_tok_s": "tokens/s", "ttft_p90_ms": "ms",
         "tpot_p90_ms": "ms", "train_tok_s": "tokens/s", "setup_s": "s"}


class Bench:
    """The benchmark's files under ``root``, found by name."""

    def __init__(self, root: Path = BENCH_DIR):
        self.root = Path(root)

    def _json(self, kind: str, name: str) -> Dict:
        path = self.root / kind / f"{name}.json"
        if not path.is_file():
            raise SystemExit(f"no {kind[:-1]} named {name!r} ({path})")
        return json.loads(path.read_text())

    def names(self, kind: str) -> List[str]:
        suffix = ".py" if kind == "metrics" else ".json"
        return sorted(p.name[:-len(suffix)]
                      for p in (self.root / kind).glob(f"*{suffix}"))

    def cell(self, name: str) -> Dict:
        cell = self._json("workloads", name)
        cell["name"] = name
        return cell

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def mix(self, name: str) -> Dict:
        return self._json("traffic", name)

    def metric(self, name: str):
        path = self.root / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics_of(self, cell: str) -> Dict[str, object]:
        """The per-layer metrics whose readers list ``cell``."""
        out = {}
        for name in self.names("metrics"):
            mod = self.metric(name)
            if cell in mod.WORKLOADS:
                out[name] = mod
        return out


class Outcome:
    """What ``serve.run`` or ``train.run`` hands back."""

    def __init__(self):
        self.setup_s = 0.0
        self.e2e: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.counters: Dict = {}
        self.profile: Optional[Dict] = None
        self.peak_bytes = 0
        self.check: Dict[str, float] = {}
        self.notes: Dict = {}


class Run:
    """One run's cell, arguments and device, with the few device calls that
    ``serve`` and ``train`` share."""

    def __init__(self, bench: Bench, args, device, t_start: float):
        import torch
        self.torch = torch
        self.cell = bench.cell(args.workload)
        self.cfg = bench.config(self.cell["config"])
        self.mix = bench.mix(self.cell["traffic"])
        self.seed, self.seconds = args.seed, args.seconds
        self.trace, self.control = bool(args.trace), args.control
        self.device = device
        self.t_start = t_start
        self.marks: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        """Seconds since the process started, at a named point."""
        self.marks[name] = time.perf_counter() - self.t_start

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        self.sync()
        return int(self.torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


class Context:
    """What a per-layer reader reads: the cell, its configuration, the
    harness's counters and spans, and the profiled window's summary."""

    def __init__(self, cell, cfg, counters, profile):
        self.cell, self.cfg = cell, cfg
        self.counters, self.profile = counters, profile


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="judge the fp8 control in the program's place "
                        "(limits' readings; not part of a benchmark run)")
    return p.parse_args(argv)


def _smi() -> Optional[str]:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv, t_start: float, bench: Bench = None,
         require_cuda: bool = True, before=None) -> int:
    """A run; ``require_cuda=False`` (tests) runs on the CPU at whatever
    size the cell's files give, and ``before(run)`` may patch the program
    first."""
    args = parse(argv)
    bench = bench or Bench()
    import torch
    torch.set_num_threads(1)
    cell = bench.cell(args.workload)
    if require_cuda:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"available: {torch.cuda.is_available()}, count "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    else:
        device = torch.device("cpu")
    run = Run(bench, args, device, t_start)
    if device.type == "cuda":
        from onebit_tpu_torch.kernels import build
        built = build.build()
        run.mark("build")
        _emit({"build_s": built, "smi": _smi(),
               "torch": torch.__version__, "cuda": torch.version.cuda})
    if before is not None:
        before(run)
    kind = run.mix["kind"]
    out = Outcome()
    if kind == "serve":
        from portbench import serve as cell_run
    elif kind == "train":
        from portbench import train as cell_run
    else:
        raise SystemExit(f"unknown traffic kind {kind!r}")
    cell_run.run(run, out)

    limits = cell.get("check", {}).get("limits", {})
    check = {k: {"value": v, "limit": limits.get(k)}
             for k, v in out.check.items()}
    correct = (bool(check) and out.failed == 0 and all(
        c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in check.values()))
    if args.trace:
        ctx = Context(cell, run.cfg, out.counters, out.profile)
        metrics = {}
        for name, mod in bench.metrics_of(args.workload).items():
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    elif args.control:
        metrics = {}
    else:
        values = dict(out.e2e, setup_s=out.setup_s)
        metrics = {k: {"value": values[k], "unit": UNITS[k]}
                   for k in cell["end_to_end"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": out.peak_bytes}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics,
              "device": device_info}
    if args.trace and out.profile is not None:
        device_info["busy_s"] = out.profile["busy_s"]
        device_info["window_s"] = out.profile["window_s"]
        result["breakdown"] = out.profile["breakdown"]
        _emit({"idle_by_span_s": out.profile["idle_by_span_s"]})
    _emit({"marks_s": run.marks, "notes": out.notes})
    result["check"] = check
    # after every per-layer reader has been loaded and read
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for name, c in check.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    _emit(result)
    return 0
