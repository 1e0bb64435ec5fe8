"""Training/eval observability: structured jsonl logs + loss plots.

A copy of ``onebit_tpu/utils/logging.py``, which imports no framework; the
port keeps its own copy so that it imports nothing of the JAX package.

Parity with the reference's observability (SURVEY.md §5):
* ``TrainerLog`` → ``trainer_log.jsonl`` with per-log-step
  {current_steps, total_steps, loss, learning_rate, epoch, percentage,
  elapsed_time, remaining_time} (reference llamafactory/extras.py:162-190);
* ``plot_loss`` → PNG with EMA smoothing (reference extras.py:864-901);
* ``get_logger`` console logger (reference extras.py:42-85).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, List, Optional


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s - %(levelname)s - %(name)s - %(message)s",
            datefmt="%m/%d/%Y %H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def _fmt_secs(s: float) -> str:
    m, s = divmod(int(s), 60)
    h, m = divmod(m, 60)
    return f"{h}:{m:02d}:{s:02d}"


class TrainerLog:
    """Appends one JSON line per log step (reference trainer_log.jsonl)."""

    def __init__(self, output_dir: str, total_steps: int):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "trainer_log.jsonl")
        self.total_steps = total_steps
        self.start = time.time()
        self.history: List[Dict] = []

    def log(self, step: int, metrics: Dict[str, float],
            epoch: Optional[float] = None) -> Dict:
        elapsed = time.time() - self.start
        rate = elapsed / max(step, 1)
        entry = {
            "current_steps": step,
            "total_steps": self.total_steps,
            "loss": float(metrics.get("loss", float("nan"))),
            "learning_rate": float(metrics.get("learning_rate", 0.0)),
            "epoch": float(epoch) if epoch is not None else None,
            "percentage": round(step / max(self.total_steps, 1) * 100, 2),
            "elapsed_time": _fmt_secs(elapsed),
            "remaining_time": _fmt_secs(rate * (self.total_steps - step)),
        }
        for k, v in metrics.items():
            if k not in ("loss", "learning_rate"):
                entry[k] = float(v)
        self.history.append(entry)
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        return entry


def plot_loss(output_dir: str, keys: Optional[List[str]] = None) -> List[str]:
    """EMA-smoothed loss curves from trainer_log.jsonl → PNGs.

    Reference plot_loss (extras.py:864-901): scatter raw + line smoothed,
    EMA factor 0.9.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = keys or ["loss"]
    path = os.path.join(output_dir, "trainer_log.jsonl")
    with open(path) as f:
        entries = [json.loads(line) for line in f]
    written = []
    for key in keys:
        xs = [e["current_steps"] for e in entries if key in e
              and e[key] is not None]
        ys = [e[key] for e in entries if key in e and e[key] is not None]
        if not xs:
            continue
        smoothed, last = [], ys[0]
        for y in ys:
            last = 0.9 * last + 0.1 * y
            smoothed.append(last)
        plt.figure()
        plt.scatter(xs, ys, alpha=0.4, label="original")
        plt.plot(xs, smoothed, label="smoothed")
        plt.title(f"training {key}")
        plt.xlabel("step")
        plt.ylabel(key)
        plt.legend()
        out = os.path.join(output_dir, f"training_{key}.png")
        plt.savefig(out, dpi=100)
        plt.close()
        written.append(out)
    return written
