"""``BENCHMARK.json`` and the benchmark's own files agree: every cell,
configuration, mix and per-layer metric it names has its file, with the
same fields."""

import json
from pathlib import Path

from portbench.harness import UNITS, Bench

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = Bench()


def test_cells_name_their_files():
    for w in SPEC["workloads"]:
        cell = BENCH.cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"],
                cell["why"]) == (w["config"], w["traffic"], w["chips"],
                                 w["why"])
        BENCH.mix(cell["traffic"])
        for metric in cell["end_to_end"]:
            assert metric in UNITS
            spec = next(m for m in SPEC["end_to_end"]
                        if m["name"] == metric)
            assert w["name"] in spec.get("workloads", [w["name"]])
            assert spec["unit"] == UNITS[metric]


def test_configs_name_their_files():
    for c in SPEC["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = BENCH.config(c["name"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_per_layer_metrics_match_their_readers():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        mod = BENCH.metric(m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == \
            (m["unit"], m["better"], m["source"], m["layer"], m["moves"])
        assert m["workloads"] == [c for c in mod.WORKLOADS if c in cells]
        for cell in m["workloads"]:
            assert m["moves"] in BENCH.cell(cell)["end_to_end"]
