"""BENCHMARK.json keeps the contract's shape, and every file it names loads
by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entries_have_the_contract_keys_and_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (spec.ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert "unit" not in entry or UNIT.match(entry["unit"])
        assert entry.get("better", "lower") in ("lower", "higher")
    names = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    assert "setup_s" in names


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_by_name_and_reports_its_metrics(cell):
    sp = spec.load(cell)
    e2e = {m["name"] for m in sp.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and sp.per_layer
    assert all(m["moves"] in e2e for m in sp.per_layer)
    assert sp.mix["loop"] in ("solve", "decide")
    assert set(sp.cell["limits"]) >= {"label_gap", "centroid_gap", "b1_calls_missing"}
    if sp.mix["loop"] == "decide":
        assert set(sp.cell["limits"]) >= {"init_excess", "median_gap", "category_gap"}
    for m in sp.end_to_end:
        assert callable(spec.reader("e2e", m["name"]).read)
    for m in sp.per_layer:
        assert spec.reader("metrics", m["name"]).LAYER == m["layer"]


def test_a_metrics_layer_name_is_spelled_one_way():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
