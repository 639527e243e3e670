"""A configuration, a mix, a cell and a per-layer metric are added as new
files and new BENCHMARK.json entries, without editing a file the benchmark
has, and the new cell runs."""

from __future__ import annotations

import hashlib
import json
import shutil
import time

import pytest

torch = pytest.importorskip("torch")

from portbench import run, spec  # noqa: E402
from portbench.readers import Context  # noqa: E402
from portbench.system import Program  # noqa: E402
from portbench.traffic import Window  # noqa: E402


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_make_a_new_cell(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    before = _digest(tmp_path / "portbench")
    pkg = tmp_path / "portbench"
    cfg = json.loads((pkg / "configs" / "config2-1m-d32-k128.json").read_text())
    cfg.update(name="toy-skew", n=8_192, d=8, k=12, blobs=4, lloyd_iters=3)
    (pkg / "configs" / "toy-skew.json").write_text(json.dumps(cfg))
    (pkg / "mixes" / "lloyd-short.json").write_text(json.dumps(
        {"loop": "solve", "init": "rows", "iters": 2, "pool": 2}))
    (pkg / "cells" / "toy-skew.lloyd.json").write_text(json.dumps(
        {"samples": 1, "limits": {"label_gap": 1e-4, "centroid_gap": 1e-5,
                                  "b1_calls_missing": 0.0}}))
    (pkg / "metrics" / "solves.py").write_text(
        'LAYER = "ops/kmeans"\n\n\ndef read(ctx):\n    return float(len(ctx.window.units))\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-skew", "source": "https://example.org/toy",
                             "file": "portbench/configs/toy-skew.json", "reduced": [],
                             "why": "a toy"})
    bench["workloads"].append({"name": "toy-skew.lloyd", "config": "toy-skew",
                               "traffic": "lloyd-short", "chips": 1, "why": "two-step solves"})
    bench["end_to_end"][0]["workloads"].append("toy-skew.lloyd")
    bench["per_layer"].append({"name": "solves.lloyd", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "ops/kmeans",
                               "moves": "lloyd_iter_per_s", "workloads": ["toy-skew.lloyd"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    sp = spec.load("toy-skew.lloyd", tmp_path)
    assert sp.mix["iters"] == 2 and [m["name"] for m in sp.per_layer] == ["solves.lloyd"]
    res = run.run_cell(sp, 5, 0.2, False, torch.device("cpu"), Program(), time.perf_counter())
    assert res["correct"] and "lloyd_iter_per_s" in res["metrics"]
    reader = spec.reader("metrics", "solves.lloyd", tmp_path)
    assert reader.read(Context(window=Window(units=[{}, {}]))) == 2.0
    after = _digest(tmp_path / "portbench")
    assert all(after[p] == h for p, h in before.items())
