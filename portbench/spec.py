"""``BENCHMARK.json`` and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Spec:
    """One cell: its entry, configuration, mix, limits and metrics."""

    workload: str
    chips: int
    config: dict
    mix: dict
    cell: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module of its own."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def _for_cell(entry: dict, cell: str) -> bool:
    return cell in entry.get("workloads", [cell])


def load(workload: str, root: Path = ROOT) -> Spec:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    bench = read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _for_cell(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    pkg = root / bench["paths"][0]
    return Spec(workload=workload, chips=int(entry["chips"]),
                config=read_json(root / conf["file"]),
                mix=read_json(pkg / "mixes" / f"{entry['traffic']}.json"),
                cell=read_json(pkg / "cells" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer, root=root)


def reader(kind: str, name: str, root: Path = ROOT):
    """The reader module of metric ``name``: ``kind`` is "e2e" or "metrics".
    It is ``<kind>/<name>.py``, or where there is none the reader of the
    quantity before the first dot (``idle_share.decide`` reads with
    ``idle_share.py``)."""
    path = root / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        path = path.with_name(f"{name.split('.')[0]}.py")
    return load_module(path, f"portbench_{kind}_{name}")
