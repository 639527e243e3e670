"""What the subsystem benches share: the min-rf-2 scoring tables, the
bit-identity key of window records, the paired telemetry rounds of the
overhead blocks, the live endpoint's scraper, the port's ``bench_records``
entry and the artifact writer.  Each bench keeps its reference's functions and artifact keys; these
are the parts every one of them repeats."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time
import urllib.request

__all__ = ["min_rf2_scoring", "strip_seconds", "telemetry_rounds", "scraping", "bench_record",
           "write_artifact"]


def min_rf2_scoring(every_category: bool = False):
    """validated scoring with Moderate raised 1 -> 2 (any rf=1 category
    trivially loses a killed node's singletons), or every category at
    rf >= 2 (``every_category``: one rotten copy is always recoverable from
    a clean peer)."""
    from ..config import validated_scoring_config

    base = validated_scoring_config()
    rf = dict(base.replication_factors)
    if every_category:
        rf = {c: max(2, r) for c, r in rf.items()}
    else:
        rf["Moderate"] = max(2, rf["Moderate"])
    return dataclasses.replace(base, replication_factors=rf)


def strip_seconds(records: list[dict], drop=("seconds",)) -> list[dict]:
    """Records minus wall-clock noise (and any other ``drop`` keys): the
    bit-identity comparison key."""
    return [{k: v for k, v in r.items() if k not in drop} for r in records]


def telemetry_rounds(mk, events, repeats: int):
    """(plain seconds, instrumented seconds, sorted paired ratios) of
    ``repeats`` interleaved rounds of ``mk().run(events)``, the instrumented
    side streaming its records and telemetry through a JSONL sink; one
    plain warm-up run first."""
    from ..obs import JsonlSink, Telemetry
    from .summary import _paired

    def run_plain() -> float:
        t0 = time.perf_counter()
        mk().run(events)
        return time.perf_counter() - t0

    run_plain()  # warmup
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "t.jsonl")

        def run_instr() -> float:
            if os.path.exists(path):
                os.remove(path)
            t0 = time.perf_counter()
            with Telemetry(JsonlSink(path)):
                mk().run(events, metrics_path=path)
            return time.perf_counter() - t0

        return _paired(run_plain, run_instr, repeats)


@contextlib.contextmanager
def scraping(url: str, interval: float = 0.1):
    """A thread polling ``url``'s ``/metrics`` and ``/statusz`` every
    ``interval`` seconds while the block runs (at 10 Hz, 10x an aggressive
    1 s Prometheus scrape interval); yields ``{"n": scrapes answered}``."""
    stop = threading.Event()
    counter = {"n": 0}

    def scrape():
        while not stop.is_set():
            for path in ("/metrics", "/statusz"):
                try:
                    with urllib.request.urlopen(url + path, timeout=2) as r:
                        r.read()
                    counter["n"] += 1
                except OSError:
                    pass
            stop.wait(interval)

    th = threading.Thread(target=scrape, daemon=True)
    th.start()
    try:
        yield counter
    finally:
        stop.set()
        th.join(timeout=5.0)


def bench_record(metric: str, value, unit: str, device, direction: str | None = None) -> dict:
    """One ``bench_records`` entry as ``regress.extract_records`` ingests
    it: the port's backend and the card's name (the platform it bands on)."""
    from ..device import device_name, resolve_device

    rec = {"metric": metric, "value": value, "unit": unit}
    if direction is not None:
        rec["direction"] = direction
    rec.update(backend="torch", device_name=device_name(resolve_device(device)))
    return rec


def write_artifact(path: str, out: dict, device) -> None:
    """``out`` as indented JSON at ``path``, stamped with ``run_meta`` (the
    interpreter, torch and, once CUDA is up, the card's name and power
    limit) and ``cold_init``: which init the controllers' full re-clusters
    started from (criteria near an init-sensitive edge, ROADMAP Queue C,
    depend on it)."""
    from ..device import device_name, resolve_device
    from ..obs import run_metadata

    out["run_meta"] = run_metadata()
    out["cold_init"] = ("the port's own D² init (ops/kmeans, KMeansConfig.seed) drawn on "
                        + device_name(resolve_device(device)))
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
