"""Streaming-daemon baselines: decision latency, serving under re-plan; the
counterpart of ``cdrs_tpu/benchmarks/daemon_bench.py``.  Three scenario
families, one artifact (``data/daemon_bench_torch.json``):

**Event-to-decision latency** (``run_decision_latency``): the daemon tails a
binary event log and every closed window must become an admitted plan and a
published epoch in sub-second time: p99 over the per-window carve ->
decide -> publish wall clock (the daemon's ``decision_seconds``).  It runs
WITH decision tracing (obs/trace.py) and the live HTTP plane (obs/httpz.py)
under a scraper polling ``/metrics`` and ``/statusz``; ``trace_reconciled``
asserts the exact integer-ns segment telescoping of every traced decision.

**Serving under re-clustering** (``run_serve_under_recluster``): the
epoch-pinned read path must sustain >= 1M routed reads a second WHILE the
daemon re-clusters and republishes underneath.  The daemon ingests the
whole log in a background thread (which launches the re-clusters' kernels
on ``device``); the foreground pins one epoch per read batch and routes
through its functional resolver.  The run must see at least two distinct
epochs across its batches.

**Decayed-fold identity** (``run_decay_identity``): at decay 1.0 the
daemon's decayed fold (force-enabled) must be DECISION-identical to the
windowed batch controller on three seeds: plan hashes, category
populations, durability tiers.

``decision_vs_window`` times a daemon decision and a bare controller
window interleaved in one process, which tells host drift apart from the
daemon's own cost; ``main`` prints it on a line of its own, outside the
artifact.

    python -m cdrs_tpu_torch.benchmarks.daemon_bench [--quick] [--device cpu]

Outside ``--quick`` the bench_records are appended to the port's history
(``regress.append_history``, deduplicated).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from ..config import GeneratorConfig, KMeansConfig, SimulatorConfig, validated_scoring_config
from ..control.controller import ControllerConfig, ReplicationController
from ..daemon import StreamDaemon
from ..device import resolve_device
from ..serve import ReadRouter, ServeConfig
from ..sim.access import simulate_access
from ..sim.generator import generate_population
from .common import bench_record, scraping, write_artifact

__all__ = ["run_decision_latency", "run_serve_under_recluster", "run_decay_identity",
           "decision_vs_window"]

DEFAULT_OUT = "data/daemon_bench_torch.json"

_NODES = ("dn1", "dn2", "dn3", "dn4", "dn5")


def _controller(manifest, window_seconds: float, k: int, decay: float = 1.0,
                device=None) -> ReplicationController:
    cfg = ControllerConfig(window_seconds=window_seconds, default_rf=2, decay=decay,
                           kmeans=KMeansConfig(k=k, seed=42),
                           scoring=validated_scoring_config(), device=device)
    return ReplicationController(manifest, cfg)


def _population(n_files: int, duration: float, seed: int):
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    return manifest, events


def run_decision_latency(n_files: int = 20_000, n_windows: int = 20,
                         window_seconds: float = 60.0, k: int = 12, seed: int = 41,
                         device=None) -> dict:
    """p99 window-close-to-admitted-decision latency through the full daemon
    path (binary-log tail -> carve -> fold -> decide -> epoch publish) with
    decision tracing on and the live HTTP plane under an active scraper."""
    import urllib.request

    from ..obs import prom
    from ..obs.aggregate import collect, critical_path_digest
    from ..obs.httpz import ObsServer

    dev = resolve_device(device)
    manifest, events = _population(n_files, n_windows * window_seconds, seed)
    with tempfile.TemporaryDirectory() as td:
        log = os.path.join(td, "events.cdrsb")
        metrics = os.path.join(td, "metrics.jsonl")
        events.write_binary(log, manifest)
        daemon = StreamDaemon(_controller(manifest, window_seconds, k, device=dev))
        with ObsServer() as srv:
            daemon.attach_http(srv)
            with scraping(srv.url) as counter:
                dig = daemon.run(log, metrics_path=metrics)
            with urllib.request.urlopen(srv.url + "/metrics", timeout=5) as r:
                final_scrape = r.read().decode("utf-8")
            snap = srv.snapshot
        live_endpoint = {
            "scrapes": int(counter["n"]),
            "snapshot_seq": int(snap.seq),
            "snapshot_consistent": bool(snap.seq == snap.windows_processed
                                        == snap.epochs_published),
            "metrics_lint_clean": prom.lint(final_scrape) == [],
        }
        with open(metrics, encoding="utf-8") as f:
            evs = [json.loads(line) for line in f]
    lat = np.asarray(daemon.decision_seconds, dtype=np.float64)
    agg = collect(evs)
    cp = critical_path_digest(agg["decisions"], agg["windows"]) or {}
    return {
        "n_files": n_files,
        "n_windows": int(dig["windows_processed"]),
        "events": int(dig["events_ingested"]),
        "epochs_published": int(dig["epochs_published"]),
        "decision_p50_seconds": round(float(np.quantile(lat, 0.5)), 6),
        "decision_p99_seconds": float(dig["decision_p99_seconds"]),
        "decision_max_seconds": round(float(lat.max()), 6),
        "sub_second_p99": bool(dig["decision_p99_seconds"] < 1.0),
        "traced_decisions": int(dig["traced_decisions"]),
        "trace_reconciled": bool(cp.get("reconciled", False)),
        "stage_attribution": {name: round(share, 4)
                              for name, share in (cp.get("stage_shares") or {}).items()},
        "event_to_decision_p99_seconds": round(float(cp.get("total_p99_seconds", 0.0)), 6),
        "live_endpoint": live_endpoint,
    }


def run_serve_under_recluster(n_files: int = 1 << 15, n_windows: int = 24,
                              window_seconds: float = 60.0, k: int = 16,
                              reads_per_batch: int = 1_000_000, min_batches: int = 4,
                              max_batches: int = 64, seed: int = 43, device=None) -> dict:
    """Routed reads/s through the pinned epoch while the daemon re-clusters
    and republishes underneath (module docstring)."""
    dev = resolve_device(device)
    manifest, events = _population(n_files, n_windows * window_seconds, seed)
    rng = np.random.default_rng(seed + 7)
    n_nodes = len(_NODES)
    router = ReadRouter(n_nodes, ServeConfig(policy="p2c", seed=seed))

    batches: list[dict] = []
    with tempfile.TemporaryDirectory() as td:
        log = os.path.join(td, "events.cdrsb")
        events.write_binary(log, manifest)
        daemon = StreamDaemon(_controller(manifest, window_seconds, k, device=dev))
        t = threading.Thread(target=daemon.run, args=(log,), daemon=True)
        t.start()
        while daemon.publisher.pin() is None and t.is_alive():
            time.sleep(0.002)
        # Route batches pinned one-epoch-each until the daemon finishes (and
        # at least ``min_batches`` either way): skewed pids, the zipf-ish
        # head the load-aware policy exists to absorb.
        while (t.is_alive() or len(batches) < min_batches) and len(batches) < max_batches:
            ep = daemon.publisher.pin()
            ts = np.sort(rng.random(reads_per_batch) * window_seconds)
            pid = (n_files * rng.random(reads_per_batch) ** 3.0).astype(np.int32)
            client = rng.integers(0, n_nodes, reads_per_batch).astype(np.int32)
            t0 = time.perf_counter()
            rv = ep.read_view(pid)
            res = router.route(rv.replica_map, rv.slot_ok, rv.node_throughput, ts=ts,
                               pid=rv.pid, client=client, window_seconds=window_seconds)
            dt = time.perf_counter() - t0
            batches.append({"epoch": int(ep.epoch_id), "seconds": round(dt, 4),
                            "p99_ms": round(res.p99_ms, 4)})
        t.join()
    total_reads = reads_per_batch * len(batches)
    total_seconds = sum(b["seconds"] for b in batches)
    epochs_seen = sorted({b["epoch"] for b in batches})
    return {
        "n_files": n_files,
        "reads_per_batch": reads_per_batch,
        "batches": len(batches),
        "reads_per_sec": round(total_reads / total_seconds, 1),
        "epochs_published": int(daemon.publisher.published_total),
        "epochs_seen_while_routing": epochs_seen,
        "per_batch": batches,
        "sustained_1m_reads_per_sec": total_reads / total_seconds >= 1_000_000,
        "reclustered_underneath": len(epochs_seen) >= 2,
    }


def run_decay_identity(n_files: int = 2_000, n_windows: int = 12,
                       window_seconds: float = 120.0, k: int = 10,
                       seeds: tuple[int, ...] = (0, 1, 2), device=None) -> dict:
    """Decay=1.0 decayed live fold vs windowed batch controller: decision
    identity per seed (plan hashes, category populations, durability
    tiers)."""
    dev = resolve_device(device)
    per_seed = []
    for seed in seeds:
        manifest, events = _population(n_files, n_windows * window_seconds, 100 + seed)
        batch = _controller(manifest, window_seconds, k, device=dev)
        res = batch.run(events)
        live = _controller(manifest, window_seconds, k, device=dev)
        # Force the decayed accumulator on (normally elided at decay=1.0) so
        # the identity claim exercises the decayed path.
        live._dec = {key: torch.zeros(len(manifest), dtype=torch.float64, device=live.device)
                     for key in ("access_freq", "writes", "local_acc", "conc_max")}
        live._dec_obs_end = None
        with tempfile.TemporaryDirectory() as td:
            log = os.path.join(td, "events.cdrsb")
            events.write_binary(log, manifest)
            daemon = StreamDaemon(live)
            daemon.run(log)
        hashes_batch = [r["plan_hash"] for r in res.records]
        hashes_live = [r["plan_hash"] for r in daemon.records]
        pops_batch = np.bincount(batch.current_cat, minlength=k)
        pops_live = np.bincount(live.current_cat, minlength=k)
        per_seed.append({
            "seed": seed,
            "windows": len(daemon.records),
            "plan_hashes_identical": hashes_batch == hashes_live,
            "category_populations_identical": bool(np.array_equal(pops_batch, pops_live)),
            "durability_tiers_identical": bool(np.array_equal(batch.current_rf,
                                                              live.current_rf)),
        })
    return {
        "n_files": n_files, "n_windows": n_windows, "seeds": list(seeds),
        "per_seed": per_seed,
        "decay_one_identical": all(
            s["plan_hashes_identical"] and s["category_populations_identical"]
            and s["durability_tiers_identical"] for s in per_seed),
    }


def decision_vs_window(n_files: int = 20_000, n_windows: int = 20,
                       window_seconds: float = 60.0, k: int = 12, seed: int = 41,
                       rounds: int = 2, device=None) -> dict:
    """A daemon decision (``decision_seconds``) and a bare controller window
    (its record's ``seconds.total``) over the same log, in alternating
    order, ``rounds`` times each in this process: p50 and max of each side
    and their p50 ratio."""
    dev = resolve_device(device)
    manifest, events = _population(n_files, n_windows * window_seconds, seed)
    daemon_s: list[float] = []
    window_s: list[float] = []
    with tempfile.TemporaryDirectory() as td:
        log = os.path.join(td, "events.cdrsb")
        events.write_binary(log, manifest)
        for r in range(max(1, rounds)):
            for side in (("daemon", "controller") if r % 2 == 0 else ("controller", "daemon")):
                if side == "daemon":
                    daemon = StreamDaemon(_controller(manifest, window_seconds, k, device=dev))
                    daemon.run(log)
                    daemon_s.extend(daemon.decision_seconds)
                else:
                    res = _controller(manifest, window_seconds, k, device=dev).run(events)
                    window_s.extend(rec["seconds"]["total"] for rec in res.records)
    d, c = np.asarray(daemon_s), np.asarray(window_s)
    return {
        "n_files": n_files, "n_windows": n_windows, "rounds": rounds,
        "daemon_decision_p50_seconds": round(float(np.median(d)), 6),
        "daemon_decision_max_seconds": round(float(d.max()), 6),
        "controller_window_p50_seconds": round(float(np.median(c)), 6),
        "controller_window_max_seconds": round(float(c.max()), 6),
        "daemon_over_controller_p50": round(float(np.median(d) / np.median(c)), 4),
    }


def main(argv=None) -> int:
    from .regress import add_history_argument, append_history, extract_records, \
        resolve_history_path

    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.daemon_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--round", type=int, default=18, dest="round_no",
                   help="PR-round stamp for the regress history")
    p.add_argument("--quick", action="store_true",
                   help="small sizes for smoke runs (CI); never appends to the history")
    add_history_argument(p)
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        latency = run_decision_latency(n_files=2_000, n_windows=8, device=dev)
        serve = run_serve_under_recluster(n_files=1 << 13, n_windows=12,
                                          reads_per_batch=200_000, min_batches=3, device=dev)
        decay = run_decay_identity(n_files=500, n_windows=8, seeds=(0, 1, 2), device=dev)
        interleaved = decision_vs_window(n_files=2_000, n_windows=8, device=dev)
    else:
        latency = run_decision_latency(device=dev)
        serve = run_serve_under_recluster(device=dev)
        decay = run_decay_identity(device=dev)
        interleaved = decision_vs_window(device=dev)
    print(json.dumps({"decision_vs_window": interleaved}))

    out: dict = {
        "round": args.round_no,
        "decision_latency": latency,
        "serve_under_recluster": serve,
        "decay_identity": decay,
    }
    out["criteria"] = {
        "decision_p99_sub_second": latency["sub_second_p99"],
        "trace_reconciled": latency["trace_reconciled"],
        "endpoint_scraped_during_run":
            latency["live_endpoint"]["scrapes"] > 0
            and latency["live_endpoint"]["snapshot_consistent"]
            and latency["live_endpoint"]["metrics_lint_clean"],
        "routed_1m_reads_per_sec_during_recluster":
            serve["sustained_1m_reads_per_sec"] and serve["reclustered_underneath"],
        "decay_one_decision_identical": decay["decay_one_identical"],
    }
    out["bench_records"] = [
        bench_record("daemon_decision_p99_seconds", latency["decision_p99_seconds"], "s", dev,
                     direction="lower"),
        bench_record("daemon_routed_reads_per_sec", serve["reads_per_sec"], "reads/s", dev),
    ]

    write_artifact(args.out, out, dev)
    appended = 0
    if not args.quick:
        history = resolve_history_path(args)
        if history:
            appended = append_history(history,
                                      extract_records(out, os.path.basename(args.out)))
    print(json.dumps({"out": args.out, **out["criteria"],
                      "decision_p99_seconds": latency["decision_p99_seconds"],
                      "reads_per_sec": serve["reads_per_sec"],
                      "history_appended": appended}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
