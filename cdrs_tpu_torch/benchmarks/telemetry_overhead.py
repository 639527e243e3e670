"""Telemetry + decision-tracing overhead of the streaming daemon; the
counterpart of ``cdrs_tpu/benchmarks/telemetry_overhead.py``.

The standing acceptance bound: a fully instrumented run must stay within
**1.05x** of the same run with telemetry off.  The bench measures both the
traced daemon (per-decision causal tracing, ``obs/trace.py``) and a traced
daemon with the live operational plane (``obs/httpz.py``: a per-window
immutable snapshot published to an in-process HTTP endpoint) attached and
an aggressive scraper polling ``/metrics`` + ``/statusz`` throughout.

Methodology: interleaved paired rounds — each round runs the SAME binary
log through a plain daemon (no metrics sink, tracing off), a traced daemon
(metrics sink + tracing + audit path), and a scraped daemon (traced + live
endpoint + scraper), so host noise lands on all sides equally.  One
untimed plain daemon runs before round 0: the first daemon of a fresh
process pays the device's start-up, which no round should carry.  Headline
is the best-window ratio (min instrumented / min plain); the per-round
paired ratios and every raw window are disclosed in the artifact.  The
daemons fold and re-cluster on ``device`` (CUDA unless ``--device cpu``).

    python -m cdrs_tpu_torch.benchmarks.telemetry_overhead [--quick] [--device cpu]

writes ``data/telemetry_overhead_torch.json`` (no history row: a ratio
near 1.0 is a criterion, not a trajectory).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from ..config import GeneratorConfig, KMeansConfig, SimulatorConfig, validated_scoring_config
from ..control.controller import ControllerConfig, ReplicationController
from ..daemon import StreamDaemon
from ..device import resolve_device
from ..sim.access import simulate_access
from ..sim.generator import generate_population
from .common import scraping, write_artifact

__all__ = ["run_overhead"]

DEFAULT_OUT = "data/telemetry_overhead_torch.json"

BUDGET = 1.05

NOTE = ("The <=5% acceptance bound re-checked with the decision-tracing surfaces "
        "active on the daemon path (a decision_trace event per processed window with "
        "exact integer-ns segment telescoping, tail-sampled exemplar span trees, "
        "first-pin recording on the epoch publisher) plus the live operational plane: "
        "a per-window immutable ObsSnapshot published to the in-process HTTP endpoint "
        "(obs/httpz.py), measured both unscraped (traced) and with a 10Hz scraper "
        "polling /metrics + /statusz for the whole run (scraped).  Trace analysis is a "
        "consumer-side cost and never runs in the loop.  Interleaved paired rounds, "
        "best-window ratio; every window disclosed.  One untimed plain daemon runs "
        "before round 0, so that no round carries the process's device start-up.")


def _daemon(manifest, window_seconds: float, k: int, device) -> StreamDaemon:
    cfg = ControllerConfig(window_seconds=window_seconds, default_rf=2,
                           kmeans=KMeansConfig(k=k, seed=42),
                           scoring=validated_scoring_config(), device=device)
    return StreamDaemon(ReplicationController(manifest, cfg))


def run_overhead(n_files: int = 20_000, n_windows: int = 8, window_seconds: float = 60.0,
                 k: int = 12, rounds: int = 9, seed: int = 51, device=None) -> dict:
    """Paired plain / traced / scraped daemon rounds over one shared binary
    log (module docstring).  Returns the artifact's ``daemon`` block."""
    from ..obs.httpz import ObsServer

    dev = resolve_device(device)
    manifest = generate_population(GeneratorConfig(
        n_files=n_files, seed=seed, nodes=("dn1", "dn2", "dn3", "dn4", "dn5")))
    events = simulate_access(manifest, SimulatorConfig(
        duration_seconds=n_windows * window_seconds, seed=seed + 1))

    plain: list[float] = []
    traced: list[float] = []
    scraped: list[float] = []
    trace_events = 0
    scrapes = 0
    with tempfile.TemporaryDirectory() as td:
        log = os.path.join(td, "events.cdrsb")
        events.write_binary(log, manifest)
        _daemon(manifest, window_seconds, k, dev).run(log)   # warm-up, untimed
        for r in range(rounds):
            d = _daemon(manifest, window_seconds, k, dev)
            t0 = time.perf_counter()
            d.run(log)
            plain.append(time.perf_counter() - t0)

            d = _daemon(manifest, window_seconds, k, dev)
            metrics = os.path.join(td, f"m{r}.jsonl")
            t0 = time.perf_counter()
            dig = d.run(log, metrics_path=metrics)
            traced.append(time.perf_counter() - t0)
            trace_events = int(dig["traced_decisions"])

            # Scrape-under-load: the same traced run, live endpoint
            # attached, a scraper hammering it the whole time.
            d = _daemon(manifest, window_seconds, k, dev)
            metrics = os.path.join(td, f"s{r}.jsonl")
            with ObsServer() as srv:
                d.attach_http(srv)
                with scraping(srv.url) as counter:
                    t0 = time.perf_counter()
                    d.run(log, metrics_path=metrics)
                    scraped.append(time.perf_counter() - t0)
                scrapes = counter["n"]

    ratios = sorted(t / p for t, p in zip(traced, plain))
    s_ratios = sorted(s / p for s, p in zip(scraped, plain))
    return {
        "n_files": n_files,
        "windows_per_run": n_windows,
        "plain_seconds": min(plain),
        "traced_seconds": min(traced),
        "scraped_seconds": min(scraped),
        "plain_windows": plain,
        "traced_windows": traced,
        "scraped_windows": scraped,
        "paired_ratios": ratios,
        "paired_ratio_median": ratios[len(ratios) // 2],
        "scraped_paired_ratios": s_ratios,
        "scraped_paired_ratio_median": s_ratios[len(s_ratios) // 2],
        "overhead_ratio": min(traced) / min(plain),
        "scrape_overhead_ratio": min(scraped) / min(plain),
        "scrapes_last_run": scrapes,
        "trace_events_per_run": trace_events,
        "budget": BUDGET,
        "within_budget": min(traced) / min(plain) <= BUDGET,
        "scrape_within_budget": min(scraped) / min(plain) <= BUDGET,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.telemetry_overhead",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--quick", action="store_true", help="small sizes for smoke runs (CI)")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        block = run_overhead(n_files=2_000, n_windows=6, rounds=3, device=dev)
    else:
        block = run_overhead(device=dev)

    out = {"artifact": "telemetry_overhead_torch", "note": NOTE, "daemon": block}
    write_artifact(args.out, out, dev)
    print(json.dumps({"out": args.out,
                      "overhead_ratio": block["overhead_ratio"],
                      "within_budget": block["within_budget"],
                      "scrape_overhead_ratio": block["scrape_overhead_ratio"],
                      "scrape_within_budget": block["scrape_within_budget"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
