"""Overload-resilience baselines: sustained overfeed, brownout serving; the
counterpart of ``cdrs_tpu/benchmarks/overload_bench.py``.  Three scenario
families over the brownout-enabled streaming daemon (daemon/brownout.py and
the lag accounting in daemon/core.py), one artifact
(``data/overload_bench_torch.json``):

**Sustained overfeed** (``run_overload_sustain``): a live writer appends the
event log at >= 2x the daemon's calibrated decision rate.  With the ladder
the ``coalesce`` rung multiplies decision capacity, so lag must plateau
below a fixed bound, the ladder must engage >= 2 rungs, and once the feed
relaxes to 0.5x the ladder must release all the way back to rung 0.

**Serving availability under brownout** (``run_availability``): a
pre-written log (the daemon starts the whole stream behind) with the serve
path on and a crash in the window grid, thresholds low enough that the
ladder rides to ``shed_reads``.  Availability (routed reads that found a
live replica, out of all reads MINUS the explicit sheds) must stay >= 99%.

**Coalescing determinism** (``run_coalesce_determinism``): the same overfed
log run twice must give byte-identical window records and rung
transitions; every ingested event folds into exactly one decision and
every decision publishes exactly one epoch.

The daemons' controllers fold and re-cluster on ``device`` (CUDA unless
``--device cpu``).

    python -m cdrs_tpu_torch.benchmarks.overload_bench [--quick] [--device cpu]

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

from ..config import GeneratorConfig, KMeansConfig, SimulatorConfig, validated_scoring_config
from ..control.controller import ControllerConfig, ReplicationController
from ..daemon import BrownoutConfig, DaemonConfig, StreamDaemon
from ..device import resolve_device
from ..faults import FaultSchedule, ScrubConfig
from ..io.events import EventLog
from ..serve import ServeConfig
from ..sim.access import simulate_access
from ..sim.generator import generate_population
from .common import bench_record, strip_seconds, write_artifact

__all__ = ["run_overload_sustain", "run_availability", "run_coalesce_determinism"]

DEFAULT_OUT = "data/overload_bench_torch.json"

_NODES = ("dn1", "dn2", "dn3", "dn4", "dn5")


def _controller(manifest, window_seconds: float, k: int, *, serve: bool = False,
                faults: bool = False, device=None) -> ReplicationController:
    cfg = ControllerConfig(
        window_seconds=window_seconds, default_rf=2,
        kmeans=KMeansConfig(k=k, seed=42),
        scoring=validated_scoring_config(),
        serve=ServeConfig(policy="p2c", seed=3) if serve else None,
        fault_schedule=FaultSchedule.from_specs(["crash:dn2@3-3"]) if faults else None,
        scrub=ScrubConfig(bytes_per_window=10**9) if faults else None,
        device=device)
    return ReplicationController(manifest, cfg)


def _population(n_files: int, duration: float, seed: int):
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    return manifest, events


def _window_slices(events, window_seconds: float) -> list[EventLog]:
    """The event log cut on the controller's window grid, the unit the live
    feeder appends (whole windows, so window closes are driven by the FEED
    rate).  The grid origin matches control/windows.py: floor of the first
    event's timestamp."""
    t0 = np.floor(events.ts[0])
    idx = np.floor_divide(events.ts - t0, window_seconds).astype(np.int64)
    out = []
    for w in range(int(idx.max()) + 1):
        m = idx == w
        out.append(EventLog(ts=events.ts[m], path_id=events.path_id[m], op=events.op[m],
                            client_id=events.client_id[m], clients=events.clients))
    return out


def run_overload_sustain(n_files: int = 2_000, n_burst: int = 24, n_calm: int = 16,
                         window_seconds: float = 60.0, k: int = 10, overfeed: float = 2.0,
                         seed: int = 47, device=None) -> dict:
    """Live >= 2x overfeed, then a 0.5x calm-down (module docstring):
    bounded lag, ladder engaged, full hysteretic recovery."""
    dev = resolve_device(device)
    n_windows = 1 + n_burst + n_calm
    manifest, events = _population(n_files, n_windows * window_seconds, seed)
    slices = _window_slices(events, window_seconds)

    with tempfile.TemporaryDirectory() as td:
        # Calibrate the un-degraded decision rate: mean seconds per decided
        # window over the same workload, ladder off.  A first run warms the
        # process (first launches, allocator, library handles): its
        # decisions would count one-time costs as the steady rate and pace
        # the feed below the overfeed it claims.
        log = os.path.join(td, "cal.cdrsb")
        events.write_binary(log, manifest)
        StreamDaemon(_controller(manifest, window_seconds, k, device=dev)).run(log)
        cal = StreamDaemon(_controller(manifest, window_seconds, k, device=dev))
        cal.run(log)
        d_mean = max(float(np.mean(cal.decision_seconds)), 0.005)

        live = os.path.join(td, "live.cdrsb")
        slices[0].write_binary(live, manifest)
        # Release thresholds sit ABOVE the follow-mode floor: the trailing
        # partial window never closes, so measured lag bottoms out around
        # one window.
        bc = BrownoutConfig(hold=1, release=(1.2, 1.5, 2.0, 3.0, 4.0))
        daemon = StreamDaemon(_controller(manifest, window_seconds, k, device=dev),
                              DaemonConfig(follow=True, poll=d_mean / 4.0, brownout=bc))

        def feeder():
            # Absolute-deadline pacing: slice i lands at its scheduled
            # instant whatever the appends take.  Burst phase: ``overfeed``
            # windows a calibrated decision time; calm phase: one window per
            # two decision times.
            start = time.monotonic()
            due = 0.0
            for i, sl in enumerate(slices[1:], start=1):
                due += d_mean / overfeed if i <= n_burst else d_mean * 2.0
                delay = start + due - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                sl.write_binary(live, manifest, append=True)
            # Let the daemon drain the backlog and walk the ladder back down,
            # then stop it between windows.  The trailing partial window
            # never closes in follow mode, so "drained" is level 0 with lag
            # below the bottom engage threshold, read from a decision made
            # after the last append (the lag of an earlier one predates the
            # appended slices, and stopping on it strands them).
            decided = len(daemon.records)
            deadline = time.monotonic() + 120.0
            floor = bc.engage[0]
            while time.monotonic() < deadline:
                if (len(daemon.records) > decided and daemon._lag["windows"] < floor
                        and daemon._ladder.level == 0):
                    break
                time.sleep(d_mean / 2.0)
            daemon.request_stop("bench_done")

        th = threading.Thread(target=feeder)
        th.start()
        dig = daemon.run(live)
        th.join()

    lag_series = [r["daemon"]["lag_windows"] for r in daemon.records]
    levels = [r["daemon"]["brownout_level"] for r in daemon.records]
    max_level = max(levels, default=0)
    engaged = [t for t in daemon.brownout_log if t["state"] == "engage"]
    released = [t for t in daemon.brownout_log if t["state"] == "release"]
    # Bounded: lag may spike to the injected backlog (n_burst windows plus
    # one coalesce group of grid slack) but never past it, and the backlog
    # must fully drain by the end.
    bound = n_burst + bc.coalesce_max
    return {
        "n_windows": n_windows,
        "overfeed": overfeed,
        "decision_seconds_calibrated": round(d_mean, 5),
        "windows_decided": len(daemon.records),
        "windows_coalesced": int(dig["brownout"]["windows_coalesced"]),
        "max_lag_windows": max(lag_series, default=0.0),
        "lag_bound_windows": float(bound),
        "max_rung_engaged": int(max_level),
        "rungs_engaged": sorted({t["rung"] for t in engaged}),
        "rung_transitions": len(daemon.brownout_log),
        "final_rung": int(dig["brownout"]["level"]),
        "final_lag_windows": float(dig["lag"]["windows"]),
        "stop_reason": dig["stop_reason"],
        "lag_bounded": max(lag_series, default=0.0) <= bound
        and dig["lag"]["windows"] < bc.engage[0],
        "ladder_engaged": max_level >= 2,
        "recovered_to_rung0": dig["brownout"]["level"] == 0 and len(released) >= max_level,
    }


def _overfed_daemon(manifest, window_seconds: float, k: int, device=None):
    """Brownout daemon that starts a whole pre-written log behind, with
    thresholds low enough to ride the ladder to ``shed_reads``."""
    return StreamDaemon(
        _controller(manifest, window_seconds, k, serve=True, faults=True, device=device),
        DaemonConfig(brownout=BrownoutConfig(engage=(0.5, 1.0, 1.5, 2.0, 3.0),
                                             release=(0.2, 0.4, 0.6, 0.8, 1.0), hold=1)))


def run_availability(n_files: int = 4_000, n_windows: int = 16, window_seconds: float = 120.0,
                     k: int = 10, seed: int = 53, device=None) -> dict:
    """Routed-read availability across a fully-overfed brownout run: >= 99%
    excluding the explicit, seeded sheds."""
    dev = resolve_device(device)
    manifest, events = _population(n_files, n_windows * window_seconds, seed)
    with tempfile.TemporaryDirectory() as td:
        log = os.path.join(td, "events.cdrsb")
        events.write_binary(log, manifest)
        daemon = _overfed_daemon(manifest, window_seconds, k, device=dev)
        dig = daemon.run(log)
    recs = daemon.records
    n_reads = sum(int(r.get("n_reads", 0)) for r in recs)
    shed = sum(int(r.get("reads_shed", 0)) for r in recs)
    unavailable = sum(int(r.get("unavailable_reads", 0)) for r in recs)
    served = n_reads - shed
    availability = (served - unavailable) / served if served else 1.0
    return {
        "n_reads": n_reads,
        "reads_shed": shed,
        "shed_fraction_of_total": round(shed / n_reads, 4) if n_reads else 0.0,
        "reads_unavailable": unavailable,
        "availability_excluding_sheds": round(availability, 6),
        "max_rung_engaged": max((r["daemon"]["brownout_level"] for r in recs), default=0),
        "windows_with_sheds": sum(1 for r in recs if r.get("reads_shed", 0) > 0),
        "epochs_published": int(dig["epochs_published"]),
        "sheds_exercised": shed > 0,
        "available_99": availability >= 0.99,
    }


def run_coalesce_determinism(n_files: int = 4_000, n_windows: int = 16,
                             window_seconds: float = 120.0, k: int = 10, seed: int = 53,
                             device=None) -> dict:
    """Double-run identity of the degraded decision stream + mass
    conservation of coalesced folds (module docstring)."""
    dev = resolve_device(device)
    manifest, events = _population(n_files, n_windows * window_seconds, seed)
    runs = []
    with tempfile.TemporaryDirectory() as td:
        log = os.path.join(td, "events.cdrsb")
        events.write_binary(log, manifest)
        for _ in range(2):
            daemon = _overfed_daemon(manifest, window_seconds, k, device=dev)
            dig = daemon.run(log)
            runs.append((daemon, dig))
    (d1, dig1), (d2, _) = runs
    groups = [r["daemon"]["coalesced"] for r in d1.records]
    return {
        "windows_in_log": n_windows,
        "decisions": len(d1.records),
        "coalesce_groups": groups,
        "windows_coalesced": int(dig1["brownout"]["windows_coalesced"]),
        "records_identical": strip_seconds(d1.records) == strip_seconds(d2.records),
        "transitions_identical": d1.brownout_log == d2.brownout_log,
        "events_conserved": sum(r["n_events"] for r in d1.records) == d1.events_ingested,
        "one_epoch_per_decision":
            dig1["epochs_published"] == dig1["windows_processed"] == len(d1.records),
        "coalescing_engaged": any(g > 1 for g in groups),
    }


def main(argv=None) -> int:
    from .regress import add_history_argument, append_history, extract_records, \
        resolve_history_path

    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.overload_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--round", type=int, default=20, dest="round_no",
                   help="PR-round stamp for the regress history")
    p.add_argument("--quick", action="store_true",
                   help="small sizes for smoke runs (CI); never appends to the history")
    add_history_argument(p)
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        sustain = run_overload_sustain(n_files=600, n_burst=16, n_calm=12, device=dev)
        avail = run_availability(n_files=1_500, n_windows=12, device=dev)
        det = run_coalesce_determinism(n_files=1_500, n_windows=12, device=dev)
    else:
        sustain = run_overload_sustain(device=dev)
        avail = run_availability(device=dev)
        det = run_coalesce_determinism(device=dev)

    out: dict = {
        "round": args.round_no,
        "overload_sustain": sustain,
        "availability_under_brownout": avail,
        "coalesce_determinism": det,
    }
    out["criteria"] = {
        "lag_bounded_under_2x_overfeed": sustain["lag_bounded"] and sustain["ladder_engaged"],
        "ladder_recovered_to_rung0": sustain["recovered_to_rung0"],
        "availability_99_excluding_sheds": avail["available_99"] and avail["sheds_exercised"],
        "coalescing_deterministic": det["records_identical"] and det["transitions_identical"]
        and det["events_conserved"] and det["one_epoch_per_decision"]
        and det["coalescing_engaged"],
    }
    out["bench_records"] = [
        bench_record("overload_max_lag_windows", sustain["max_lag_windows"], "windows", dev,
                     direction="lower"),
        bench_record("overload_availability_excluding_sheds",
                     avail["availability_excluding_sheds"], "fraction", dev,
                     direction="higher"),
        bench_record("overload_windows_coalesced", det["windows_coalesced"], "windows", dev),
    ]

    write_artifact(args.out, out, dev)
    appended = 0
    if not args.quick:
        history = resolve_history_path(args)
        if history:
            appended = append_history(history,
                                      extract_records(out, os.path.basename(args.out)))
    print(json.dumps({"out": args.out, **out["criteria"],
                      "max_lag_windows": sustain["max_lag_windows"],
                      "availability": avail["availability_excluding_sheds"],
                      "history_appended": appended}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
