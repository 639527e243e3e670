"""One harness for every scenario cell: ``cdrs_tpu/scenarios/harness.py`` on
the port's controller.

``run_cell`` turns a ``ScenarioSpec`` into a run of the port's
``ReplicationController`` on ``device`` (CUDA unless "cpu" is asked for) —
manifest, workload curve, drift phases, fault schedule, topology, scrubber,
read path — and checks invariants, not just metrics:

* **zero silent loss** — no file ends lost (``durability.lost``), no file
  ends truly lost (``integrity.true_lost``) and no rot outlives a scrubber;
* **churn-budget conservation** — every window's repair + migration +
  scrub bytes fit the one shared budget (runs with corruption: within one
  verified boundary task, whose source-verification reads repair charges
  before it defers the copy);
* **domain diversity** — with several racks, no file ends with all its
  reachable copies in one domain;
* **kill/resume bit-identity** — cells with ``resume_window`` re-run
  killed after that window and resumed from the checkpoint; the stitched
  records and the final plan equal the uninterrupted run's;
* **positive engagement** — faults applied, drift re-clustered,
  corruption rotted or found: an axis that silently did nothing fails;
* **alerting** — a cell's expected alerts (obs/alerts.py) fire and its
  forbidden ones stay silent;
* **EC engagement** — a cell whose storage config erasure-codes a category
  must install and account a stripe in some window (``ec_engaged``);
* **elasticity** (``spec.elastic``) — a scale-out fired, the rebalance moved
  exactly the epoch diff's files and drained its queue
  (``elastic_engaged``), and the added nodes drained back to the baseline
  (``elastic_drained``); the rebalance bytes count against the churn budget;
* **the placement axis** (``spec.placement`` other than "materialized") —
  every record carries the mode's stamp, and a functional fault run its
  exception count (``functional_engaged``);
* **the read path** (``spec.serve``) — reads were routed, and the last
  window in which reads happened has a finite p99 within the cell's bound,
  refused no read and, where the cell sets one, kept its SLO burn;
* **the daemon** (``spec.daemon``) — the same stream through the streaming
  daemon: records equal to the batch run's, at least two epochs, the pinned
  epoch frozen, stop/resume stitching exact, decision traces reconciled,
  and the live HTTP plane scraped over real HTTP.

* **the mesh** (``spec.mesh``) — every record carries the mesh stamp at
  the requested shard count and at least one re-cluster ran on it
  (``mesh_engaged``).

Every axis of the reference's matrix runs on the port.  A failing cell
carries a one-line repro command (:func:`repro_line`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np

from ..config import GeneratorConfig, KMeansConfig, ScoringConfig, SimulatorConfig, \
    validated_scoring_config
from ..control.controller import ControllerConfig, ReplicationController
from ..faults import FaultSchedule
from ..io.events import EventLog, Manifest
from ..obs.aggregate import coverage_fingerprint
from ..obs.alerts import evaluate_records
from ..sim.access import simulate_access, simulate_access_phased, simulate_diurnal, \
    simulate_flash_crowd
from ..sim.generator import generate_population
from .spec import ScenarioSpec

__all__ = ["build_events", "build_schedule", "coverage_bits", "run_cell", "repro_line"]

_DEFAULT_FLIP = {"hot": "archival", "archival": "hot"}

def _scoring(spec: ScenarioSpec) -> ScoringConfig:
    """The cell's scoring table; ``min_rf2`` is the validated table with
    Moderate raised to rf 2."""
    if spec.scoring == "default":
        return ScoringConfig()
    base = validated_scoring_config()
    if spec.scoring == "validated":
        return base
    rf = dict(base.replication_factors)
    rf["Moderate"] = max(2, rf["Moderate"])
    return dataclasses.replace(base, replication_factors=rf)


def build_events(spec: ScenarioSpec, manifest: Manifest) -> tuple[EventLog, np.ndarray]:
    """The cell's event log from its workload and drift axes, and the mask of
    files whose final planted category differs from the initial one."""
    cfg = SimulatorConfig(duration_seconds=float(spec.duration), seed=int(spec.seed) + 1)
    wl = spec.workload or {"kind": "poisson"}
    kind = wl.get("kind", "poisson")
    none = np.zeros(len(manifest), dtype=bool)
    if kind == "diurnal":
        period = float(wl.get("period_frac", 1.0)) * float(spec.duration)
        ev = simulate_diurnal(manifest, cfg, amplitude=float(wl.get("amplitude", 0.8)),
                              period=period, phase=float(wl.get("phase", 0.0)))
        return ev, none
    if kind == "flash_crowd":
        cat = wl.get("cohort", "archival")
        cohort = np.asarray([c == cat for c in manifest.category])
        ev, _ = simulate_flash_crowd(
            manifest, cfg, cohort=cohort,
            start=float(wl.get("start_frac", 0.5)) * float(spec.duration),
            duration=float(wl.get("duration_frac", 0.1)) * float(spec.duration),
            boost=float(wl.get("boost", 40.0)))
        return ev, none
    if spec.drift is None:
        return simulate_access(manifest, cfg), none
    return simulate_access_phased(manifest, cfg, _drift_shifts(spec, manifest))


def _drift_shifts(spec: ScenarioSpec, manifest: Manifest) -> list[tuple]:
    """The drift axis as ``simulate_access_phased`` shifts."""
    d = spec.drift
    flip = d.get("flip", _DEFAULT_FLIP)
    duration = float(spec.duration)
    if d["kind"] == "flip":
        return [(float(d.get("at_frac", 0.5)) * duration, flip, None)]
    start = float(d.get("start_frac", 0.3)) * duration
    end = float(d.get("end_frac", 0.8)) * duration
    if d["kind"] == "adversarial":
        times = np.linspace(start, end, int(d.get("cycles", 3)))
        return [(float(t), flip, None) for t in times]
    # gradual: the files whose planted category is a flip key move in
    # ``steps`` index-ordered waves.
    steps = int(d.get("steps", 3))
    cohort = np.flatnonzero(np.asarray([c in flip and flip[c] != c
                                        for c in manifest.category]))
    shifts = []
    for t, chunk in zip(np.linspace(start, end, steps), np.array_split(cohort, steps)):
        mask = np.zeros(len(manifest), dtype=bool)
        mask[chunk] = True
        shifts.append((float(t), flip, mask))
    return shifts


def build_schedule(spec: ScenarioSpec) -> FaultSchedule | None:
    """The fault axis: specs, a template and the seeded random generator
    merged into one window-keyed schedule."""
    f = spec.faults
    if f is None:
        return None
    events: list = []
    if f.get("specs"):
        events.extend(FaultSchedule.from_specs(f["specs"]))
    t = f.get("template")
    if t == "cascade":
        events.extend(FaultSchedule.cascade(f["nodes"], int(f["start"]),
                                            int(f.get("spacing", 1)), f.get("recover_after")))
    elif t == "rolling_decommission":
        events.extend(FaultSchedule.rolling_decommission(f["nodes"], int(f["start"]),
                                                         int(f.get("spacing", 2))))
    elif t is not None:
        raise ValueError(f"cell {spec.name!r}: unknown fault template {t!r}")
    if f.get("random"):
        r = dict(f["random"])
        r.setdefault("seed", spec.seed)
        events.extend(FaultSchedule.random(spec.nodes, int(r.pop("n_windows")), **r))
    if not events:
        raise ValueError(f"cell {spec.name!r}: faults axis present but empty")
    return FaultSchedule(events)


def _controller(spec: ScenarioSpec, manifest: Manifest, schedule: FaultSchedule | None,
                device) -> ReplicationController:
    """The port's controller for the cell."""
    topology = None
    if spec.topology is not None or spec.racks:
        from ..cluster.placement import ClusterTopology

        topology = (ClusterTopology.from_hierarchy(spec.topology) if spec.topology is not None
                    else ClusterTopology.from_rack_spec(manifest.nodes, spec.racks))
    scrub = None
    if spec.scrub is not None:
        from ..faults import ScrubConfig

        scrub = ScrubConfig(bytes_per_window=int(spec.scrub))
    scoring = _scoring(spec)
    storage = None
    if spec.storage:
        # A preset name ("replicate", "ec_archival") or a config dict.
        from ..storage import resolve_storage_config, storage_config_from_dict

        storage = (storage_config_from_dict(spec.storage) if isinstance(spec.storage, dict)
                   else resolve_storage_config(spec.storage, scoring))
    serve = None
    if spec.serve is not None:
        from ..serve import ServeConfig, SloSpec

        sv = spec.serve
        serve = ServeConfig(
            policy=sv.get("policy", "p2c"), seed=int(sv.get("seed", 0)),
            service_ms=float(sv.get("service_ms", 0.5)),
            slo=SloSpec(target_ms=float(sv.get("slo_ms", 10.0)),
                        availability=float(sv.get("availability", 0.999))),
            recluster_on_hotspot=bool(sv.get("recluster_on_hotspot", True)),
            verify_reads=bool(sv.get("verify_reads", True)))
    elastic = None
    if spec.elastic is not None:
        from ..control.elastic import ElasticPolicy

        elastic = ElasticPolicy.from_dict(spec.elastic)
    max_bytes = None
    if spec.budget_frac is not None:
        sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
        max_bytes = int(float(spec.budget_frac) * float(sizes.sum()))
    cfg = ControllerConfig(
        window_seconds=spec.window_seconds,
        drift_threshold=spec.drift_threshold,
        full_recluster_drift=spec.full_recluster_drift,
        hysteresis_windows=spec.hysteresis,
        max_bytes_per_window=max_bytes,
        max_files_per_window=spec.max_files,
        decay=spec.decay,
        default_rf=spec.default_rf,
        kmeans=KMeansConfig(k=spec.k, seed=42),
        scoring=scoring,
        topology=topology,
        fault_schedule=None if schedule is None else FaultSchedule(schedule.events),
        storage=storage,
        serve=serve,
        scrub=scrub,
        elastic=elastic,
        placement_mode=spec.placement,
        mesh_shape=dict(spec.mesh) if spec.mesh else None,
        device=device,
    )
    return ReplicationController(manifest, cfg)


def _strip(records: list[dict]) -> list[dict]:
    """Records without the wall-clock ``seconds``: the bit-identity key."""
    return [{k: v for k, v in r.items() if k != "seconds"} for r in records]


def _served_windows(records: list[dict]) -> list[dict]:
    """Windows in which reads happened, routed or refused: the one
    definition behind the SLO invariants and the reported final p99 (an
    outage that refuses every read to the end stays the final window)."""
    return [r for r in records if r.get("reads_routed") is not None
            and int(r.get("reads_routed", 0)) + int(r.get("reads_unavailable", 0)) > 0]


def _check_invariants(spec: ScenarioSpec, records: list[dict], max_bytes: int | None,
                      budget_slack: int, multi_domain: bool, has_corrupt: bool,
                      has_ec: bool = False, schedule=None,
                      alerts_fired: set | None = None) -> dict:
    """The reference's invariants for the axes the port runs, in its order
    (the keys name the coverage bits ``inv:<name>``)."""
    inv: dict[str, bool] = {}
    dur = [r for r in records if r.get("durability")]
    if dur:
        inv["zero_lost_final"] = dur[-1]["durability"]["lost"] == 0
    if spec.topology is not None and dur:
        n_regions = len({str(d) for d in (spec.topology.get(spec.topology["levels"][-1])
                                          or {})})
        if schedule is not None and any(":" in n for ev in schedule for n in ev.node_list):
            # A region-scale event must bite: some window saw fewer regions.
            inv["region_engaged"] = any(
                0 < r["durability"].get("regions_reachable", n_regions) < n_regions
                for r in dur)
        if schedule is not None and any(ev.kind == "partition" for ev in schedule):
            # A partition strands data, never loses it; repairs stall on it.
            stranded = [r for r in dur if r["durability"].get("unreachable", 0) > 0]
            inv["stranded_not_lost"] = bool(
                stranded and all(r["durability"]["lost"] == 0 for r in stranded))
            inv["partition_stall_engaged"] = any(
                r.get("repair_deferred_partition", 0) > 0 for r in records)
        last = dur[-1]["durability"]
        inv["heal_converged"] = (
            last.get("unreachable", 0) == 0 and last["under_replicated"] == 0
            and all(v == 0 for v in last.get("correlated_risk_levels", {}).values()))
    if spec.elastic is not None:
        el = [r.get("elastic") or {} for r in records]
        drained = [n for e in el for n in e.get("drained", ())]
        # Scale-out fired, its traffic was the epoch diff, the queue drained.
        inv["elastic_engaged"] = bool(
            any("added" in e for e in el)
            and sum(e.get("moved", 0) for e in el) == sum(e.get("rebalanced", 0) for e in el)
            and el[-1].get("queue", 0) == 0)
        # Capacity back to the baseline.
        inv["elastic_drained"] = bool(drained and dur
                                      and dur[-1]["durability"]["nodes_up"] == len(spec.nodes))
    if spec.faults is not None:
        inv["faults_engaged"] = any(r.get("fault_events") for r in records)
    if spec.drift is not None:
        # The cold start is one re-cluster; the drift must trigger another.
        inv["drift_engaged"] = sum(1 for r in records if r.get("recluster")) >= 2
    if spec.mesh is not None:
        # Every record carries the mesh stamp at the requested shard count
        # and a re-cluster ran on it: a mesh that fell back to one device
        # fails here instead of passing its other checks vacuously.
        ndev = int(np.prod([int(v) for v in spec.mesh.values()]))
        inv["mesh_engaged"] = bool(
            records
            and all((r.get("mesh") or {}).get("devices") == ndev for r in records)
            and any(r.get("recluster") for r in records))
    if spec.placement != "materialized":
        # Every record carries the mode's stamp, a functional fault run its
        # exception count: a placement that fell back fails here.
        inv["functional_engaged"] = bool(
            records
            and all((r.get("placement") or {}).get("mode") == spec.placement for r in records)
            and (spec.faults is None or spec.placement != "functional"
                 or all("exceptions" in (r.get("placement") or {}) for r in records)))
    integ = [r for r in records if r.get("integrity")]
    if integ:
        inv["zero_silent_loss"] = integ[-1]["integrity"]["true_lost"] == 0
        if spec.scrub is not None:
            inv["rot_cleaned"] = integ[-1]["integrity"]["corrupt_copies"] == 0
    if has_corrupt:
        rotted = any(int(r["integrity"].get("corrupt_copies", 0)) > 0 for r in integ)
        detected = sum(int(r["integrity"].get(k, 0)) for r in integ
                       for k in ("detected_scrub", "detected_read", "detected_repair"))
        inv["corruption_engaged"] = rotted or detected > 0
    if has_ec:
        # Some window installed and accounted a stripe (a drift cell may
        # legitimately end with none).
        st = [r for r in records if r.get("storage")]
        inv["ec_engaged"] = bool(st) and any(
            r["storage"]["ec_files"] > 0
            and r["storage"]["bytes_stored"] > r["storage"]["bytes_raw"] for r in st)
    if max_bytes is not None:
        slack = budget_slack if integ else 0
        inv["budget_conserved"] = all(
            r.get("repair_bytes", 0) + r["bytes_migrated"]
            + (r.get("scrub") or {}).get("bytes", 0)
            + (r.get("elastic") or {}).get("rebalance_bytes", 0) <= max_bytes + slack
            for r in records)
    if multi_domain and dur:
        inv["domain_diversity"] = dur[-1]["durability"].get("correlated_risk", 0) == 0
    if spec.alerts is not None:
        fired = alerts_fired if alerts_fired is not None else set()
        expect = set(spec.alerts.get("expect") or ())
        inv["alerts_expected"] = expect <= fired
        forbid = spec.alerts.get("forbid")
        if forbid == "others":
            inv["alerts_silent"] = not (fired - expect)
        elif forbid:
            inv["alerts_silent"] = not (fired & set(forbid))
    if spec.serve is not None:
        served = _served_windows(records)
        inv["serve_engaged"] = sum(int(r.get("reads_routed", 0)) for r in served) > 0
        if served:
            last = served[-1]
            p99 = last.get("latency_p99_ms")
            # A final window that routed nothing has no latency sample: an
            # SLO failure, not a vacuous pass.
            ok = p99 is not None and np.isfinite(p99)
            bound = spec.serve.get("p99_max_ms")
            if ok and bound is not None:
                ok = p99 <= float(bound)
            inv["slo_p99"] = bool(ok)
            inv["slo_no_unavailable_final"] = last.get("reads_unavailable", 0) == 0
            burn_max = spec.serve.get("burn_max")
            if burn_max is not None:
                inv["slo_burn"] = last.get("slo_burn", 0.0) <= float(burn_max)
    return inv


def _daemon_invariants(spec: ScenarioSpec, manifest: Manifest, schedule, events: EventLog,
                       batch_records: list[dict], device) -> dict:
    """The daemon axis: the cell's stream through the streaming daemon over a
    binary log, with the live HTTP plane attached to the full run."""
    import urllib.request

    from ..daemon import DaemonConfig, StreamDaemon
    from ..obs import prom
    from ..obs.httpz import ObsServer

    inv: dict[str, bool] = {}
    with tempfile.TemporaryDirectory() as td:
        log = os.path.join(td, "events.cdrsb")
        events.write_binary(log, manifest)
        metrics = os.path.join(td, "daemon.jsonl")
        full = StreamDaemon(_controller(spec, manifest, schedule, device))
        with ObsServer() as srv:
            full.attach_http(srv)
            dig = full.run(log, metrics_path=metrics)

            def scrape(path: str) -> str:
                with urllib.request.urlopen(srv.url + path, timeout=5) as r:
                    return r.read().decode("utf-8")

            snap = srv.snapshot
            text = scrape("/metrics")
            statusz = json.loads(scrape("/statusz"))
            trace = json.loads(scrape("/debug/trace"))
            inv["endpoint_engaged"] = bool(
                prom.lint(text) == []
                and snap.seq == snap.windows_processed == snap.epochs_published
                == dig["windows_processed"] >= 2
                and statusz["seq"] == snap.seq
                and statusz["events_ingested"] == dig["events_ingested"]
                and trace["traceEvents"])
        inv["daemon_engaged"] = dig["epochs_published"] >= 2
        inv["daemon_decisions_identical"] = _strip(full.records) == _strip(batch_records)
        with open(metrics) as f:
            traces = [e for e in map(json.loads, f) if e.get("kind") == "decision_trace"]
        inv["trace_engaged"] = (len(traces) == dig["windows_processed"]
                                and dig["windows_processed"] >= 2)
        inv["trace_reconciled"] = bool(traces) and all(
            sum(int(v) for v in t["segments_ns"].values()) == int(t["total_ns"])
            for t in traces)

        ep = full.publisher.pin()
        ctl = full.controller
        pinned = (ep is not None and not ep.rf.flags.writeable
                  and not ep.category_idx.flags.writeable
                  and np.array_equal(ep.rf, ctl.current_rf)
                  and np.array_equal(ep.category_idx, ctl.current_cat))
        if pinned:
            pids = np.arange(min(64, len(manifest)))
            rv = ep.read_view(pids)
            pinned = rv.replica_map.shape[0] == len(pids) and rv.replica_map.shape[1] >= 1
        inv["daemon_epoch_pinned"] = bool(pinned)

        # Stop after about half the windows through the flag the SIGTERM
        # handler sets, then resume: the stitch must be exact.
        ck = os.path.join(td, "daemon.npz")
        a = StreamDaemon(_controller(spec, manifest, schedule, device),
                         DaemonConfig(max_windows=max(2, int(spec.n_windows) // 2)))
        a.run(log, checkpoint_path=ck)
        b = StreamDaemon(_controller(spec, manifest, schedule, device))
        b.run(log, checkpoint_path=ck)
        bep = b.publisher.pin()
        inv["daemon_resume_bit_identical"] = bool(
            _strip(a.records) + _strip(b.records) == _strip(full.records)
            and ep is not None and bep is not None and bep.epoch_id == ep.epoch_id
            and np.array_equal(bep.rf, ep.rf)
            and np.array_equal(bep.category_idx, ep.category_idx))
    return inv


#: Durability tiers a cell can enter, one coverage bit each.
_COVERAGE_TIERS = ("lost", "at_risk", "under_replicated", "unreachable", "correlated_risk")
#: Repair outcome and deferral branches (window-record counters > 0).
_COVERAGE_REPAIR = ("repair_failed", "repair_rebalanced", "repair_corrupt_sources",
                    "repair_deferred_budget", "repair_deferred_backoff",
                    "repair_deferred_no_source", "repair_deferred_no_target",
                    "repair_deferred_partition")


def coverage_bits(records: list[dict], inv: dict, alerts_fired: set) -> list[str]:
    """The behaviour the run showed, as sorted bits: ``fault:<kind>``
    applied, ``tier:<name>`` entered (``true_lost`` included),
    ``repair:<branch>`` taken, ``integrity:detected_*``, ``scrub:*``,
    ``recluster:<trigger>``, ``serve:unavailable`` and ``serve:hotspot``,
    ``cause:<name>`` charged, ``alert:<name>`` fired and ``inv:<name>``
    evaluated.  (The reference's ``degraded:kernel_fallback`` has no
    counterpart: a failed re-cluster stops the port's run.)"""
    bits: set[str] = set()
    for r in records:
        for ev in r.get("fault_events") or ():
            bits.add("fault:" + str(ev).split(":", 1)[0])
        d = r.get("durability")
        if d:
            bits.update("tier:" + tier for tier in _COVERAGE_TIERS if d.get(tier, 0))
        integ = r.get("integrity")
        if integ:
            if integ.get("true_lost", 0):
                bits.add("tier:true_lost")
            bits.update("integrity:" + k for k in ("detected_scrub", "detected_read",
                                                    "detected_repair") if integ.get(k, 0))
        bits.update("repair:" + k[len("repair_"):] for k in _COVERAGE_REPAIR if r.get(k, 0))
        sc = r.get("scrub")
        if sc:
            if sc.get("corrupt_found", 0):
                bits.add("scrub:detected")
            if sc.get("starved"):
                bits.add("scrub:starved")
        if r.get("recluster"):
            bits.add("recluster:" + str(r.get("recluster_trigger")))
        if int(r.get("reads_unavailable", 0) or 0):
            bits.add("serve:unavailable")
        if r.get("hotspot_files"):
            bits.add("serve:hotspot")
        bits.update("cause:" + cause for cause in r.get("causes") or ())
    bits.update("alert:" + a for a in alerts_fired)
    bits.update("inv:" + k for k in inv)
    return sorted(bits)


def repro_line(spec: ScenarioSpec, suite: str | None = None, suite_seed: int = 0) -> str:
    """One command that reruns exactly this cell (a suite cell names the
    suite seed: a random cell is a function of it)."""
    head = "python -m cdrs_tpu_torch scenarios run"
    if suite:
        return f"{head} --suite {suite} --seed {int(suite_seed)} --cell {spec.name}"
    if getattr(spec, "_preset", None):
        return f"{head} --preset {spec._preset}"
    return f"{head} --spec '" + json.dumps(spec.to_dict()) + "'"


def run_cell(spec: ScenarioSpec, *, suite: str | None = None, suite_seed: int = 0,
             device=None) -> dict:
    """Run one cell end to end on ``device``; returns the cell record
    (invariants, headline metrics, coverage bits and their fingerprint,
    bench records, repro line)."""
    t0 = time.perf_counter()
    manifest = generate_population(GeneratorConfig(n_files=spec.n_files, seed=spec.seed,
                                                   nodes=spec.nodes))
    events, changed = build_events(spec, manifest)
    schedule = build_schedule(spec)
    ctl = _controller(spec, manifest, schedule, device)
    max_bytes = ctl.cfg.max_bytes_per_window
    res = ctl.run(events)
    records = res.records

    multi_domain = bool((spec.racks or spec.topology is not None) and ctl.cfg.topology
                        and len(set(ctl.cfg.topology.domains)) > 1)
    has_corrupt = schedule is not None and any(ev.kind == "corrupt" for ev in schedule)
    has_ec = ctl._storage is not None and bool((np.asarray(ctl._storage.ec_k) > 0).any())
    # One verified boundary task's worst-case charge: every copy of the
    # largest file read through the slowest straggler the schedule installs.
    budget_slack = 0
    if has_corrupt:
        min_factor = min([float(ev.factor) for ev in schedule if ev.kind == "degrade"]
                         + [1.0])
        budget_slack = int(len(spec.nodes) * int(np.max(np.asarray(manifest.size_bytes)))
                           / min_factor)
    alerts_fired = {r["name"] for r in evaluate_records(records) if r["fired"]}
    inv = _check_invariants(spec, records, max_bytes, budget_slack, multi_domain,
                            has_corrupt, has_ec, schedule=schedule, alerts_fired=alerts_fired)
    if spec.daemon:
        inv.update(_daemon_invariants(spec, manifest, schedule, events, records, device))
    if spec.resume_window is not None:
        with tempfile.TemporaryDirectory() as td:
            ck = os.path.join(td, "cell.npz")
            a = _controller(spec, manifest, schedule, device).run(
                events, checkpoint_path=ck, max_windows=int(spec.resume_window))
            b = _controller(spec, manifest, schedule, device).run(events, checkpoint_path=ck)
            inv["resume_bit_identical"] = bool(
                _strip(a.records) + _strip(b.records) == _strip(records)
                and np.array_equal(b.rf, res.rf)
                and np.array_equal(b.category_idx, res.category_idx))

    summary = res.summary()
    churn = int(summary["bytes_migrated"]
                + summary.get("durability", {}).get("repair_bytes_total", 0))
    metrics: dict = {
        "windows": summary["windows"],
        "events": summary["events"],
        "reclusters": summary["reclusters"],
        "bytes_migrated_total": summary["bytes_migrated"],
        "churn_bytes_total": churn,
        "plan_hash": summary["final_plan_hash"],
        "files_changed_planted": int(changed.sum()),
    }
    if "durability" in summary:
        d = summary["durability"]
        metrics.update({k: d[k] for k in ("repair_bytes_total", "files_lost_max",
                                          "lost_final", "unavailable_reads")})
    metrics["alerts_fired"] = sorted(alerts_fired)
    served = _served_windows(records)
    if served:
        metrics["latency_p99_ms_final"] = served[-1].get("latency_p99_ms")
    if "integrity" in summary:
        metrics["true_lost_final"] = summary["integrity"]["true_lost_final"]
        metrics["corrupt_copies_final"] = summary["integrity"]["corrupt_copies_final"]
    bench_records = [{"metric": f"scenario_{spec.name}_churn_bytes", "value": float(churn),
                      "unit": "bytes", "direction": "lower", "backend": "torch"}]
    if served and metrics.get("latency_p99_ms_final") is not None:
        bench_records.append({"metric": f"scenario_{spec.name}_p99_ms",
                              "value": float(metrics["latency_p99_ms_final"]), "unit": "ms",
                              "backend": "torch"})
    coverage = coverage_bits(records, inv, alerts_fired)
    return {
        "cell": spec.name,
        "seed": spec.seed,
        "spec": spec.to_dict(),
        "invariants": inv,
        "ok": all(inv.values()),
        "metrics": metrics,
        "coverage": coverage,
        "fingerprint": coverage_fingerprint(coverage),
        "bench_records": bench_records,
        "seconds": round(time.perf_counter() - t0, 3),
        "repro": repro_line(spec, suite, suite_seed),
    }
