"""Named scenario cells and sweep suites: ``cdrs_tpu/scenarios/presets.py``.

The same presets, random cells and suites, in the same order, so that
``suite_cells(suite, seed)`` equals the reference's spec for spec:

* **presets** — hand-written cells: ``control-shift`` and ``chaos-kill``
  re-express the legacy control and chaos benches; the rest cover failure
  domains and partitions, fault templates, storage, serving, integrity,
  the mesh and functional placement, geo topologies, the streaming daemon
  and the workload curves and drift patterns;
* **random cells** (``random_cell``) — seeded compositions over all axes,
  deterministic in (suite seed, index).

Every cell runs on the port (the mesh cell ``scale-mesh`` since ROADMAP
A9).
"""

from __future__ import annotations

import numpy as np

from .spec import ScenarioSpec

__all__ = ["PRESETS", "SUITES", "preset", "random_cell", "suite_cells"]

_RACKS6 = "r0=dn1,dn2;r1=dn3,dn4;r2=dn5,dn6"
_NODES6 = ("dn1", "dn2", "dn3", "dn4", "dn5", "dn6")
_NODES12 = tuple(f"dn{i}" for i in range(1, 13))
_RACKS12 = ("r0=dn1,dn2,dn3;r1=dn4,dn5,dn6;"
            "r2=dn7,dn8,dn9;r3=dn10,dn11,dn12")
#: Geo hierarchy: 3 regions x 2 racks x 2 nodes, WAN edges priced
#: (cross-region copies cost 4x budget bytes, reads +8x service time).
_GEO_TOPOLOGY = {
    "nodes": list(_NODES12),
    "levels": ["rack", "region"],
    "rack": {f"r{j}": [f"dn{2 * j + 1}", f"dn{2 * j + 2}"]
             for j in range(6)},
    "region": {"eu": ["r0", "r1"], "us": ["r2", "r3"],
               "ap": ["r4", "r5"]},
    "edge_bytes": {"rack": 1.0, "region": 4.0},
    "edge_latency": {"rack": 1.5, "region": 8.0},
}
#: Region-local Archival stripes: ec(2,1) pinned to the primary's
#: region (zero WAN bytes for cold data; a WAN partition STRANDS these
#: — the stranded != lost scenario), everything else replicates spread.
_GEO_LOCAL_STORAGE = {
    "strategies": {"Archival": {"k": 2, "m": 1, "tier": "cold",
                                "locality": "region"}}}



def _alerts(expect, forbid=("files_lost", "true_lost")) -> dict:
    """Alert expectations of a designed-bad cell: ``expect`` must fire,
    ``forbid`` must stay silent ("others" = everything outside
    ``expect``).  Defaults forbid the loss alerts — a preset whose
    faults are designed to heal must never actually lose data."""
    return {"expect": list(expect),
            "forbid": forbid if forbid == "others" else list(forbid)}

def _presets() -> dict[str, ScenarioSpec]:
    p: dict[str, ScenarioSpec] = {}

    # -- legacy benches re-expressed (pinned-artifact reproduction) --------
    p["control-shift"] = ScenarioSpec(
        name="control-shift", n_files=300, seed=7, duration=2400.0,
        n_windows=20, k=12, nodes=("dn1", "dn2", "dn3"),
        drift={"kind": "flip", "at_frac": 0.5},
        scoring="validated", default_rf=1, decay=0.7,
        drift_threshold=0.02, budget_frac=0.30)
    p["chaos-kill"] = ScenarioSpec(
        name="chaos-kill", n_files=400, seed=11, duration=1800.0,
        n_windows=15, k=12,
        faults={"specs": ["crash:dn2@6"]}, resume_window=8,
        alerts=_alerts(["durability_degraded"]))

    # -- failure domains / partitions (chaos_rack_bench lineage) -----------
    p["rack-kill"] = ScenarioSpec(
        name="rack-kill", n_files=400, seed=13, duration=1800.0,
        n_windows=15, k=12, nodes=_NODES6, racks=_RACKS6,
        faults={"specs": ["crash:dn3@5", "crash:dn4@5"]},
        alerts=_alerts(["durability_degraded", "repair_backlog"]))
    p["rack-partition"] = ScenarioSpec(
        name="rack-partition", n_files=400, seed=13, duration=1800.0,
        n_windows=15, k=12, nodes=_NODES6, racks=_RACKS6,
        faults={"specs": ["partition:dn3+dn4@4-6",
                          "degrade:dn5@4-6:0.25"]},
        resume_window=6,
        alerts=_alerts(["durability_degraded", "repair_backlog"]))

    # -- fault templates ---------------------------------------------------
    p["cascade"] = ScenarioSpec(
        name="cascade", n_files=300, seed=3, duration=1800.0,
        n_windows=15, k=12,
        faults={"template": "cascade", "nodes": ["dn2", "dn3"],
                "start": 4, "spacing": 2, "recover_after": 3},
        alerts=_alerts(["durability_degraded"]))
    p["rolling-decommission"] = ScenarioSpec(
        name="rolling-decommission", n_files=300, seed=4,
        duration=1800.0, n_windows=15, k=12, nodes=_NODES6,
        faults={"template": "rolling_decommission",
                "nodes": ["dn2", "dn3"], "start": 4, "spacing": 4},
        alerts=_alerts(["durability_degraded"]))

    # -- storage strategies (storage_bench lineage) ------------------------
    p["storage-ec"] = ScenarioSpec(
        name="storage-ec", n_files=400, seed=13, duration=1800.0,
        n_windows=15, k=12, nodes=_NODES12, racks=_RACKS12,
        storage="ec_archival",
        faults={"specs": ["crash:dn4@5", "crash:dn5@5", "crash:dn6@5"]},
        alerts=_alerts(["durability_degraded"]))

    # -- serving / SLO -----------------------------------------------------
    p["serve-chaos"] = ScenarioSpec(
        name="serve-chaos", n_files=300, seed=5, duration=1800.0,
        n_windows=15, k=12,
        serve={"policy": "p2c", "p99_max_ms": 50.0, "burn_max": 1.0},
        faults={"specs": ["partition:dn2@4-7", "degrade:dn3@4-7:0.25"]},
        alerts=_alerts(["durability_degraded", "repair_backlog", "budget_saturated"]))
    p["flash-crowd"] = ScenarioSpec(
        name="flash-crowd", n_files=300, seed=6, duration=1800.0,
        n_windows=15, k=12,
        workload={"kind": "flash_crowd", "start_frac": 0.5,
                  "duration_frac": 0.1, "boost": 40.0,
                  "cohort": "archival"},
        serve={"policy": "p2c", "p99_max_ms": 50.0},
        alerts=_alerts([], "others"))
    # A sustained crowd on the HOT cohort against an undersized service
    # budget and no elastic rescue: the SLO burn-rate pair (fast AND
    # slow) must fire while the crowd holds and resolve when it lifts —
    # the alerting regression suite's designed-bad SLO cell (flash-crowd
    # above stays the hotspot-feedback cell and must stay SILENT: its
    # archival burst re-clusters without ever touching the error
    # budget).
    p["slo-burn"] = ScenarioSpec(
        name="slo-burn", n_files=300, seed=24, duration=1800.0,
        n_windows=15, k=12,
        workload={"kind": "flash_crowd", "start_frac": 0.25,
                  "duration_frac": 0.3, "boost": 40.0, "cohort": "hot"},
        serve={"policy": "p2c", "service_ms": 6.0, "slo_ms": 60.0,
               "p99_max_ms": 60.0},
        alerts=_alerts(["slo_burn_fast", "slo_burn_slow"]))

    # -- data integrity (integrity_bench lineage) --------------------------
    p["integrity-scrub"] = ScenarioSpec(
        name="integrity-scrub", n_files=300, seed=9, duration=1800.0,
        n_windows=15, k=12,
        faults={"specs": ["corrupt:dn2@3:0.5"]},
        scrub=200_000_000, resume_window=7,
        alerts=_alerts(["corruption_detected", "scrub_starved",
                        "durability_degraded", "budget_saturated"],
                       ["true_lost"]))
    p["integrity-read"] = ScenarioSpec(
        name="integrity-read", n_files=300, seed=9, duration=1800.0,
        n_windows=15, k=12,
        faults={"specs": ["corrupt:dn2@3:0.5"]},
        serve={"policy": "p2c", "verify_reads": True},
        alerts=_alerts(["corruption_detected"], ["true_lost"]))

    # -- scale: mesh-sharded control loop ----------------------------------
    # The whole per-window device computation (cluster step, scoring
    # medians, feature fold, drift one-Lloyd-step) data-parallel over an
    # 8-device mesh, with a mid-cell kill/resume (mesh shape is a runtime
    # choice, not checkpoint state) and the mesh_engaged positive check.
    # On the port the eight shards share the one device a run is given
    # (parallel/mesh.py's placement rule).
    p["scale-mesh"] = ScenarioSpec(
        name="scale-mesh", n_files=300, seed=8, duration=1800.0,
        n_windows=12, k=12, backend="jax", mesh={"data": 8},
        drift={"kind": "flip", "at_frac": 0.5}, drift_threshold=0.02,
        resume_window=7,
        alerts=_alerts([], "others"))

    # -- scale: functional placement ---------------------------------------
    # A drift flip under --placement functional: the CRUSH-style hash
    # chooser with exception-overlay checkpoints and a fault in the way
    # (repair retargets ARE the exceptions), gated on the
    # functional_engaged positive check plus a mid-cell kill/resume —
    # the sparse-snapshot round trip must be bit-identical.
    p["scale-placement"] = ScenarioSpec(
        name="scale-placement", n_files=400, seed=14, duration=1800.0,
        n_windows=15, k=12, nodes=_NODES6, racks=_RACKS6,
        placement="functional",
        drift={"kind": "flip", "at_frac": 0.5}, drift_threshold=0.02,
        faults={"specs": ["crash:dn3@6-9"]},
        serve={"policy": "p2c"}, resume_window=8,
        alerts=_alerts(["durability_degraded"]))

    # -- geo hierarchy: region loss / WAN partition / elasticity -----------
    # Kill a whole REGION (4 of 12 nodes, correlated): hierarchy-aware
    # placement spreads every file's copies across regions — replicate
    # rf>=2 and the spread EC(6,3) stripes (shards (3,3,3) per region;
    # 6 = k survive) both ride it out with ZERO loss, where the same
    # workload on a racks-only topology measurably loses files (the
    # contrast is pinned by tests/test_geo.py and benchmarks/geo_bench).
    # Functional placement + mid-cell kill/resume: the sparse overlay
    # snapshot must restore the region outage bit-identically.
    p["region-loss"] = ScenarioSpec(
        name="region-loss", n_files=400, seed=21, duration=1800.0,
        n_windows=15, k=12, nodes=_NODES12, topology=_GEO_TOPOLOGY,
        placement="functional", storage="ec_archival",
        faults={"specs": ["crash:region:eu@5-9"]},
        serve={"policy": "p2c"}, resume_window=7,
        alerts=_alerts(["durability_degraded", "repair_backlog", "budget_saturated"]))
    # Partition region eu off the WAN: its region-LOCAL Archival
    # stripes strand (unreachable > 0) but are never lost, repairs
    # STALL on them (partition backoff) instead of burning budget on
    # doomed WAN copies, and the heal converges every level's
    # correlated risk back to zero.
    p["wan-partition"] = ScenarioSpec(
        name="wan-partition", n_files=400, seed=22, duration=1800.0,
        n_windows=15, k=12, nodes=_NODES12, topology=_GEO_TOPOLOGY,
        placement="functional", storage=_GEO_LOCAL_STORAGE,
        faults={"specs": ["partition:region:eu@4-7"]},
        serve={"policy": "p2c"},
        alerts=_alerts(["durability_degraded", "reads_unavailable",
                        "repair_backlog", "unreachable_stranded",
                        "slo_burn_fast", "slo_burn_slow"]))
    # Black Friday: a flash crowd on the hot cohort saturates the
    # 3-node baseline; sustained SLO burn activates the standby pool
    # (capacity doubles), the addition-pruned epoch diff rebalances
    # inside the shared churn budget, p99 recovers within the SloSpec
    # bound by the final window, and the cool-down drains capacity back
    # to baseline via rolling decommission.  Kill/resume crosses the
    # scale-out boundary (grown-topology checkpoint restore).
    p["black-friday"] = ScenarioSpec(
        name="black-friday", n_files=300, seed=23, duration=1800.0,
        n_windows=15, k=12, placement="functional",
        workload={"kind": "flash_crowd", "start_frac": 0.25,
                  "duration_frac": 0.3, "boost": 25.0, "cohort": "hot"},
        serve={"policy": "p2c", "service_ms": 6.0, "slo_ms": 60.0,
               "p99_max_ms": 60.0},
        # burn_hot sits WELL inside the crowd/off-crowd separation
        # (burn ~0 quiet, >= 0.6 under the crowd on every suite seed):
        # the trigger must be decisive, not a coin flip at the
        # threshold.
        elastic={"pool": ["sb1", "sb2", "sb3"], "burn_hot": 0.4,
                 "util_hot": 0.9, "hot_windows": 2, "util_cool": 0.5,
                 "cool_windows": 2, "drain_spacing": 1},
        resume_window=8,
        alerts=_alerts(["durability_degraded"]))

    # -- streaming daemon --------------------------------------------------
    # The always-on controller daemon (daemon/core.py) over a seeded
    # live feed: the cell's events land in a binary event log the daemon
    # tails, with a mid-stream category flip (the drift axis) and one
    # node killed under it (the fault axis).  Gated on the daemon
    # invariants — >= 2 epochs published (daemon_engaged), decisions
    # bit-identical to the windowed batch run, the pinned epoch frozen
    # and read-resolving, and SIGTERM-flag stop/checkpoint/resume
    # stitching bit-identical — on top of the usual zero-loss and
    # budget-conservation gates.
    p["daemon-stream"] = ScenarioSpec(
        name="daemon-stream", n_files=300, seed=17, duration=1800.0,
        n_windows=15, k=12, daemon=True,
        drift={"kind": "flip", "at_frac": 0.5}, drift_threshold=0.02,
        faults={"specs": ["crash:dn2@8"]},
        alerts=_alerts(["durability_degraded"]))

    # -- workload curves / drift patterns ----------------------------------
    p["diurnal"] = ScenarioSpec(
        name="diurnal", n_files=300, seed=10, duration=1800.0,
        n_windows=15, k=12,
        workload={"kind": "diurnal", "amplitude": 0.8},
        serve={"policy": "p2c", "p99_max_ms": 50.0},
        faults={"specs": ["crash:dn2@5-8"]},
        alerts=_alerts(["durability_degraded"]))
    p["adversarial-drift"] = ScenarioSpec(
        name="adversarial-drift", n_files=300, seed=11, duration=2400.0,
        n_windows=20, k=12, decay=0.7, drift_threshold=0.02,
        drift={"kind": "adversarial", "cycles": 3,
               "start_frac": 0.3, "end_frac": 0.8},
        alerts=_alerts([], "others"))
    p["gradual-drift"] = ScenarioSpec(
        name="gradual-drift", n_files=300, seed=12, duration=2400.0,
        n_windows=20, k=12, decay=0.7, drift_threshold=0.02,
        drift={"kind": "gradual", "steps": 3,
               "start_frac": 0.3, "end_frac": 0.7},
        alerts=_alerts([], "others"))

    for name, spec in p.items():
        # Generated cells own these namespaces (random_cell,
        # scenarios/search.py): a preset named into them would alias
        # the generated cells' scenario_<name>_* history/regress keys.
        if name.startswith(("random-", "search-")):
            raise ValueError(
                f"preset {name!r} uses a reserved generated-cell "
                f"name prefix")
        spec._preset = name
    return p


PRESETS: dict[str, ScenarioSpec] = _presets()


def preset(name: str) -> ScenarioSpec:
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r} (have {sorted(PRESETS)})")
    return PRESETS[name]


def random_cell(index: int, seed: int = 0) -> ScenarioSpec:
    """A seeded random cell composing all axes (deterministic in
    ``(seed, index)``).  Draws stay inside the invariant-satisfiable
    region by construction: random faults are crash/flaky/straggler
    spans confined to the first ~60% of windows (data is never
    destroyed and every node is back before the run ends), budgets stay
    at the standard quarter-of-population per window."""
    rng = np.random.default_rng([int(seed), int(index)])
    n_windows = 12
    wl_kind = ("poisson", "diurnal", "flash_crowd")[int(rng.integers(3))]
    workload: dict = {"kind": wl_kind}
    if wl_kind == "diurnal":
        workload.update(amplitude=float(rng.uniform(0.4, 0.9)),
                        phase=float(rng.uniform(0.0, 6.28)))
    elif wl_kind == "flash_crowd":
        workload.update(start_frac=float(rng.uniform(0.3, 0.6)),
                        duration_frac=0.1,
                        boost=float(rng.uniform(20.0, 60.0)))
    drift = None
    if wl_kind == "poisson" and rng.random() < 0.7:
        drift = {"kind": ("flip", "gradual",
                          "adversarial")[int(rng.integers(3))]}
    racked = bool(rng.random() < 0.5)
    faults = {"random": {
        "n_windows": 7, "seed": int(rng.integers(2**31)),
        "crash_rate": 0.08, "recover_windows": [1, 2],
        "flaky_rate": 0.05, "degrade_rate": 0.05,
    }}
    serve = None
    if rng.random() < 0.5:
        serve = {"policy": ("p2c", "least_loaded",
                            "random")[int(rng.integers(3))]}
    storage = "replicate" if rng.random() < 0.3 else None
    # The name carries the suite seed: the cell IS a function of
    # (seed, index), so its history/regress metric keys
    # (scenario_random-s<seed>-<i>_*) must never alias a different
    # seed's scenario, and a repro with a mismatched --seed fails the
    # cell lookup instead of silently running something else.
    return ScenarioSpec(
        name=f"random-s{seed}-{index}",
        n_files=int(rng.integers(200, 400)),
        seed=int(rng.integers(1000)),
        duration=1440.0, n_windows=n_windows, k=10,
        nodes=_NODES6 if racked else ("dn1", "dn2", "dn3", "dn4", "dn5"),
        racks=_RACKS6 if racked else None,
        workload=workload, drift=drift, faults=faults,
        serve=serve, storage=storage)


#: Suite name -> (preset names, number of random cells).
SUITES: dict[str, tuple[tuple[str, ...], int]] = {
    # The CI matrix: every legacy smoke domain (chaos, partition, serve,
    # storage, integrity) plus the new curves/templates, and two random
    # compositions.  >= 12 cells.
    "ci-smoke": (("chaos-kill", "rack-kill", "rack-partition", "cascade",
                  "rolling-decommission", "storage-ec", "serve-chaos",
                  "flash-crowd", "slo-burn", "integrity-scrub",
                  "integrity-read", "diurnal", "adversarial-drift",
                  "gradual-drift", "scale-mesh", "scale-placement",
                  "region-loss", "wan-partition", "black-friday",
                  "daemon-stream"), 2),
    # Everything, including the slow legacy-reproduction preset.
    "full": (tuple(PRESETS), 4),
}


def suite_cells(suite: str, seed: int = 0) -> list[ScenarioSpec]:
    """The suite's cell list (deterministic in ``seed``).

    ``seed`` parameterizes the whole matrix, not just the random cells:
    a non-zero suite seed SHIFTS every preset cell's workload seed
    (``spec.seed + suite seed``) so a 3-seed CI loop re-checks the
    invariants against three different workloads per preset — the
    multi-seed "not a single-seed accident" dimension — instead of
    re-running 13 byte-identical cells.  Seed 0 keeps the presets'
    pinned workloads (the per-cell history baseline keys, and the
    control-shift/chaos-kill artifact reproduction) untouched."""
    if suite not in SUITES:
        raise KeyError(f"unknown suite {suite!r} (have {sorted(SUITES)})")
    names, n_random = SUITES[suite]
    cells = []
    for n in names:
        sp = preset(n)
        if seed:
            shifted = sp.replace(seed=sp.seed + int(seed))
            shifted._preset = n
            sp = shifted
        cells.append(sp)
    cells += [random_cell(i, seed) for i in range(n_random)]
    return cells
