"""Declarative scenario cells: ``cdrs_tpu/scenarios/spec.py``.

A ``ScenarioSpec`` names one point of the robustness matrix — workload
curve x drift pattern x fault schedule x topology x storage strategy x
scale x serve config — as plain JSON-able fields, so a spec round-trips
through ``to_dict``/``from_dict`` (a failing cell's repro line reruns
exactly that cell).  Every field of the reference's spec is here, so any
of its repro lines or corpus cells parses; the port's harness
(scenarios/harness.py) refuses, before anything runs, a cell that needs
an axis the port does not have yet (a mesh).

Axes
----
* ``workload`` — ``{"kind": "poisson"}``, ``{"kind": "diurnal",
  "amplitude", "period_frac", "phase"}`` (sim/access.simulate_diurnal) or
  ``{"kind": "flash_crowd", "start_frac", "duration_frac", "boost",
  "cohort"}`` (sim/access.simulate_flash_crowd).
* ``drift`` — ``flip`` (one category flip), ``gradual`` (the cohort moves
  in waves) or ``adversarial`` (the flip oscillates); poisson only
  (sim/access.simulate_access_phased).
* ``faults`` — ``specs`` (faults/schedule spec strings), a ``template``
  (``cascade``, ``rolling_decommission``) and ``random`` (the seeded
  generator), merged into one window-keyed schedule.
* ``racks`` / ``topology`` — the failure-domain topology (rack spec string
  or hierarchy dict); None = flat.
* ``storage``, ``serve``, ``elastic``, ``placement``, ``mesh`` — carried
  and validated as in the reference.
* ``scrub`` — scrubber bytes a window; ``alerts`` — ``{"expect": [...],
  "forbid": [...] | "others"}`` over obs/alerts.py's default rules.
* scale — ``n_files`` / ``duration`` / ``n_windows`` / ``k``.
* ``resume_window`` — kill/resume bit-identity check after that window;
  ``daemon`` — run the stream through the streaming daemon as well.

Controller knobs (budget fraction, scoring table, decay, thresholds) ride
along.  ``backend`` rides along too and validates as in the reference (a
mesh requires "jax"); the port's harness always runs its own controller.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field

__all__ = ["ScenarioSpec"]

_WORKLOAD_KINDS = ("poisson", "diurnal", "flash_crowd")
_DRIFT_KINDS = ("flip", "gradual", "adversarial")
_SCORINGS = ("default", "validated", "min_rf2")


@dataclass
class ScenarioSpec:
    """One matrix cell (see module docstring for the axes)."""

    name: str
    # -- scale -------------------------------------------------------------
    n_files: int = 300
    seed: int = 0
    duration: float = 1800.0
    n_windows: int = 15
    k: int = 12
    nodes: tuple[str, ...] = ("dn1", "dn2", "dn3", "dn4", "dn5")
    #: Device mesh for the per-window device computation
    #: (ControllerConfig.mesh_shape); requires ``backend == "jax"``.
    mesh: dict | None = None
    # -- axes --------------------------------------------------------------
    workload: dict = field(default_factory=lambda: {"kind": "poisson"})
    drift: dict | None = None
    faults: dict | None = None
    racks: str | None = None
    #: Geo-hierarchical topology spec (the ``ClusterTopology.
    #: from_hierarchy`` dict: levels, per-level group maps, optional
    #: edge_bytes/edge_latency multipliers).  Mutually exclusive with
    #: ``racks``; fault specs may then use domain scopes
    #: (``crash:region:eu@5-9``).
    topology: dict | None = None
    #: ``replicate`` / ``ec_archival`` / JSON path, or an inline
    #: StorageConfig dict (storage_config_from_dict — the form that can
    #: carry per-category ``locality`` rules).
    storage: str | dict | None = None
    serve: dict | None = None
    scrub: int | None = None
    #: Alerting expectations (obs/alerts.py, default ruleset):
    #: ``{"expect": [names...], "forbid": [names...] | "others"}`` — the
    #: named alerts must FIRE during the cell (``alerts_expected``
    #: invariant) and the forbidden ones must stay silent
    #: (``alerts_silent``); ``"forbid": "others"`` means any alert
    #: outside ``expect`` failing silent fails the cell.  None = no
    #: alert gating (e.g. random cells, whose transient fault storms
    #: legitimately trip loss alerts that heal by the end).
    alerts: dict | None = None
    #: Elastic capacity (control/elastic.ElasticPolicy dict: standby
    #: pool + hot/cool thresholds).  Requires ``serve`` (the telemetry
    #: source) and a hash ``placement`` mode (the epoch-diff rebalance).
    elastic: dict | None = None
    # -- controller knobs --------------------------------------------------
    #: Per-window churn budget as a fraction of the population's total
    #: bytes (None = unbounded) — repair + migration + scrub share it.
    budget_frac: float | None = 0.25
    max_files: int | None = None
    default_rf: int = 2
    scoring: str = "min_rf2"
    decay: float = 1.0
    drift_threshold: float = 0.05
    full_recluster_drift: float = 0.30
    hysteresis: int = 1
    backend: str = "numpy"
    #: Placement representation (ControllerConfig.placement_mode):
    #: "materialized" (historical), "functional" (CRUSH-style hash
    #: chooser + exception-overlay checkpoints + on-the-fly serve
    #: resolution), or "materialized_hash" (the equivalence oracle).
    placement: str = "materialized"
    #: Mid-cell kill/resume bit-identity check: kill after this window and
    #: resume from the checkpoint, asserting the stitched record stream
    #: equals the uninterrupted run's.  None = not sampled for this cell.
    resume_window: int | None = None
    #: Streaming-daemon axis: run the cell's event stream through the
    #: always-on controller daemon (daemon/core.StreamDaemon) tailing a
    #: binary event log, and gate the daemon invariants — decisions
    #: bit-identical to the windowed batch run, >= 2 placement epochs
    #: published (``daemon_engaged``), the pinned epoch frozen and equal
    #: to the admitted plan, and SIGTERM-path stop/checkpoint/resume
    #: stitching bit-identical to the uninterrupted daemon run.
    daemon: bool = False

    def __post_init__(self):
        kind = (self.workload or {}).get("kind", "poisson")
        if kind not in _WORKLOAD_KINDS:
            raise ValueError(
                f"cell {self.name!r}: unknown workload kind {kind!r} "
                f"(want one of {_WORKLOAD_KINDS})")
        if self.drift is not None:
            dk = self.drift.get("kind")
            if dk not in _DRIFT_KINDS:
                raise ValueError(
                    f"cell {self.name!r}: unknown drift kind {dk!r} "
                    f"(want one of {_DRIFT_KINDS})")
            if kind != "poisson":
                raise ValueError(
                    f"cell {self.name!r}: drift patterns compose with the "
                    f"poisson workload only (got workload {kind!r})")
        if self.scoring not in _SCORINGS:
            raise ValueError(
                f"cell {self.name!r}: unknown scoring {self.scoring!r} "
                f"(want one of {_SCORINGS})")
        if self.n_windows < 1:
            raise ValueError(
                f"cell {self.name!r}: n_windows must be >= 1")
        if self.budget_frac is not None and self.budget_frac <= 0:
            raise ValueError(
                f"cell {self.name!r}: budget_frac must be > 0 or None")
        if self.scrub is not None and self.faults is None:
            raise ValueError(
                f"cell {self.name!r}: scrub requires a faults axis (the "
                f"scrubber verifies the fault path's cluster state)")
        if self.placement not in ("materialized", "functional",
                                  "materialized_hash"):
            raise ValueError(
                f"cell {self.name!r}: unknown placement "
                f"{self.placement!r} (want 'materialized', 'functional' "
                f"or 'materialized_hash')")
        if self.topology is not None:
            if self.racks is not None:
                raise ValueError(
                    f"cell {self.name!r}: topology and racks are "
                    f"mutually exclusive (the hierarchy spec subsumes "
                    f"the rack map)")
            if not isinstance(self.topology, dict):
                raise ValueError(
                    f"cell {self.name!r}: topology must be a hierarchy "
                    f"spec dict (ClusterTopology.from_hierarchy)")
            from ..cluster.placement import ClusterTopology

            try:
                topo = ClusterTopology.from_hierarchy(self.topology)
            except ValueError as e:
                raise ValueError(
                    f"cell {self.name!r}: bad topology spec: {e}"
                ) from None
            if set(topo.nodes) != set(self.nodes):
                raise ValueError(
                    f"cell {self.name!r}: topology nodes "
                    f"{sorted(topo.nodes)} != cell nodes "
                    f"{sorted(self.nodes)}")
        if self.elastic is not None:
            if self.serve is None:
                raise ValueError(
                    f"cell {self.name!r}: elastic requires a serve axis "
                    f"(the SLO-burn/utilization telemetry that drives "
                    f"the scale decisions)")
            if self.placement == "materialized":
                raise ValueError(
                    f"cell {self.name!r}: elastic requires a hash "
                    f"placement mode ('functional'/'materialized_hash')"
                    f" — scale-out rebalances by epoch diff")
        if self.alerts is not None:
            from ..obs.alerts import DEFAULT_RULE_NAMES

            unknown_keys = set(self.alerts) - {"expect", "forbid"}
            if unknown_keys:
                raise ValueError(
                    f"cell {self.name!r}: unknown alerts keys "
                    f"{sorted(unknown_keys)} (want 'expect'/'forbid')")
            names = list(self.alerts.get("expect") or [])
            forbid = self.alerts.get("forbid")
            if forbid != "others":
                names += list(forbid or [])
            bad = sorted(set(names) - DEFAULT_RULE_NAMES)
            if bad:
                raise ValueError(
                    f"cell {self.name!r}: unknown alert names {bad} "
                    f"(known: {sorted(DEFAULT_RULE_NAMES)})")
        if self.mesh is not None:
            # The reference's checks; the port's harness refuses a mesh
            # cell before it runs (ROADMAP A9).
            unknown = set(self.mesh) - {"data", "model"}
            if unknown:
                raise ValueError(
                    f"cell {self.name!r}: unknown mesh axis "
                    f"{sorted(unknown)} (want 'data'/'model')")
            if any(int(v) < 1 for v in self.mesh.values()):
                raise ValueError(
                    f"cell {self.name!r}: mesh axis sizes must be >= 1, "
                    f"got {self.mesh}")
            if self.backend != "jax":
                raise ValueError(
                    f"cell {self.name!r}: a mesh axis requires "
                    f"backend 'jax' (got {self.backend!r})")

    @property
    def window_seconds(self) -> float:
        return float(self.duration) / int(self.n_windows)

    # -- JSON round trip (the repro contract) ------------------------------
    def to_dict(self) -> dict:
        """Spec as plain JSON, omitting fields that equal their DEFAULT
        (not fields that are None: ``budget_frac=None`` means an
        unbounded budget and must survive the round trip — dropping
        Nones would silently rebuild a budgeted cell from a repro
        line).  ``from_dict`` refills omitted fields with the same
        defaults, so the round trip is exact for every field."""
        out: dict = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name != "name":
                if f.default is not dataclasses.MISSING \
                        and v == f.default:
                    continue
                if f.default_factory is not dataclasses.MISSING \
                        and v == f.default_factory():
                    continue
            if f.name == "nodes":
                v = list(v)
            elif isinstance(v, dict):
                v = copy.deepcopy(v)  # never hand out live axis dicts
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - allowed
        if unknown:
            raise ValueError(
                f"unknown scenario spec keys: {sorted(unknown)}")
        kwargs = dict(d)
        if "nodes" in kwargs:
            kwargs["nodes"] = tuple(kwargs["nodes"])
        return cls(**kwargs)

    def replace(self, **kw) -> "ScenarioSpec":
        return dataclasses.replace(self, **kw)
