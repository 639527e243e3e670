"""Elastic capacity: node add/drain driven by serve-layer telemetry (a copy of
``cdrs_tpu/control/elastic.py``).

The serve layer already measures the two signals an autoscaler needs —
per-window SLO burn (error-budget consumption) and peak node utilization
(serve/router.py) — and the functional placement engine already answers
the hard rebalance question ("who moves when capacity changes?") as an
epoch diff (placement_fn/epoch.py).  ``ElasticPolicy`` closes the loop:

* **scale-out** — after ``hot_windows`` consecutive windows whose burn
  or utilization crosses the hot thresholds, the standby ``pool``
  activates: the topology GROWS (appended nodes, hierarchy domains
  declared per pool entry), and the files that must move are exactly
  the addition-pruned epoch diff (``placement_fn.addition_moved`` — the
  hash-twice moved set, nobody else's computed row changes).  The moved
  set drains as a **budgeted rebalance queue**: each window, after
  repairs pre-charge the shared churn budget, queued files retarget to
  their new computed rows while the remaining byte allowance lasts — so
  flash-crowd rebalancing competes for the SAME per-window churn
  allowance as repair and drift-migration traffic instead of stacking a
  second budget.
* **drain** — once the crowd passes (``cool_windows`` consecutive cool
  windows, rebalance queue empty), the added nodes decommission on a
  rolling schedule (``drain_spacing`` windows apart — exactly the
  ``rolling_decommission`` fleet-drain shape), and the ordinary repair
  machinery re-replicates their data back onto the baseline fleet under
  the same budget.  Capacity returns to baseline; zero loss is the
  invariant, not a hope.

Scale-out requires a hash placement mode (``functional`` /
``materialized_hash``): only the stateless chooser can answer the moved
set without materializing two full maps.  Every decision is a pure
function of the window records and the policy, so kill/resume replays
identically (the counters, active set, queue and drain schedule ride
the controller checkpoint).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["ElasticPolicy"]


@dataclass(frozen=True)
class ElasticPolicy:
    """Autoscaling knobs + the standby pool (see module docstring).

    ``pool`` entries are ``{"name": node, "domains": [base domain,
    level-1 domain, ...]}`` — one domain per hierarchy level, finest
    first, naming where the standby node racks when it activates.  For
    a flat topology (no ``domains``) entries may be plain name strings.
    Activation order is pool order; a scale-out activates the whole
    remaining pool (the "capacity doubles" posture) unless
    ``add_count`` limits it.  The pool is ONE-SHOT per run: drained
    nodes are decommissioned, never re-activated — a later crowd with
    the pool consumed stamps ``pool_exhausted`` on the elastic record
    instead of silently doing nothing.
    """

    pool: tuple = ()
    #: A window is HOT when its SLO burn exceeds ``burn_hot`` OR its
    #: peak node utilization exceeds ``util_hot``.
    burn_hot: float = 1.0
    util_hot: float = 0.95
    #: Consecutive hot windows before scale-out fires.
    hot_windows: int = 2
    #: A window is COOL when burn stays under ``burn_hot`` AND peak
    #: utilization under ``util_cool``.
    util_cool: float = 0.4
    #: Consecutive cool windows (queue drained) before the drain
    #: schedule is laid down.
    cool_windows: int = 3
    #: Windows between successive drain decommissions
    #: (``rolling_decommission`` spacing).
    drain_spacing: int = 2
    #: Nodes activated per scale-out; 0 = the whole remaining pool.
    add_count: int = 0

    def __post_init__(self):
        norm = []
        for e in self.pool:
            if isinstance(e, str):
                e = {"name": e, "domains": []}
            if not isinstance(e, dict) or "name" not in e:
                raise ValueError(
                    f"elastic pool entry {e!r} must be a node name or a "
                    f"{{'name': ..., 'domains': [...]}} dict")
            unknown = set(e) - {"name", "domains"}
            if unknown:
                raise ValueError(
                    f"elastic pool entry {e['name']!r}: unknown keys "
                    f"{sorted(unknown)}")
            norm.append({"name": str(e["name"]),
                         "domains": tuple(str(d)
                                          for d in e.get("domains", ()))})
        names = [e["name"] for e in norm]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise ValueError(f"duplicate elastic pool nodes: {dupes}")
        object.__setattr__(self, "pool", tuple(norm))
        if not self.pool:
            raise ValueError("elastic policy needs a non-empty pool")
        for label, v in (("burn_hot", self.burn_hot),
                         ("util_hot", self.util_hot),
                         ("util_cool", self.util_cool)):
            if v <= 0:
                raise ValueError(f"elastic {label} must be > 0, got {v}")
        if self.hot_windows < 1 or self.cool_windows < 1:
            raise ValueError(
                "elastic hot_windows/cool_windows must be >= 1")
        if self.drain_spacing < 1:
            raise ValueError(
                f"elastic drain_spacing must be >= 1, got "
                f"{self.drain_spacing}")
        if self.add_count < 0:
            raise ValueError(
                f"elastic add_count must be >= 0, got {self.add_count}")

    # -- spec round trip ----------------------------------------------------
    @classmethod
    def from_dict(cls, d: dict) -> "ElasticPolicy":
        allowed = {"pool", "burn_hot", "util_hot", "hot_windows",
                   "util_cool", "cool_windows", "drain_spacing",
                   "add_count"}
        unknown = sorted(set(d) - allowed)
        if unknown:
            raise ValueError(f"unknown elastic policy keys: {unknown}")
        kw = dict(d)
        if "pool" in kw:
            kw["pool"] = tuple(kw["pool"])
        return cls(**kw)

    def to_dict(self) -> dict:
        return {
            "pool": [{"name": e["name"],
                      "domains": list(e["domains"])}
                     for e in self.pool],
            "burn_hot": self.burn_hot, "util_hot": self.util_hot,
            "hot_windows": self.hot_windows,
            "util_cool": self.util_cool,
            "cool_windows": self.cool_windows,
            "drain_spacing": self.drain_spacing,
            "add_count": self.add_count,
        }

    # -- topology growth ----------------------------------------------------
    def validate_against(self, topology) -> None:
        """Fail fast at controller construction: every pool entry must
        declare one domain per hierarchy level of the topology it will
        join (or none, for a flat topology), and must not collide with
        an existing node name."""
        want = (0 if not topology.domains
                else getattr(topology, "n_levels", 0) + 1)
        for e in self.pool:
            if e["name"] in topology.nodes:
                raise ValueError(
                    f"elastic pool node {e['name']!r} already exists in "
                    f"the topology")
            if len(e["domains"]) != want:
                raise ValueError(
                    f"elastic pool node {e['name']!r} declares "
                    f"{len(e['domains'])} domains for a topology with "
                    f"{want} hierarchy levels "
                    f"({tuple(topology.level_names) if want else '(flat)'}"
                    f") — one per level, finest first")

    def grown_topology(self, base, names):
        """``base`` with the named pool nodes APPENDED (activation
        order), each racked into the domains its pool entry declares —
        the strict-prefix growth ``ClusterState.grow`` and
        ``addition_moved`` require."""
        from ..cluster.placement import ClusterTopology

        chosen = [e for e in self.pool if e["name"] in set(names)]
        nodes = tuple(base.nodes) + tuple(e["name"] for e in chosen)
        domains = tuple(base.domains)
        if domains:
            domains = domains + tuple(e["domains"][0] for e in chosen)
        levels = tuple(
            (nm, tuple(doms) + tuple(e["domains"][i + 1]
                                     for e in chosen))
            for i, (nm, doms) in enumerate(base.levels))
        return ClusterTopology(
            nodes=nodes, domains=domains, levels=levels,
            edge_bytes=base.edge_bytes, edge_latency=base.edge_latency,
            domain_level_name=base.domain_level_name)

    def next_activation(self, active) -> tuple[str, ...]:
        """Pool names the next scale-out activates (pool order, minus
        the already-active set, capped by ``add_count``)."""
        remaining = [e["name"] for e in self.pool
                     if e["name"] not in set(active)]
        if self.add_count:
            remaining = remaining[:self.add_count]
        return tuple(remaining)


@dataclass
class _ElasticRuntime:
    """Mutable controller-side autoscaler state (rides the checkpoint)."""

    policy: ElasticPolicy
    hot: int = 0
    cool: int = 0
    active: tuple = ()
    #: Files still awaiting their post-growth rebalance (epoch-diff
    #: moved set, drained under the shared churn budget).
    queue: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    moved_total: int = 0
    #: Pending rolling-drain decommissions: [(window, node), ...].
    drains: list = field(default_factory=list)
    scaled: bool = False
    #: Previous window's (slo_burn, utilization_max) — the decision
    #: inputs (a scale decision at window w reads window w-1's serving).
    last_burn: float | None = None
    last_util: float | None = None
