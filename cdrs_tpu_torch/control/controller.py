"""Online replication controller: the port of ``cdrs_tpu/control/controller.py``
with the semantics of its jax backend (decay 1) and of its numpy backend's
decayed counters (decay below 1).

Per time window (``control/windows.py``):

1. **fold** — the window's events fold into the streaming feature counters
   on the device (``features/streaming.stream_update``; exact cumulative
   fold, cross-window concurrency carry).  With ``decay`` below 1 each
   window folds into a fresh exact state instead, whose four counters merge
   into float64 accumulators on the device: multiply by the decay, then add
   (two element-wise ops, never a fused multiply-add, so the values are
   bit-equal to the reference's numpy ``*=`` then ``+=``); ``conc_max``
   merges by a decayed max, and an empty window only decays.
2. **drift** — the host oracle ``control/drift.detect_drift`` scores one
   host copy of the float32 feature snapshot against the last accepted
   model; below ``drift_threshold`` nothing else runs.  The decayed
   snapshot is finalized on the host in float64 with the reference's
   ``finalize_counters`` formula, then cast to float32.  On a mesh
   (``mesh_shape``) drift runs on the device instead, one Lloyd-kernel
   launch a data shard (``detect_drift_torch(mesh_shape=)``), as the
   reference's mesh runs use ``detect_drift_jax``.
3. **re-cluster** — the cold start, or on drift a warm re-cluster (the
   accepted centroids as init, ``warm_max_iter`` Lloyd iterations) or,
   from ``full_recluster_drift`` on, a full one with a fresh init:
   ``ReplicationPolicyModel.run`` on the device-resident float32 snapshot,
   so every Lloyd iteration and the label pass launch the Lloyd kernel and
   the bisection medians (at scale) the threshold-count kernel.  With
   ``serve`` a fired hotspot (``serve/hotspot.py``, scored on the window's
   per-file read counts right after the fold) triggers the re-cluster too;
   drift keeps the trigger's name when both fire.
4. **faults, repair, scrub** (with a ``fault_schedule``) — the window's
   fault events mutate the ``faults.ClusterState`` (placed at construction
   on ``topology``, flat by default); the ``RepairScheduler`` re-replicates
   under the window's byte and file budgets, then the ``Scrubber`` (with
   ``scrub``) verifies copies with what is left of the byte budget.
5. **diff + schedule** — the new plan is diffed against the applied one
   (``control/migrate.plan_diff``; priority = scoring margin of the new
   category over the applied one) and metered out by the
   ``MigrationScheduler`` with what repairs and scrub left of the budgets;
   on the fault path each admitted move applies through
   ``ClusterState.apply_rf_target``.  With ``storage`` (a
   ``storage.StorageConfig``) a category's target is its strategy's shard
   count (rf, or k + m for an EC stripe), a move between strategy shapes is
   a re-encode charged as the new shards written (cause ``conversion``) and
   applied through ``ClusterState.apply_strategy_target``, which defers
   while the file is unreadable; each window first retries the deferred
   ones (``storage_conversions_retried``) and repairs them toward their
   installed form.
6. **evaluate** — the window's events replay against the placements before
   and after the window's moves (``cluster/evaluate``): the flat rng
   placement of the applied rf vector, or the reachable copies of the
   ``ClusterState``.  The fault path records the durability tiers, the
   reads refused (``unavailable_reads``) and, when corruption can happen
   or is looked for, the ``integrity`` digest.  With ``storage`` the
   record gains ``storage``: stored and raw bytes, overhead, cost units,
   EC files, bytes per tier and per category, billed at the installed
   encoding (``_installed_cat``).
7. **serve** (with ``serve``) — after repairs, scrub and migrations the
   window's reads route through ``serve/router.ReadRouter`` against the
   live ``ClusterState`` or the static placement of the applied rf vector
   (less a seeded ``serve_shed`` fraction under the daemon's brownout);
   the record gains the latency percentiles, SLO burn and hotspot fields,
   and rotten copies the reads detect are quarantined and hinted to the
   scrubber (``integrity.detected_read``).  With ``storage`` a read pays
   its tier's stretch, an EC read whose primary shard is down pays the
   k-shard gather, and a stripe below k reachable shards serves nothing.
   Routing is host numpy.

**Placement modes** (``placement_mode``): ``"materialized"`` places by the
seeded rng chooser over a dense ``ClusterState``; ``"functional"`` by the
stateless hash chooser (``placement_fn.compute``) over the
``OverlayClusterState``, which holds no ``(n_files, n_nodes)`` map: its
checkpoint stores the rows that differ from the computed base, and
without faults each window's reads resolve only their own files' rows
(``_fn_static_rows``); ``"materialized_hash"`` is the same chooser and
retarget policy over a dense state and dense snapshots, the oracle a
functional run must equal.  Hash modes stamp each record's ``placement``
(mode, epoch, and in functional mode the exception count).

**Elasticity** (``elastic``, an ``ElasticPolicy``; needs ``serve`` and a
hash mode, and turns the fault path on with an empty schedule): each
window's scale step reads the last window's SLO burn and utilization;
sustained heat activates the standby pool (the topology grows, and the
addition-pruned epoch diff becomes a rebalance queue that drains after
repairs on the same churn budget), sustained cool decommissions the added
nodes one by one, and repairs carry their data back.

Every window gives one record with the reference's keys (among them
``drift``, ``recluster_mode``, ``moves_applied``, ``fault_events``,
``repair_moves``, ``durability``, ``scrub``, ``integrity``, the serving
fields, locality and balance before and after, ``plan_hash`` and the
per-stage ``seconds``), kept in memory and appended to an optional JSONL
sink.  The whole state (counters or decayed accumulators, accepted model,
applied plan, backlog with its move causes, cluster state, repair backlog,
scrub cursor, hotspot baseline) snapshots through
``utils/checkpoint``; kill and resume reproduce the uninterrupted run
bit for bit.  ``run`` holds the loop inside ``device.deterministic()``.

Departures from the reference:

* No degraded mode: the reference moves a failed jax re-cluster to its
  numpy backend (``_degraded_recluster``); here a failure of
  ``model.run`` propagates out of ``run`` and nothing moves to the CPU.
* Decayed runs cluster the float32 snapshot, where the reference's numpy
  backend clusters in float64; the accumulators and the float64 table are
  the reference's bit for bit.
* ``mesh_shape`` runs the fold, drift and the re-cluster on a mesh of
  shards (``parallel/mesh.py``), and every window record carries the
  reference's ``mesh`` stamp (shard count, collective bytes an
  iteration).  A mesh needs decay 1 (the reference's mesh runs are its jax
  backend, whose fold has no decayed counterpart).  Mesh shape is a
  runtime choice, not checkpoint state.
* Without a degraded mode there is nothing to count as
  ``degraded.kernel_fallback`` or ``degraded.checkpoint_fallback``: the
  port's window telemetry has neither counter.

**Telemetry** (``obs/``): with an active instrument every window goes
through ``_instrument_window``, the reference's: the controller, migrate,
planner, mesh, fault, durability, repair, scrub, integrity and
``storage.*`` counters and gauges, the ``serve.*`` emission of
``serve/router.emit_window_telemetry``, one ``lineage`` event per admitted
batch, the per-stage ``controller.<stage>.seconds`` histograms, and
(unless ``Telemetry(audit=False)``) the decision-quality audit of
``obs/audit.py``.  Under the daemon's trace (``_trace_id``) each measured
stage also lands as a ``controller.<stage>`` span.  ``run(metrics_path=)``
writes its window records into the instrument's own sink when both name
the same file: one stream, one writer.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..cluster.evaluate import _client_to_topology, evaluate_placement
from ..cluster.placement import ClusterTopology, place_replicas, place_stripes, \
    primary_on_topology
from ..cluster.plan import PlanEntry
from ..config import CATEGORIES, KMeansConfig, ScoringConfig
from ..device import deterministic, resolve_device
from ..faults import ClusterState, FaultSchedule, RepairScheduler, Scrubber
from ..features.streaming import StreamFeatureState, stream_finalize, stream_init, stream_update
from ..io.events import EventLog, Manifest
from ..models.replication import ReplicationPolicyModel
from ..obs import current as _obs_current
from ..obs.aggregate import integrity_digest, pacing_digest, serve_digest, storage_digest
from ..obs.sink import JsonlSink
from ..parallel.mesh import collective_bytes_estimate, validate_mesh_shape
from ..placement_fn.compute import compute_placement
from ..placement_fn.epoch import addition_moved
from ..placement_fn.state import FunctionalClusterState, OverlayClusterState
from ..serve import HotspotDetector, ReadRouter, emit_window_telemetry, read_view
from ..utils.checkpoint import CheckpointError, load_state, save_state
from .drift import detect_drift, detect_drift_torch
from .elastic import _ElasticRuntime
from .migrate import MigrationScheduler, plan_diff
from .windows import _slice, iter_windows

__all__ = ["ControllerConfig", "ControllerResult", "ReplicationController",
           "finalize_counters", "MOVE_CAUSES", "LINEAGE_ID_CAP"]

#: File ids listed in one ``lineage`` event (the counts stay exact).
LINEAGE_ID_CAP = 4096

#: Why an admitted migration happened: the code rides the per-file
#: ``_move_cause`` vector from plan submission to admission (and the
#: checkpoint); 0 is a backlog resumed from a snapshot without causes, 3 a
#: storage re-encode.  Repairs, spread rebalances, the epoch diff and the
#: elastic rebalance are tagged where they run.
MOVE_CAUSES = {0: "unknown", 1: "drift", 2: "hotspot", 3: "conversion"}

#: The decayed counters, in the reference's order.
_DEC_KEYS = ("access_freq", "writes", "local_acc", "conc_max")


@dataclass
class ControllerConfig:
    """Knobs of the control loop, with the reference's defaults."""

    window_seconds: float = 60.0
    #: Drift score (max of centroid-shift RMS and category TV distance) at or
    #: above which a re-cluster runs.
    drift_threshold: float = 0.05
    #: Drift at or above which the re-cluster drops the warm start.
    full_recluster_drift: float = 0.30
    #: Lloyd budget of a warm re-cluster.
    warm_max_iter: int = 25
    #: Per-window churn budget, shared by repairs, scrub and migrations
    #: (None = unbounded).
    max_bytes_per_window: int | None = None
    max_files_per_window: int | None = None
    #: Windows a migrated file stays frozen after a move.
    hysteresis_windows: int = 1
    #: Per-window counter decay in (0, 1]; 1.0 is the exact cumulative fold.
    decay: float = 1.0
    #: rf of every file before the first accepted plan.
    default_rf: int = 1
    kmeans: KMeansConfig = field(default_factory=lambda: KMeansConfig(k=8))
    scoring: ScoringConfig = field(default_factory=ScoringConfig)
    #: Replay each window's events against the placements before and after
    #: its moves.
    evaluate: bool = True
    #: ``faults.FaultSchedule``: node events keyed to window indices.  Turns
    #: on the mutable cluster state, durability accounting and repairs.
    fault_schedule: object | None = None
    #: Seed of the stateless flaky-copy failure rolls.
    repair_seed: int = 0
    #: ``cluster.placement.ClusterTopology`` of the fault path (racks or a
    #: geo hierarchy); None = flat.  Its nodes must be the manifest's.
    topology: object | None = None
    #: ``faults.ScrubConfig`` of the background scrubber (fault path only).
    scrub: object | None = None
    #: Run window t+1's fold, drift and re-cluster before window t's planning;
    #: decision-identical to the serial order, suspended around checkpoints.
    #: The re-cluster here returns host arrays, so this only reorders work.
    overlap_windows: bool = False
    #: torch device of the feature fold and the re-cluster: CUDA when None
    #: (raises without CUDA), or "cpu".
    device: str | None = None
    #: ``serve.ServeConfig``: route every window's reads and feed hotspots
    #: back into the re-cluster trigger (None = no read path).
    serve: object | None = None
    #: ``storage.StorageConfig``: category -> replicate(rf) or ec(k, m) on a
    #: tier; shard counts become the targets (None = the scoring rf table).
    #: A replicate-only config gives the records of no storage bit for bit,
    #: plus the ``storage`` record.
    storage: object | None = None
    #: ``control.elastic.ElasticPolicy``: scale out on sustained SLO burn or
    #: utilization, drain back on sustained cool (needs ``serve`` and a hash
    #: placement mode; implies the fault path).
    elastic: object | None = None
    #: "materialized" (rng chooser, dense state), "functional" (hash
    #: chooser, overlay state, sparse checkpoints) or "materialized_hash"
    #: (hash chooser, dense state: the functional mode's oracle).
    placement_mode: str = "materialized"
    mesh_shape: dict | None = None

    def __post_init__(self):
        if self.window_seconds <= 0:
            raise ValueError(f"window_seconds must be > 0, got {self.window_seconds}")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")
        if self.drift_threshold < 0 or self.full_recluster_drift < 0:
            raise ValueError("drift thresholds must be >= 0")
        if self.scrub is not None and self.fault_schedule is None:
            raise ValueError("scrub requires a fault_schedule (the scrubber verifies the "
                             "mutable ClusterState the fault path maintains)")
        if self.placement_mode not in ("materialized", "functional", "materialized_hash"):
            raise ValueError(f"unknown placement_mode {self.placement_mode!r} (want "
                             f"'materialized', 'functional' or 'materialized_hash')")
        if self.elastic is not None:
            if self.serve is None:
                raise ValueError("elastic requires serve (the SLO-burn/utilization "
                                 "telemetry that drives the scale decisions)")
            if self.placement_mode == "materialized":
                raise ValueError("elastic scale-out requires a hash placement mode "
                                 "('functional' or 'materialized_hash'): the rebalance plan "
                                 "is the addition-pruned epoch diff, which only the "
                                 "stateless chooser can answer")
        if self.mesh_shape is not None:
            # The decay check first: a decayed mesh config must fail with
            # the real reason before the axes are looked at.
            if self.decay < 1.0:
                raise ValueError(
                    "mesh_shape requires decay 1.0 (the reference's mesh runs its jax "
                    "backend, whose fold has no decayed counters; drop mesh_shape or "
                    "the decay)")
            self.mesh_shape = validate_mesh_shape(self.mesh_shape)


@dataclass
class ControllerResult:
    """Final applied plan and the per-window records."""

    records: list[dict]
    rf: np.ndarray             # (n,) applied replication factor per file
    category_idx: np.ndarray   # (n,) applied category index, -1 = unplanned
    manifest: Manifest
    #: One {window, bytes, seconds} per checkpoint save.
    checkpoints: list = field(default_factory=list)

    def plan_entries(self):
        """The applied plan as ``cluster/plan.PlanEntry`` rows."""
        return [PlanEntry(p, CATEGORIES[int(c)] if c >= 0 else "Unplanned", int(r))
                for p, c, r in zip(self.manifest.paths, self.category_idx, self.rf)]

    def summary(self) -> dict:
        """The reference's summary keys for a run without the unported
        subsystems: with a fault schedule a ``durability`` block, with
        serving a ``serve`` block, with storage a ``storage`` block, and
        with corruption or a scrubber an ``integrity`` block."""
        recl = [r for r in self.records if r["recluster"]]
        out = {
            "windows": len(self.records),
            "events": int(sum(r["n_events"] for r in self.records)),
            "reclusters": len(recl),
            "full_reclusters": sum(1 for r in recl if r["recluster_mode"] == "full"),
            "moves_applied": int(sum(r["moves_applied"] for r in self.records)),
            "bytes_migrated": int(sum(r["bytes_migrated"] for r in self.records)),
            # From the applied plan: a resumed run that processed no new
            # window still reports it.
            "final_plan_hash": _plan_hash(self.rf, self.category_idx),
        }
        pacing = pacing_digest(self.records)
        if pacing:
            out["windows_per_sec"] = round(pacing["windows_per_sec"], 3)
            if "plan_seconds_fraction" in pacing:
                out["plan_seconds_fraction"] = round(pacing["plan_seconds_fraction"], 4)
        dur = [r for r in self.records if r.get("durability")]
        if dur:
            out["durability"] = _durability_digest(self.records, dur, out["events"])
        if self.checkpoints:
            last = self.checkpoints[-1]
            out["checkpoint"] = {"saves": len(self.checkpoints),
                                 "bytes_last": int(last["bytes"]),
                                 "save_seconds_last": float(last["seconds"])}
        serve = serve_digest(self.records)
        if serve is not None:
            out["serve"] = serve
        storage = storage_digest(self.records)
        if storage is not None:
            out["storage"] = storage
        integrity = integrity_digest(self.records)
        if integrity is not None:
            out["integrity"] = integrity
        return out


def _durability_digest(records: list[dict], dur: list[dict], n_events: int) -> dict:
    """The summary's ``durability`` block: fault events, the worst and final
    tiers, repair totals and unavailable reads (per read, or per event for
    records without ``n_reads``)."""
    last = dur[-1]["durability"]

    def total(key):
        return int(sum(r.get(key, 0) for r in records))

    out = {
        "fault_events": sum(len(r.get("fault_events") or ()) for r in records),
        "files_lost_max": max(r["durability"]["lost"] for r in dur),
        "unreachable_max": max(r["durability"].get("unreachable", 0) for r in dur),
        "correlated_risk_max": max(r["durability"].get("correlated_risk", 0) for r in dur),
        "lost_final": last["lost"],
        "at_risk_final": last["at_risk"],
        "under_replicated_final": last["under_replicated"],
        "unreachable_final": last.get("unreachable", 0),
        "correlated_risk_final": last.get("correlated_risk", 0),
        "nodes_up_final": last["nodes_up"],
        "repair_moves_total": total("repair_moves"),
        "repair_bytes_total": total("repair_bytes"),
        "repair_failed_total": total("repair_failed"),
        "repair_rebalanced_total": total("repair_rebalanced"),
        "partition_stalled_repairs": total("repair_deferred_partition"),
        "unavailable_reads": total("unavailable_reads"),
    }
    denom = sum(int(r.get("n_reads", 0)) for r in records) or n_events
    out["unavailable_read_fraction"] = out["unavailable_reads"] / denom if denom else 0.0
    return out


def _plan_hash(rf: np.ndarray, cat: np.ndarray) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(np.ascontiguousarray(rf, dtype=np.int32).tobytes())
    h.update(np.ascontiguousarray(cat, dtype=np.int32).tobytes())
    return h.hexdigest()


def _minmax_normalize(col: np.ndarray) -> np.ndarray:
    lo, hi = float(col.min()), float(col.max())
    if hi == lo:
        return np.zeros_like(col, dtype=np.float64)
    return (col - lo) / (hi - lo)


def finalize_counters(access_freq, writes, local_acc, concurrency, manifest: Manifest,
                      observation_end: float | None) -> tuple[np.ndarray, np.ndarray]:
    """``(raw, norm)``, the (n, 5) float64 features and their min-max norms
    from (decayed) counters: the formula of
    ``cdrs_tpu/features/streaming_np.py``'s ``finalize_counters``, bit for
    bit (numpy's pairwise mean included)."""
    n = len(manifest)
    if observation_end is None:
        observation_end = time.time()
    access_freq = np.asarray(access_freq, dtype=np.float64)
    writes = np.asarray(writes, dtype=np.float64)
    local_acc = np.asarray(local_acc, dtype=np.float64)
    concurrency = np.asarray(concurrency, dtype=np.float64)
    locality = np.where(access_freq > 0, local_acc / np.maximum(access_freq, 1.0), 1.0)
    age_seconds = observation_end - manifest.creation_ts
    mean_writes = float(writes.mean()) if n else 0.0
    if mean_writes == 0:
        mean_writes = 1.0
    raw = np.stack([access_freq, age_seconds, writes / mean_writes, locality, concurrency],
                   axis=1)
    norm = np.stack([_minmax_normalize(raw[:, j]) for j in range(raw.shape[1])], axis=1)
    return raw, norm


class ReplicationController:
    """Drives the window loop over one population (see the module docstring)."""

    #: Counter fields of the streaming state that checkpoints hold.
    _STATE_ARRAYS = ("access_freq", "writes", "local_acc", "conc_max", "last_sec",
                     "last_count")

    def __init__(self, manifest: Manifest, cfg: ControllerConfig):
        n = len(manifest)
        if n < cfg.kmeans.k:
            raise ValueError(f"{n} files < k={cfg.kmeans.k}; cannot control this population")
        self.manifest = manifest
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self._sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
        self._state = stream_init(n, self.device)
        #: Decayed float64 counters on the device (decay < 1 only).
        self._dec: dict[str, torch.Tensor] | None = None
        self._dec_obs_end: float | None = None
        if cfg.decay < 1.0:
            self._dec = {k: torch.zeros(n, dtype=torch.float64, device=self.device)
                         for k in _DEC_KEYS}
        self._events_total = 0
        self._model_full = self._make_model(warm=False)
        self._model_warm = self._make_model(warm=True)
        #: The mesh stamp of every window record (mesh runs only): shard
        #: count and the estimated bytes of one psum of the float32
        #: (k, d + 1) Lloyd statistics over the data axis.
        self._mesh_rec = None
        if cfg.mesh_shape is not None:
            payload = int(cfg.kmeans.k) * (len(cfg.scoring.features) + 1) * 4
            self._mesh_rec = {
                "devices": int(np.prod(list(cfg.mesh_shape.values()))),
                "collective_bytes_per_iter": collective_bytes_estimate(
                    payload, int(cfg.mesh_shape.get("data", 1)))}

        self._accepted_centroids: np.ndarray | None = None
        self._accepted_category_idx: np.ndarray | None = None
        self._accepted_fractions: np.ndarray | None = None
        #: Per-file category of the last accepted decision, reused by the
        #: plan diff.
        self._accepted_file_cat: np.ndarray | None = None
        #: The accepted decision not yet turned into the host model arrays.
        self._pending_accept = None

        #: Strategy vectors of ``cfg.storage`` (None: the scoring rf table),
        #: resolved here so a bad strategy fails at construction.
        self._storage = None
        if cfg.storage is not None:
            self._storage = cfg.storage.vectors(CATEGORIES, cfg.scoring.replication_factors)
            # Replicate rf caps at the node count; an EC stripe cannot (below
            # k + m nodes it never reaches full strength).
            n_nodes = len(cfg.topology.nodes) if cfg.topology is not None \
                else len(manifest.nodes)
            sv = self._storage
            for i, c in enumerate(sv.categories):
                if sv.ec_k[i] > 0 and int(sv.n_shards[i]) > n_nodes:
                    raise ValueError(
                        f"storage strategy for category {c!r} needs {int(sv.n_shards[i])} "
                        f"distinct nodes for its EC stripe but the topology has {n_nodes}")

        self.current_rf = np.full(n, int(cfg.default_rf), dtype=np.int32)
        self.current_cat = np.full(n, -1, dtype=np.int32)
        #: Category whose strategy is installed per file: a deferred
        #: conversion keeps the old encoding, which byte billing and read
        #: penalties follow until the re-encode lands.
        self._installed_cat = self.current_cat.copy()
        #: ``MOVE_CAUSES`` code of each file's pending submitted move.
        self._move_cause = np.zeros(n, dtype=np.int8)
        self.scheduler = MigrationScheduler(
            n, max_bytes_per_window=cfg.max_bytes_per_window,
            max_files_per_window=cfg.max_files_per_window,
            hysteresis_windows=cfg.hysteresis_windows)
        self._placement_key: bytes | None = None
        self._placement = None
        #: The hash modes share the stateless chooser.
        self._hash_placement = cfg.placement_mode != "materialized"
        self._placement_method = "hash" if self._hash_placement else "rng"
        #: The fault path (a schedule, or elasticity, which drains and grows
        #: through it): the schedule with its domain scopes resolved, the
        #: mutable cluster state placed from the default rf, the repair
        #: planner and the scrubber.
        self._fault_schedule: FaultSchedule | None = None
        self._cluster_state: ClusterState | None = None
        self._repairs: RepairScheduler | None = None
        self._elastic: _ElasticRuntime | None = None
        if cfg.fault_schedule is not None or cfg.elastic is not None:
            topology = cfg.topology or ClusterTopology(nodes=tuple(manifest.nodes))
            if set(topology.nodes) != set(manifest.nodes):
                raise ValueError(
                    f"topology nodes {tuple(topology.nodes)} != manifest nodes "
                    f"{tuple(manifest.nodes)}: the failure-domain topology must cover "
                    "exactly the manifest's node set")
            schedule = cfg.fault_schedule if cfg.fault_schedule is not None \
                else FaultSchedule(())
            schedule = schedule.expand_domains(topology)
            schedule.validate_nodes(topology.nodes)
            self._fault_schedule = schedule
            if cfg.elastic is not None:
                cfg.elastic.validate_against(topology)
                self._elastic = _ElasticRuntime(cfg.elastic)
            primary = primary_on_topology(manifest.nodes, manifest.primary_node_id, topology)
            if cfg.placement_mode == "functional":
                self._cluster_state = OverlayClusterState.from_base(
                    topology, self._sizes, n_shards=self.current_rf, primary=primary, seed=0)
            elif self._hash_placement:
                self._cluster_state = FunctionalClusterState(
                    place_replicas(manifest, self.current_rf, topology, seed=0,
                                   method="hash"),
                    self._sizes, primary=primary, seed=0, sparse_checkpoint=False)
            else:
                self._cluster_state = ClusterState(
                    place_replicas(manifest, self.current_rf, topology, seed=0), self._sizes)
            self._repairs = RepairScheduler(seed=cfg.repair_seed)
        self._scrub = Scrubber(n, cfg.scrub) if cfg.scrub is not None else None
        #: Integrity records only when corruption can happen or is looked for.
        self._integrity_on = self._cluster_state is not None and (
            self._scrub is not None
            or any(ev.kind == "corrupt" for ev in self._fault_schedule))
        #: The serve plane: router and hotspot detector on the fault path's
        #: topology, else ``cfg.topology``, else flat.  The hotspot EWMA is
        #: its only state.
        self._router: ReadRouter | None = None
        self._hotspot: HotspotDetector | None = None
        self._serve_topology = None
        self._edge_ms: np.ndarray | None = None
        if cfg.serve is not None:
            self._serve_topology = (
                self._cluster_state.topology if self._cluster_state is not None
                else cfg.topology or ClusterTopology(nodes=tuple(manifest.nodes)))
            self._router = ReadRouter(len(self._serve_topology.nodes), cfg.serve)
            self._edge_ms = self._edge_latency_ms(self._serve_topology)
            self._hotspot = HotspotDetector(
                n, alpha=cfg.serve.hotspot_alpha, spike_factor=cfg.serve.hotspot_spike_factor,
                min_reads=cfg.serve.hotspot_min_reads, top_k=cfg.serve.hotspot_top_k)
        #: Primaries on the serve topology, for the functional static resolver.
        self._fn_static_primary: np.ndarray | None = None
        #: One window's (cause, file ids, bytes) batches: the record's ``causes``.
        self._lineage: list[tuple[str, np.ndarray, int]] = []
        #: The window's routed latency samples, for the ``serve.latency_ms``
        #: histogram of its telemetry.
        self._last_latency_ms: np.ndarray | None = None
        #: Decision-quality auditor, made at the first instrumented window.
        self._auditor = None
        #: The daemon's trace id of the window in progress (None outside it).
        self._trace_id: str | None = None
        #: One {window, bytes, seconds} per checkpoint save.
        self.checkpoint_log: list[dict] = []
        self.window_index = 0
        #: Events of the last processed window, so a resume over a grown
        #: (append-only) log folds that window's late tail.
        self._last_window_events = 0
        self._t0: float | None = None
        #: Meta blob of the last snapshot loaded (the daemon reads its
        #: ``extra_meta`` back from here).
        self.last_checkpoint_meta: dict | None = None
        #: Degraded modes and serve shed set by the daemon's brownout ladder.
        #: ``defer_scrub`` skips the window's scrub (cursor and hints hold);
        #: ``serve_shed`` is ``(fraction, seed)`` under ``shed_reads``: a
        #: seeded draw drops that fraction of the window's reads before
        #: routing.
        self.degraded_modes: frozenset = frozenset()
        self.serve_shed: tuple | None = None

    def _make_model(self, warm: bool) -> ReplicationPolicyModel:
        """The full or the warm (``warm_max_iter`` Lloyd budget) model."""
        cfg = self.cfg
        km = dataclasses.replace(cfg.kmeans, max_iter=cfg.warm_max_iter) if warm \
            else cfg.kmeans
        return ReplicationPolicyModel(kmeans_cfg=km, scoring_cfg=cfg.scoring,
                                      mesh_shape=cfg.mesh_shape)

    # -- feature fold ------------------------------------------------------
    def _fold_window(self, events: EventLog, new_window: bool = True) -> None:
        """Fold events into the counters.  ``new_window=False`` marks the
        late tail of an already processed window, which the decayed fold
        merges without decaying again."""
        if self._dec is None:
            self._state = stream_update(self._state, events, self.manifest,
                                        mesh_shape=self.cfg.mesh_shape)
            self._events_total = self._state.n_events
            return
        ws = stream_update(stream_init(len(self.manifest), self.device), events,
                           self.manifest)
        g = self.cfg.decay if new_window else 1.0
        for k in ("access_freq", "writes", "local_acc"):
            # Two ops, in this order: the reference's ``*=`` then ``+=``.
            self._dec[k].mul_(g)
            self._dec[k].add_(getattr(ws, k).to(torch.float64))
        self._dec["conc_max"] = torch.maximum(self._dec["conc_max"] * g,
                                              ws.conc_max.to(torch.float64))
        if ws.observation_end is not None:
            self._dec_obs_end = ws.observation_end if self._dec_obs_end is None \
                else max(self._dec_obs_end, ws.observation_end)
        self._events_total += ws.n_events

    def _feature_snapshot(self) -> torch.Tensor:
        """(n, 5) float32 normalized feature matrix on the device: the
        reference finalizes, then casts to float32 on its jax backend; the
        decayed table is finalized on the host in float64 first."""
        if self._dec is not None:
            _, norm = finalize_counters(*(self._dec[k].cpu().numpy() for k in _DEC_KEYS),
                                        self.manifest, self._dec_obs_end)
            return torch.from_numpy(norm.astype(np.float32)).to(self.device)
        return stream_finalize(self._state, self.manifest).norm.to(torch.float32)

    def decayed_counters(self) -> dict[str, np.ndarray] | None:
        """Host float64 copies of the decayed accumulators (None at decay 1)."""
        if self._dec is None:
            return None
        return {k: v.cpu().numpy() for k, v in self._dec.items()}

    # -- one window --------------------------------------------------------
    def process_window(self, w: int, events: EventLog) -> dict:
        """Phase A (fold, drift, re-cluster) then phase B (planning)."""
        return self._window_phase_b(self._window_phase_a(w, events))

    def _window_phase_a(self, w: int, events: EventLog) -> dict:
        """Fold, drift and (maybe) the re-cluster of window ``w``.  Mutates
        only the feature carry and the pending-accept slot, which phase B
        of the previous window does not read."""
        cfg = self.cfg
        seconds: dict[str, float] = {}
        t_start = time.perf_counter()
        rec: dict = {"window": int(w), "n_events": int(len(events))}
        if self._mesh_rec is not None:
            rec["mesh"] = dict(self._mesh_rec)

        t0 = time.perf_counter()
        if len(events):
            self._fold_window(events)
        elif self._dec is not None:
            for v in self._dec.values():
                v.mul_(cfg.decay)
        if self.device.type == "cuda":   # the fold's kernels count toward it
            torch.cuda.synchronize(self.device)
        seconds["fold"] = time.perf_counter() - t0
        rec["events_total"] = int(self._events_total)

        # Serving: the window's reads, extracted once (routed in phase B),
        # and their per-file counts scored against the hotspot baseline.
        reads = None
        hotspot = None
        if self._router is not None and len(events):
            t0 = time.perf_counter()
            keep = events.path_id >= 0
            is_read = np.asarray(events.op)[keep] == 0
            read_pid = events.path_id[keep][is_read]
            reads = (read_pid, events.ts[keep][is_read],
                     _client_to_topology(events, self._serve_topology)[keep][is_read])
            hotspot = self._hotspot.observe(np.bincount(read_pid, minlength=len(self.manifest)))
            rec["n_reads"] = int(read_pid.shape[0])
            rec["hotspot_score"] = round(hotspot.score, 6)
            rec["hotspot_files"] = list(hotspot.files)
            seconds["hotspot"] = time.perf_counter() - t0

        X = None
        drift = None
        t0 = time.perf_counter()
        self._ensure_accepted()
        if self._accepted_centroids is not None and len(events):
            X = self._feature_snapshot()
            if self._mesh_rec is not None:
                drift = detect_drift_torch(X, self._accepted_centroids,
                                           self._accepted_category_idx,
                                           self._accepted_fractions, len(CATEGORIES),
                                           mesh_shape=cfg.mesh_shape)
            else:
                drift = detect_drift(X.cpu().numpy(), self._accepted_centroids,
                                     self._accepted_category_idx, self._accepted_fractions,
                                     len(CATEGORIES))
        seconds["drift"] = time.perf_counter() - t0
        rec["drift"] = None if drift is None else drift.score
        rec["centroid_shift"] = None if drift is None else drift.centroid_shift
        rec["population_delta"] = None if drift is None else drift.population_delta

        cold = self._accepted_centroids is None and self._events_total > 0
        drift_fire = drift is not None and drift.score >= cfg.drift_threshold
        hot_fire = (hotspot is not None and hotspot.fired and cfg.serve.recluster_on_hotspot
                    and self._accepted_centroids is not None)
        trigger = cold or drift_fire or hot_fire
        rec["recluster"] = bool(trigger)
        rec["recluster_trigger"] = ("cold" if cold else "drift" if drift_fire
                                    else "hotspot" if hot_fire else None)
        rec["recluster_mode"] = None
        rec["plan_moves_pending"] = None
        decision = None
        t0 = time.perf_counter()
        if trigger:
            warm = not cold and drift.score < cfg.full_recluster_drift
            rec["recluster_mode"] = "warm" if warm else "full"
            if X is None:
                X = self._feature_snapshot()
            model = self._model_warm if warm else self._model_full
            decision = model.run(X, init_centroids=self._accepted_centroids if warm else None)
            # The model is accepted now (next window's drift reference); the
            # plan diff runs in phase B against the then-applied plan.
            self._pending_accept = decision
        seconds["recluster"] = time.perf_counter() - t0
        seconds["host_a"] = time.perf_counter() - t_start
        return {"w": int(w), "events": events, "rec": rec, "seconds": seconds, "X": X,
                "decision": decision, "reads": reads}

    def _window_phase_b(self, ctx: dict) -> dict:
        """Plan diff and submit, fault events, repairs, scrub, budgeted
        admission, durability and integrity, evaluation, record."""
        cfg = self.cfg
        w = ctx["w"]
        events: EventLog = ctx["events"]
        rec: dict = ctx["rec"]
        seconds: dict = ctx["seconds"]
        t_b = time.perf_counter()
        plan_seconds = 0.0
        self._lineage = []
        cs = self._cluster_state

        if ctx["decision"] is not None:
            t0 = time.perf_counter()
            if self._pending_accept is ctx["decision"]:
                self._ensure_accepted()
            self._accept_plan(ctx["decision"], trigger=rec["recluster_trigger"])
            rec["plan_moves_pending"] = len(self.scheduler.backlog)
            dt = time.perf_counter() - t0
            seconds["recluster"] += dt
            plan_seconds += dt

        if cs is not None:
            t0 = time.perf_counter()
            fault_events = list(self._fault_schedule.for_window(w))
            if self._elastic is not None:
                # The scale step reads the last window's serving; the drain
                # decommissions due now join the window's fault events.
                fault_events += self._elastic_step(w, rec)
            for ev in fault_events:
                cs.apply_event(ev)
            rec["fault_events"] = [ev.spec() for ev in fault_events]
            rec["nodes_up"] = cs.n_available
            seconds["faults"] = time.perf_counter() - t0

        want_eval = cfg.evaluate and len(events) > 0
        view_before = None
        ver_before = -1
        if cs is not None and want_eval:
            view_before = cs.placement_view()
            ver_before = cs.version
        rf_before = self.current_rf.copy() if want_eval else None

        # Repairs first, pre-charging the shared churn budget.
        bytes_reserved = files_reserved = 0
        if cs is not None:
            t0 = time.perf_counter()
            repair_rf = self.current_rf
            if self._storage is not None:
                converted, deferred = self._reconcile_strategies()
                rec["storage_conversions_retried"] = converted
                if len(deferred):
                    # A deferred file keeps its installed form, and repair
                    # maintains that form, not the unapplied target.
                    repair_rf = self.current_rf.copy()
                    repair_rf[deferred] = np.maximum(cs.installed_shards[deferred],
                                                     cs.min_live[deferred])
            self._repairs.sync(cs, repair_rf)
            rr = self._repairs.schedule(w, cs, repair_rf, self.current_cat,
                                        max_bytes=cfg.max_bytes_per_window,
                                        max_files=cfg.max_files_per_window)
            seconds["repair"] = time.perf_counter() - t0
            plan_seconds += seconds["repair"]
            rec["repair_moves"] = len(rr.applied)
            rec["repair_bytes"] = int(rr.bytes_used)
            rec["repair_bytes_copied"] = int(rr.bytes_copied)
            rec["repair_failed"] = rr.failed
            rec["repair_rebalanced"] = rr.rebalanced
            rec["repair_backlog"] = len(self._repairs.backlog)
            rec["repair_deferred_budget"] = rr.deferred_budget
            rec["repair_deferred_backoff"] = rr.deferred_backoff
            rec["repair_deferred_no_source"] = rr.deferred_no_source
            rec["repair_deferred_no_target"] = rr.deferred_no_target
            rec["repair_deferred_partition"] = rr.deferred_partition
            if rr.corrupt_sources:
                rec["repair_corrupt_sources"] = rr.corrupt_sources
            bytes_reserved = rr.bytes_used
            files_reserved = rr.files_touched
            if rr.applied or rr.failed:
                # Repair copies and spread rebalances are two causes.
                rb = set(rr.rebalanced_fids)
                rep_fids = np.asarray(sorted({f for f, _, _ in rr.applied} - rb),
                                      dtype=np.int64)
                if rep_fids.size or rr.failed:
                    self._lineage.append(("repair", rep_fids,
                                          int(rr.bytes_used - rr.rebalanced_bytes)))
                if rb:
                    self._lineage.append(("correlated_rebalance",
                                          np.asarray(sorted(rb), dtype=np.int64),
                                          int(rr.rebalanced_bytes)))

        # The elastic rebalance drains the epoch diff's moved set on what
        # the repairs left of the budget, before scrub and migrations.
        if self._elastic is not None and self._elastic.queue.size:
            t0 = time.perf_counter()
            rb_bytes, rb_files = self._elastic_rebalance(bytes_reserved)
            seconds["rebalance"] = time.perf_counter() - t0
            plan_seconds += seconds["rebalance"]
            rec["elastic"]["rebalanced"] = rb_files
            rec["elastic"]["rebalance_bytes"] = rb_bytes
            rec["elastic"]["queue"] = int(self._elastic.queue.size)
            bytes_reserved += rb_bytes
            files_reserved += rb_files

        # Scrub after repairs, on what is left of the byte budget; its
        # quarantines reach the next window's repair sync.
        if self._scrub is not None:
            if "defer_scrub" in self.degraded_modes:
                rec["scrub"] = {"bytes": 0, "copies_verified": 0, "files_verified": 0,
                                "corrupt_found": 0, "hinted": 0, "starved": False,
                                "cursor": int(self._scrub.cursor), "deferred": True}
            else:
                t0 = time.perf_counter()
                left = None
                if cfg.max_bytes_per_window is not None:
                    left = max(int(cfg.max_bytes_per_window) - bytes_reserved, 0)
                sr = self._scrub.run_window(w, cs, shared_left=left)
                seconds["scrub"] = time.perf_counter() - t0
                plan_seconds += seconds["scrub"]
                rec["scrub"] = {"bytes": int(sr.bytes_used),
                                "copies_verified": sr.copies_verified,
                                "files_verified": sr.files_verified,
                                "corrupt_found": sr.corrupt_found, "hinted": sr.hinted,
                                "starved": bool(sr.starved), "cursor": int(sr.cursor)}
                bytes_reserved += sr.bytes_used

        t0 = time.perf_counter()
        applied = self.scheduler.schedule(w, bytes_reserved=bytes_reserved,
                                          files_reserved=files_reserved)
        if len(applied):
            fi = applied.file_index
            self.current_rf[fi] = applied.rf_new
            self.current_cat[fi] = applied.cat_new
            if cs is not None:
                cs.prefetch_rows(fi)
            if cs is None or self._storage is None:
                # Placement mutates per file, in the admitted order.
                if cs is not None:
                    for f, rf_new in zip(fi.tolist(), applied.rf_new.tolist()):
                        cs.apply_rf_target(f, rf_new)
                self._installed_cat[fi] = applied.cat_new
            else:
                for m in applied:
                    # A strategy conversion re-encodes (or defers while the
                    # file is unreadable; the reconcile pass retries).
                    want = self._file_strategy(int(m.cat_new), m.file_index)
                    cs.apply_strategy_target(m.file_index, want[0], want[1], want[2],
                                             m.rf_new, want[3])
                    if self._strategy_installed(m.file_index, want):
                        self._installed_cat[m.file_index] = m.cat_new
        seconds["schedule"] = time.perf_counter() - t0
        plan_seconds += seconds["schedule"]
        if len(applied):
            # Admitted moves carry the cause their plan was submitted under.
            cc = self._move_cause[applied.file_index]
            for code, name in sorted(MOVE_CAUSES.items()):
                m = cc == code
                if m.any():
                    self._lineage.append((name, applied.file_index[m].copy(),
                                          int(applied.bytes_moved[m].sum())))
        rec["moves_applied"] = len(applied)
        rec["bytes_migrated"] = applied.total_bytes
        rec["backlog_files"] = len(self.scheduler.backlog)
        rec["backlog_bytes"] = int(self.scheduler.backlog_bytes)
        rec["deferred_hysteresis"] = self.scheduler.last_deferred_hysteresis
        rec["deferred_budget"] = self.scheduler.last_deferred_budget

        if cs is not None:
            rec["durability"] = cs.durability(self.current_rf, self.current_cat, CATEGORIES)
            if len(events):
                # Reads of files with no reachable copy this window.
                unreadable = cs.unreadable_mask()
                keep = events.path_id >= 0
                pid = events.path_id[keep]
                reads = np.asarray(events.op)[keep] == 0
                rec["n_reads"] = int(reads.sum())
                rec["unavailable_reads"] = int(unreadable[pid[reads]].sum())
            else:
                rec["n_reads"] = 0
                rec["unavailable_reads"] = 0

        if self._storage is not None:
            # Bytes and cost of the applied strategies after repairs and
            # migrations.
            rec["storage"] = self._storage_record()

        read_detect_copies = 0
        if ctx["reads"] is not None:
            t0 = time.perf_counter()
            read_detect_copies = self._serve_window(w, rec, *ctx["reads"])
            seconds["serve"] = time.perf_counter() - t0
            if self._elastic is not None:
                # The next window's scale step reads these.
                self._elastic.last_burn = float(rec.get("slo_burn", 0.0))
                self._elastic.last_util = float(rec.get("utilization_max", 0.0))

        if self._integrity_on:
            # Ground truth after the window's detections (scrub, repairs,
            # reads) quarantined what they found.
            integ = cs.integrity()
            integ["detected_scrub"] = (rec.get("scrub") or {}).get("corrupt_found", 0)
            integ["detected_repair"] = rec.get("repair_corrupt_sources", 0)
            # Unique copies, not reads: one unit for every detection path.
            integ["detected_read"] = read_detect_copies
            rec["integrity"] = integ

        t0 = time.perf_counter()
        rec["locality_before"] = rec["locality_after"] = None
        rec["balance_before"] = rec["balance_after"] = None
        if want_eval:
            if cs is not None:
                mb = evaluate_placement(self.manifest, events, view_before, seed=0)
                rec["locality_before"] = float(mb.read_locality)
                rec["balance_before"] = float(mb.load_balance)
                if cs.version != ver_before:
                    ma = evaluate_placement(self.manifest, events, cs.placement_view(),
                                            seed=0)
                    rec["locality_after"] = float(ma.read_locality)
                    rec["balance_after"] = float(ma.load_balance)
                else:
                    rec["locality_after"] = rec["locality_before"]
                    rec["balance_after"] = rec["balance_before"]
            else:
                rec["locality_before"], rec["balance_before"] = self._evaluate(events,
                                                                               rf_before)
                if applied:
                    rec["locality_after"], rec["balance_after"] = \
                        self._evaluate(events, self.current_rf)
                else:
                    rec["locality_after"] = rec["locality_before"]
                    rec["balance_after"] = rec["balance_before"]
        seconds["evaluate"] = time.perf_counter() - t0

        if self._hash_placement:
            # The placement axis's stamp; ``exceptions`` counts the rows that
            # differ from the computed base (exact across kill and resume).
            pl: dict = {"mode": cfg.placement_mode, "epoch": 0}
            if cs is not None:
                pl["epoch"] = int(cs._fn_epoch)
                if cfg.placement_mode == "functional":
                    pl["exceptions"] = int(cs.exception_fids().size)
            rec["placement"] = pl

        if self._lineage:
            causes: dict[str, dict] = {}
            for name, fids, b in self._lineage:
                c = causes.setdefault(name, {"files": 0, "bytes": 0})
                c["files"] += int(fids.size)
                c["bytes"] += int(b)
            rec["causes"] = causes

        rec["plan_hash"] = _plan_hash(self.current_rf, self.current_cat)
        # ``plan``: plan diff and submit, repairs, scrub and admission;
        # ``total``: host wall clock of both phases of this window.
        seconds["plan"] = plan_seconds
        seconds["total"] = seconds.pop("host_a") + (time.perf_counter() - t_b)
        rec["seconds"] = {k: round(v, 6) for k, v in seconds.items()}
        self._instrument_window(rec, seconds, ctx["X"])
        return rec

    def _instrument_window(self, rec: dict, seconds: dict, X=None) -> None:
        """The window's observations through the active instrument, the
        reference's schema: counters of events, re-clusters, migrations,
        faults, repairs and scrub; planner, mesh, durability, integrity
        and storage gauges; the ``serve.*`` telemetry; lineage events; the
        per-stage seconds histograms; the audit over the window's feature
        snapshot ``X`` (when the loop took one); and, inside a daemon
        decision, one retrospective ``controller.<stage>`` span a stage.
        Nothing without an instrument; nothing here changes the plan."""
        tel = _obs_current()
        if tel is None:
            return
        if tel.audit:
            if self._auditor is None:
                from ..obs.audit import DecisionAuditor

                self._auditor = DecisionAuditor(self._sizes, len(CATEGORIES))
            self._auditor.audit_window(tel, window=rec["window"], rec=rec, X=X,
                                       centroids=self._accepted_centroids,
                                       rf=self.current_rf, cat=self.current_cat)
        tel.counter_inc("controller.windows")
        if rec["n_events"]:
            tel.counter_inc("controller.events_folded", rec["n_events"])
        if rec["recluster"]:
            tel.counter_inc(f"controller.reclusters.{rec['recluster_mode']}")
        for key, name in (("moves_applied", "migrate.files_moved"),
                          ("bytes_migrated", "migrate.bytes_moved"),
                          ("deferred_hysteresis", "migrate.deferred_hysteresis"),
                          ("deferred_budget", "migrate.deferred_budget")):
            if rec[key]:
                tel.counter_inc(name, rec[key])
        tel.gauge("planner.backlog_files", rec["backlog_files"])
        tel.gauge("planner.backlog_bytes", rec["backlog_bytes"])
        mesh = rec.get("mesh")
        if mesh is not None:
            ndata = max(1, int((self.cfg.mesh_shape or {}).get("data", 1)))
            tel.gauge("mesh.devices", mesh["devices"])
            tel.gauge("mesh.rows_per_device", -(-len(self.manifest) // ndata))
            tel.gauge("mesh.collective_bytes_per_iter", mesh["collective_bytes_per_iter"])
        if rec.get("fault_events"):
            tel.counter_inc("fault.events", len(rec["fault_events"]))
            n_part_ev = sum(1 for s in rec["fault_events"]
                            if s.startswith(("partition:", "heal:")))
            if n_part_ev:
                tel.counter_inc("fault.partition.events", n_part_ev)
        dur = rec.get("durability")
        if dur is not None:
            tel.gauge("durability.under_replicated", dur["under_replicated"])
            tel.gauge("durability.at_risk", dur["at_risk"])
            tel.gauge("durability.lost", dur["lost"])
            tel.gauge("durability.nodes_up", dur["nodes_up"])
            tel.gauge("durability.correlated.files", dur.get("correlated_risk", 0))
            tel.gauge("durability.correlated.domains_reachable",
                      dur.get("domains_reachable", 1))
            tel.gauge("fault.partition.nodes", dur.get("nodes_partitioned", 0))
            tel.gauge("fault.partition.unreachable_files", dur.get("unreachable", 0))
            if rec.get("unavailable_reads"):
                tel.counter_inc("fault.unavailable_reads", rec["unavailable_reads"])
        for key, name in (("repair_moves", "repair.files_replicated"),
                          ("repair_bytes", "repair.bytes"),
                          ("repair_failed", "repair.failed"),
                          ("repair_deferred_budget", "repair.deferred_budget"),
                          ("repair_deferred_no_source", "repair.deferred_no_source"),
                          ("repair_deferred_no_target", "repair.deferred_no_target"),
                          ("repair_deferred_partition", "fault.partition.stalled_repairs"),
                          ("repair_rebalanced", "repair.rebalanced_domain"),
                          ("repair_corrupt_sources", "repair.corrupt_sources")):
            if rec.get(key):
                tel.counter_inc(name, rec[key])
        sc = rec.get("scrub")
        if sc is not None:
            if sc["bytes"]:
                tel.counter_inc("scrub.bytes", sc["bytes"])
            if sc["copies_verified"]:
                tel.counter_inc("scrub.copies_verified", sc["copies_verified"])
            if sc["corrupt_found"]:
                tel.counter_inc("scrub.corrupt_found", sc["corrupt_found"])
            if sc["starved"]:
                tel.counter_inc("scrub.starved_windows")
            tel.gauge("scrub.cursor", sc["cursor"])
        integ = rec.get("integrity")
        if integ is not None:
            tel.gauge("integrity.corrupt_copies", integ["corrupt_copies"])
            tel.gauge("integrity.files_corrupt", integ["files_corrupt"])
            tel.gauge("integrity.true_lost", integ["true_lost"])
        st = rec.get("storage")
        if st is not None:
            tel.gauge("storage.bytes_stored", st["bytes_stored"])
            tel.gauge("storage.overhead_ratio", st["overhead_ratio"])
            tel.gauge("storage.cost_units", st["cost_units"])
            tel.gauge("storage.ec_files", st["ec_files"])
            for t, b in st["per_tier_bytes"].items():
                tel.gauge(f"storage.tier.{t}.bytes", b)
        if self._router is not None:
            emit_window_telemetry(tel, rec, self._last_latency_ms)
        self._last_latency_ms = None
        for name, fids, b in self._lineage:
            ev = {"kind": "lineage", "window": rec["window"], "cause": name,
                  "files": int(fids.size), "bytes": int(b),
                  "file_ids": [int(x) for x in fids[:LINEAGE_ID_CAP]]}
            if fids.size > LINEAGE_ID_CAP:
                ev["truncated"] = True
            tel._emit(ev)
            if fids.size:
                tel.counter_inc(f"lineage.{name}.files", int(fids.size))
            if b:
                tel.counter_inc(f"lineage.{name}.bytes", int(b))
        for stage, secs in seconds.items():
            tel.histogram(f"controller.{stage}.seconds", secs)
        if self._trace_id is not None:
            parent = tel.current_span_id()
            for stage, secs in seconds.items():
                if stage != "total":
                    tel.emit_span(f"controller.{stage}", secs, parent=parent,
                                  trace=self._trace_id, window=rec["window"])

    def _serve_window(self, w: int, rec: dict, read_pid: np.ndarray, read_ts: np.ndarray,
                      read_client: np.ndarray) -> int:
        """Route the window's reads against the end-of-window placement and
        put the serving fields on ``rec``; returns the rotten copies the
        reads detected (quarantined here, hinted to the scrubber)."""
        cfg = self.cfg
        reads_shed = 0
        if self.serve_shed is not None and read_pid.shape[0]:
            frac, shed_seed = self.serve_shed
            keep = np.random.default_rng([int(shed_seed), int(w)]).random(
                read_pid.shape[0]) >= float(frac)
            if keep.any() and not keep.all():
                reads_shed = int(read_pid.shape[0] - int(keep.sum()))
                read_pid, read_ts, read_client = read_pid[keep], read_ts[keep], read_client[keep]
        cs = self._cluster_state
        if cs is not None:
            view = read_view(read_pid, state=cs)
            if not self._integrity_on:
                # Without corruption in the schedule or a scrubber the
                # router ignores rot bits a resumed snapshot may carry.
                view.slot_corrupt = None
            if self._storage is not None:
                # A stripe below k reachable shards serves no read from any
                # slot: the router counts it unavailable, as
                # ``unavailable_reads`` does.
                readable = ~cs.unreadable_mask()
                if view.file_ids is not None:
                    readable = readable[view.file_ids]
                view.slot_ok = view.slot_ok & readable[:, None]
        elif self.cfg.placement_mode == "functional" and self._storage is None:
            # Only this window's files are resolved, through the chooser.
            view = read_view(read_pid, resolver=self._fn_static_rows,
                             n_nodes=len(self._serve_topology.nodes))
        else:
            view = read_view(read_pid, placement=self._placement_for(self.current_rf))
        extra_ms = None
        if self._storage is not None:
            if view.file_ids is not None:
                extra_ms = self._serve_penalty_ms(view.slot_ok, fids=view.file_ids)[view.pid]
            else:
                extra_ms = self._serve_penalty_ms(view.slot_ok)[read_pid]
        res = self._router.route(
            view.replica_map, view.slot_ok, view.node_throughput, ts=read_ts, pid=view.pid,
            client=read_client, window_seconds=cfg.window_seconds,
            rng=np.random.default_rng([int(cfg.serve.seed), int(w)]), extra_ms=extra_ms,
            edge_ms=self._edge_ms, slot_corrupt=view.slot_corrupt)
        rec.update(res.record_fields())
        self._last_latency_ms = res.latency_ms
        if self.serve_shed is not None:
            # Only brownout runs carry the key.
            rec["reads_shed"] = reads_shed
        if res.corrupt_pairs is None or not len(res.corrupt_pairs):
            return 0
        # A compacted view's pairs carry row ids.
        pair_fids = res.corrupt_pairs[:, 0]
        if view.file_ids is not None:
            pair_fids = view.file_ids[pair_fids]
        for fid, node in zip(pair_fids, res.corrupt_pairs[:, 1]):
            cs.quarantine(int(fid), int(node))
        if self._scrub is not None:
            self._scrub.add_hints(pair_fids)
        return len(res.corrupt_pairs)

    def _edge_latency_ms(self, topology) -> np.ndarray | None:
        """(n_nodes, n_nodes) cross-hierarchy propagation delay of a read:
        ``service_ms`` times the ``edge_latency`` multiplier less one; None
        for a topology without ``edge_latency``."""
        if not getattr(topology, "edge_latency", ()):
            return None
        return float(self.cfg.serve.service_ms) * (topology.latency_matrix() - 1.0)

    def _ensure_accepted(self) -> None:
        """Turn the pending accepted decision into the host model arrays:
        float32 centroids, the category of each cluster and the category
        fractions."""
        decision = self._pending_accept
        if decision is None:
            return
        self._pending_accept = None
        self._accepted_centroids = np.asarray(decision.centroids, dtype=np.float32)
        cat_idx = np.asarray(decision.category_idx).astype(np.int64)
        self._accepted_category_idx = cat_idx
        labels = np.asarray(decision.labels)
        new_cat = cat_idx[labels]
        self._accepted_file_cat = new_cat
        frac = np.bincount(new_cat, minlength=len(CATEGORIES)).astype(np.float64)
        self._accepted_fractions = frac / max(len(labels), 1)

    def _accept_plan(self, decision, trigger: str | None = None) -> None:
        """Diff the decision's plan against the applied plan and replace the
        backlog with it; the moves are tagged ``hotspot`` when ``trigger``
        is, else ``drift`` (a cold start is the first drift decision), and
        storage re-encodes ``conversion``."""
        labels = np.asarray(decision.labels)
        new_cat = self._accepted_file_cat
        if new_cat is None:
            new_cat = np.asarray(decision.category_idx).astype(np.int64)[labels]
        # With storage the target "rf" is the strategy's shard count.
        if self._storage is not None:
            rf_vec = self._storage.n_shards.astype(np.int64)
        else:
            rf_vec = np.asarray(self.cfg.scoring.rf_vector(), dtype=np.int64)
        new_rf = rf_vec[new_cat]
        # Priority: the new category's score margin over the applied one
        # (unplanned files: over the cluster's worst category).
        file_scores = np.asarray(decision.scores, dtype=np.float64)[labels]
        new_score = np.take_along_axis(file_scores, new_cat[:, None], axis=1)[:, 0]
        old_cat = self.current_cat.astype(np.int64)
        old_ref = np.where(old_cat >= 0, old_cat, 0)
        old_score = np.take_along_axis(file_scores, old_ref[:, None], axis=1)[:, 0]
        old_score = np.where(old_cat >= 0, old_score, file_scores.min(axis=1))
        move_bytes = None
        convert = None
        if self._storage is not None:
            # A re-encode (another min_live, shard size, k or locality)
            # drops every old copy and writes rf_new new shards: charge
            # those; a same-shape move pays shard_new per added shard.
            sv = self._storage
            old_cat = self.current_cat
            shard_old = sv.file_shard_bytes(old_cat, self._sizes)
            shard_new = sv.file_shard_bytes(new_cat, self._sizes)
            convert = ((sv.file_min_live(old_cat) != sv.file_min_live(new_cat))
                       | (shard_old != shard_new)
                       | (sv.file_ec_k(old_cat) != sv.file_ec_k(new_cat))
                       | (sv.file_region_local(old_cat) != sv.file_region_local(new_cat)))
            move_bytes = np.where(convert, new_rf * shard_new,
                                  shard_new * np.maximum(new_rf - self.current_rf, 0))
        moves = plan_diff(self.current_rf, new_rf, self.current_cat, new_cat, self._sizes,
                          priority=new_score - old_score, move_bytes=move_bytes)
        if len(moves):
            codes = np.full(len(moves), 2 if trigger == "hotspot" else 1, dtype=np.int8)
            if convert is not None:
                codes[convert[moves.file_index]] = 3
            self._move_cause[moves.file_index] = codes
        self.scheduler.submit(moves)

    # -- storage strategies ------------------------------------------------
    def _file_strategy(self, cat: int, fid: int) -> tuple[int, int, int, bool]:
        """(min_live, shard_bytes, ec_k, region_local) of one file under
        ``cat``."""
        sv = self._storage
        if cat < 0:
            return 1, int(self._sizes[fid]), 0, False
        return (int(sv.min_live[cat]), -(-int(self._sizes[fid]) // int(sv.shard_div[cat])),
                int(sv.ec_k[cat]), bool(sv.region_local[cat]))

    def _strategy_installed(self, fid: int, want) -> bool:
        """Whether ``fid``'s installed strategy is ``want`` (``_file_strategy``)."""
        cs = self._cluster_state
        return (int(cs.min_live[fid]) == int(want[0])
                and int(cs.shard_bytes[fid]) == int(want[1])
                and int(cs.ec_k[fid]) == int(want[2])
                and bool(cs.region_local[fid]) == bool(want[3]))

    def _reconcile_strategies(self) -> tuple[int, np.ndarray]:
        """Retry the deferred conversions: once a file is readable again it
        re-encodes to the strategy its applied category wants (the move
        paid the budget when it was admitted).  Returns the number
        converted and the file ids still deferred."""
        cs = self._cluster_state
        sv = self._storage
        cat = self.current_cat
        want = (sv.file_min_live(cat), sv.file_shard_bytes(cat, self._sizes),
                sv.file_ec_k(cat), sv.file_region_local(cat))
        converted = 0
        still = []
        for fid in cs.strategy_mismatch(*want[:3], region_local=want[3]):
            f = int(fid)
            wf = tuple(a[f] for a in want)
            cs.apply_strategy_target(f, int(wf[0]), int(wf[1]), int(wf[2]),
                                     int(self.current_rf[f]), bool(wf[3]))
            # Success is the strategy matching (the shard-count delta can be
            # 0, as in replicate(3) -> ec(2,1)).
            if self._strategy_installed(f, wf):
                converted += 1
                self._installed_cat[f] = int(cat[f])
            else:
                still.append(f)
        return converted, np.asarray(still, dtype=np.int64)

    def _storage_record(self) -> dict:
        """Bytes and cost of the applied strategies: the fault path counts
        the assigned slots at the installed shard size, the plain path the
        target shards capped at the node count; tier and byte cost follow
        the installed category."""
        sv = self._storage
        cat = self.current_cat
        planned = cat >= 0
        icat = self._installed_cat
        isafe = np.clip(icat, 0, None)
        cs = self._cluster_state
        if cs is not None:
            counts = cs.assigned_counts()
            shard_b = cs.shard_bytes
            ec_files = int(((cs.ec_k > 0) & planned).sum())
        else:
            counts = np.minimum(self.current_rf, len(self.manifest.nodes))
            shard_b = sv.file_shard_bytes(cat, self._sizes)
            ec_files = int(((sv.file_ec_k(cat) > 0) & planned).sum())
        stored = counts.astype(np.int64) * shard_b
        raw = int(self._sizes.sum())
        cost_file = np.where(icat >= 0, sv.byte_cost[isafe], sv.default_byte_cost)
        tier_file = np.where(icat >= 0, sv.tier_idx[isafe], sv.default_tier_idx)
        per_tier = np.bincount(tier_file, weights=stored, minlength=len(sv.tier_names))
        names = list(sv.categories) + ["Unplanned"]
        bucket = np.where(planned, cat, len(sv.categories))
        per_cat = np.bincount(bucket, weights=stored, minlength=len(names))
        total = int(stored.sum())
        return {
            "bytes_raw": raw,
            "bytes_stored": total,
            "overhead_ratio": round(total / raw, 6) if raw else 0.0,
            "cost_units": round(float((stored * cost_file).sum()), 3),
            "ec_files": ec_files,
            "per_tier_bytes": {t: int(per_tier[i]) for i, t in enumerate(sv.tier_names)
                               if per_tier[i]},
            "per_category_bytes": {c: int(per_cat[i]) for i, c in enumerate(names)
                                   if per_cat[i]},
        }

    def _serve_penalty_ms(self, slot_ok: np.ndarray,
                          fids: np.ndarray | None = None) -> np.ndarray:
        """(n_files,) read latency the storage layer adds: the tier's stretch
        (``service_ms * (1 / throughput - 1)``) plus, for an EC file whose
        primary shard is unreachable, the gather of k - 1 more shards at the
        tier's speed; both follow the installed category.  With ``fids``
        (a compacted view's files) one value per row of ``slot_ok``."""
        sv = self._storage
        cat = self._installed_cat if fids is None else self._installed_cat[fids]
        safe = np.clip(cat, 0, None)
        pen = np.where(cat >= 0, sv.read_penalty[safe], sv.default_read_penalty)
        k_file = sv.file_ec_k(cat)
        primary_down = ~slot_ok[:, 0] if slot_ok.shape[1] else \
            np.ones(cat.shape[0], dtype=bool)
        base = float(self.cfg.serve.service_ms)
        return base * (pen - 1.0) + np.where((k_file > 0) & primary_down,
                                             base * (k_file - 1) * pen, 0.0)

    # -- elastic capacity --------------------------------------------------
    def _elastic_step(self, w: int, rec: dict) -> list:
        """One window's scale decision on the last window's serving: update
        the hot and cool streaks, scale out (grow, epoch diff into the
        rebalance queue) or lay down the rolling drain; returns the drain
        decommissions due now and stamps the ``elastic`` record."""
        from ..faults.schedule import FaultEvent

        es = self._elastic
        pol = es.policy
        info: dict = {"active": len(es.active), "queue": int(es.queue.size)}
        if es.last_burn is not None:
            hot = es.last_burn > pol.burn_hot or es.last_util > pol.util_hot
            cool = es.last_burn <= pol.burn_hot and es.last_util < pol.util_cool
            es.hot = es.hot + 1 if hot else 0
            es.cool = es.cool + 1 if cool else 0
        info["hot_streak"] = es.hot
        info["cool_streak"] = es.cool
        if not es.scaled and es.hot >= pol.hot_windows:
            names = pol.next_activation(es.active)
            if not names:
                # Drained nodes are never reused: a later crowd finds the
                # pool spent, and says so.
                info["pool_exhausted"] = True
            else:
                moved = self._elastic_grow(names)
                es.active = es.active + tuple(names)
                es.scaled = True
                es.hot = 0
                es.cool = 0
                es.moved_total += int(moved.size)
                info["added"] = list(names)
                info["moved"] = int(moved.size)
                info["active"] = len(es.active)
                info["queue"] = int(es.queue.size)
        elif (es.scaled and not es.drains and es.queue.size == 0
                and es.cool >= pol.cool_windows and es.active):
            es.drains = [(w + 1 + i * pol.drain_spacing, nm) for i, nm in enumerate(es.active)]
            info["drains_scheduled"] = [[int(a), b] for a, b in es.drains]
            es.scaled = False
            es.cool = 0
        due: list = []
        still: list = []
        for dw, nm in es.drains:
            if dw <= w:
                due.append(FaultEvent(w, "decommission", nm))
            else:
                still.append((dw, nm))
        es.drains = still
        if due:
            info["drained"] = [e.node for e in due]
        rec["elastic"] = info
        return due

    def _elastic_grow(self, names) -> np.ndarray:
        """Activate standby nodes: pin the moved rows, grow the state,
        rebuild the serve plane on the wider topology; returns the
        addition-pruned epoch diff (queued for the rebalance)."""
        cs = self._cluster_state
        topo_old = cs.topology
        topo_new = self._elastic.policy.grown_topology(topo_old, names)
        local = cs.region_local if topo_old.n_levels > 0 and cs.region_local.any() else None
        moved = addition_moved(topo_old, topo_new, cs.installed_shards, cs._fn_primary,
                               cs._fn_seed, local_mask=local)
        cs.pin_rows(moved)
        cs.grow(topo_new)
        es = self._elastic
        es.queue = np.concatenate([es.queue, moved]) if es.queue.size else moved
        if moved.size:
            # Traffic is billed when the queue drains (elastic_rebalance).
            self._lineage.append(("epoch_diff", moved.copy(), 0))
        self._grow_serve_plane(topo_new)
        return moved

    def _grow_serve_plane(self, topology) -> None:
        self._serve_topology = topology
        self._router = ReadRouter(len(topology.nodes), self.cfg.serve)
        self._edge_ms = self._edge_latency_ms(topology)
        self._fn_static_primary = None

    def _elastic_rebalance(self, bytes_reserved: int) -> tuple[int, int]:
        """Drain the rebalance queue within the budget left: each file moves
        to its new computed row, charged one shard per newly holding node.
        When nothing else moved bytes this window, the head is admitted
        regardless (the repair pass's rule)."""
        cs = self._cluster_state
        es = self._elastic
        q = es.queue
        max_bytes = self.cfg.max_bytes_per_window
        used = done = 0
        for i in range(q.size):
            fid = int(q[i])
            new_row = cs._fn_base_row(fid)
            cur = cs.row(fid)
            new_only = ({int(x) for x in new_row[new_row >= 0]}
                        - {int(x) for x in cur[cur >= 0]})
            charge = int(cs.shard_bytes[fid]) * len(new_only)
            if max_bytes is not None and bytes_reserved + used + charge > max_bytes \
                    and bytes_reserved + used > 0:
                break
            used += cs.retarget_row(fid, new_row)
            done += 1
        es.queue = q[done:]
        if done:
            self._lineage.append(("elastic_rebalance", q[:done].copy(), int(used)))
        return used, done

    def _fn_static_rows(self, uniq: np.ndarray) -> np.ndarray:
        """(k, R) computed rows of a file subset at the current rf: the
        functional read path's resolver when there is no fault state."""
        topology = self._serve_topology
        if self._fn_static_primary is None:
            self._fn_static_primary = primary_on_topology(
                self.manifest.nodes, self.manifest.primary_node_id, topology)
        slots, _ = compute_placement(uniq, self.current_rf[uniq],
                                     self._fn_static_primary[uniq], topology, 0)
        return slots

    def _placement_for(self, rf: np.ndarray):
        """The placement of an rf vector (seed 0, the mode's chooser) on the
        serve topology, flat without serving; cached on the vector, so move-free windows,
        the before/after pair and the router reuse it.  With storage the
        shards are placed by ``place_stripes`` at their shard size, region-
        local categories pinned, and the category vector joins the key."""
        key = rf.tobytes()
        if self._storage is not None:
            key += self.current_cat.tobytes()
        if self._placement_key != key:
            topology = self._serve_topology or ClusterTopology(nodes=tuple(self.manifest.nodes))
            if self._storage is not None:
                self._placement = place_stripes(
                    self.manifest, rf.copy(), topology, seed=0,
                    shard_bytes=self._storage.file_shard_bytes(self.current_cat, self._sizes),
                    method=self._placement_method,
                    local_mask=self._storage.file_region_local(self.current_cat))
            else:
                self._placement = place_replicas(self.manifest, rf.copy(), topology, seed=0,
                                                 method=self._placement_method)
            self._placement_key = key
        return self._placement

    def _evaluate(self, events: EventLog, rf: np.ndarray):
        m = evaluate_placement(self.manifest, events, self._placement_for(rf), seed=0)
        return float(m.read_locality), float(m.load_balance)

    # -- checkpoint --------------------------------------------------------
    def save_checkpoint(self, path: str, extra_meta: dict | None = None) -> None:
        """Atomic npz snapshot of the whole controller state (meta ``backend``
        is ``"torch"``); ``extra_meta`` goes into the meta blob under the
        caller's keys (the daemon's ingest cursor)."""
        self._ensure_accepted()
        arrays = {k: getattr(self._state, k).cpu().numpy() for k in self._STATE_ARRAYS}
        if self._dec is not None:
            arrays.update({"dec_" + k: v for k, v in self.decayed_counters().items()})
        arrays["current_rf"] = self.current_rf
        arrays["current_cat"] = self.current_cat
        arrays["installed_cat"] = self._installed_cat
        # Move causes, sparse over the backlog (the only moves still to be
        # admitted).
        bl_fids = self.scheduler.backlog.file_index
        arrays["move_cause_fids"] = bl_fids.copy()
        arrays["move_cause_vals"] = self._move_cause[bl_fids]
        if self._accepted_centroids is not None:
            arrays["accepted_centroids"] = self._accepted_centroids
            arrays["accepted_category_idx"] = self._accepted_category_idx
            arrays["accepted_fractions"] = self._accepted_fractions
        arrays.update(self.scheduler.state_arrays())
        if self._cluster_state is not None:
            if self.cfg.placement_mode == "functional":
                # Exceptions over the base, intents anchored at current_rf.
                arrays.update(self._cluster_state.state_arrays(rf_hint=self.current_rf))
            else:
                arrays.update(self._cluster_state.state_arrays())
            arrays.update(self._repairs.state_arrays())
        if self._hotspot is not None:
            arrays.update(self._hotspot.state_arrays())
        if self._scrub is not None:
            arrays.update(self._scrub.state_arrays())
        if self._elastic is not None:
            arrays["elastic_queue"] = self._elastic.queue.copy()
        meta = {
            "window_index": self.window_index,
            "last_window_events": self._last_window_events,
            "t0": self._t0,
            "events_total": self._events_total,
            "sec_base": self._state.sec_base,
            "observation_end": self._state.observation_end,
            "state_n_events": self._state.n_events,
            "pad_events": self._state.pad_events,
            "dec_obs_end": self._dec_obs_end,
            "decay": self.cfg.decay,
            "window_seconds": self.cfg.window_seconds,
            "k": int(self.cfg.kmeans.k),
            "backend": "torch",
            "n_files": len(self.manifest),
            "faults": self._cluster_state is not None,
            "serve": self._router is not None,
            "storage": self._storage is not None,
            "scrub": self._scrub is not None,
            "placement": self.cfg.placement_mode,
        }
        if self._elastic is not None:
            es = self._elastic
            meta["elastic"] = {"hot": es.hot, "cool": es.cool, "active": list(es.active),
                               "moved_total": es.moved_total,
                               "drains": [[int(a), str(b)] for a, b in es.drains],
                               "scaled": bool(es.scaled), "last_burn": es.last_burn,
                               "last_util": es.last_util}
        if extra_meta:
            meta.update(extra_meta)
        stats = save_state(path, arrays, meta=meta)
        self.checkpoint_log.append({"window": int(self.window_index), **stats})

    def load_checkpoint(self, path: str) -> None:
        """Restore a snapshot of this controller; one taken under another
        population size, k, backend, decay, window, fault, serve, storage,
        scrub or placement mode raises ``ValueError``."""
        arrays, meta = load_state(path)
        for key, want in (("n_files", len(self.manifest)), ("k", int(self.cfg.kmeans.k)),
                          ("backend", "torch"), ("decay", self.cfg.decay),
                          ("window_seconds", self.cfg.window_seconds),
                          ("faults", self._cluster_state is not None),
                          ("serve", self._router is not None),
                          ("storage", self._storage is not None),
                          ("scrub", self._scrub is not None),
                          ("placement", self.cfg.placement_mode)):
            got = meta.get(key)
            if key in ("faults", "serve", "storage", "scrub"):
                got = bool(got)
            elif key == "placement":
                got = got or "materialized"
            if got != want:
                raise ValueError(
                    f"checkpoint {path!r} has {key}={got!r} but the controller "
                    f"expects {want!r}: stale checkpoint? delete it to start over")
        self._state = StreamFeatureState(
            **{k: torch.from_numpy(np.asarray(arrays[k], dtype=np.int32)).to(self.device)
               for k in self._STATE_ARRAYS},
            sec_base=meta.get("sec_base"), observation_end=meta.get("observation_end"),
            n_events=int(meta.get("state_n_events", 0)),
            pad_events=int(meta.get("pad_events", 0)))
        if self._dec is not None:
            self._dec = {k: torch.from_numpy(np.asarray(arrays["dec_" + k],
                                                        dtype=np.float64)).to(self.device)
                         for k in _DEC_KEYS}
            self._dec_obs_end = meta.get("dec_obs_end")
        self.current_rf = arrays["current_rf"].astype(np.int32)
        self.current_cat = arrays["current_cat"].astype(np.int32)
        self._installed_cat = (arrays["installed_cat"].astype(np.int32)
                               if "installed_cat" in arrays else self.current_cat.copy())
        self._move_cause = np.zeros(len(self.manifest), dtype=np.int8)
        if "move_cause_fids" in arrays:
            self._move_cause[arrays["move_cause_fids"]] = \
                arrays["move_cause_vals"].astype(np.int8)
        if "accepted_centroids" in arrays:
            self._accepted_centroids = arrays["accepted_centroids"]
            self._accepted_category_idx = arrays["accepted_category_idx"]
            self._accepted_fractions = arrays["accepted_fractions"]
        # Recomputed at the next acceptance; never carried over a load.
        self._accepted_file_cat = None
        self.scheduler.load_state_arrays(arrays)
        if self._elastic is not None and meta.get("elastic"):
            # Replay the growth before the state arrays load: a snapshot
            # after a scale-out is sized for the grown topology.
            em = meta["elastic"]
            es = self._elastic
            es.hot, es.cool = int(em["hot"]), int(em["cool"])
            es.active = tuple(em["active"])
            es.moved_total = int(em["moved_total"])
            es.drains = [(int(a), str(b)) for a, b in em["drains"]]
            es.scaled = bool(em["scaled"])
            es.last_burn, es.last_util = em["last_burn"], em["last_util"]
            es.queue = np.asarray(arrays.get("elastic_queue", np.zeros(0, np.int64)),
                                  dtype=np.int64).copy()
            if es.active:
                topo_new = es.policy.grown_topology(self._cluster_state.topology, es.active)
                self._cluster_state.grow(topo_new)
                self._grow_serve_plane(topo_new)
        if self._cluster_state is not None:
            self._cluster_state.load_state_arrays(arrays)
            self._repairs.load_state_arrays(arrays)
        if self._hotspot is not None:
            self._hotspot.load_state_arrays(arrays)
        if self._scrub is not None:
            self._scrub.load_state_arrays(arrays)
        self.window_index = int(meta["window_index"])
        self._last_window_events = int(meta.get("last_window_events", 0))
        self._t0 = meta.get("t0")
        self._events_total = int(meta.get("events_total", 0))
        self.last_checkpoint_meta = meta

    def _load_checkpoint_with_fallback(self, path: str) -> None:
        """Resume from ``path``; a corrupt or truncated snapshot falls back to
        the retained ``<path>.prev`` (one checkpoint older; the loop replays
        forward to the same state), which is then promoted over ``path``.
        A stale checkpoint still raises."""
        prev = path + ".prev"
        if not os.path.exists(path):
            return
        try:
            self.load_checkpoint(path)
            return
        except CheckpointError as e:
            if not os.path.exists(prev):
                raise
            warnings.warn(f"{e}; falling back to the retained last-good snapshot {prev!r}",
                          RuntimeWarning, stacklevel=2)
        self.load_checkpoint(prev)
        tmp = prev + ".promote"
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
            os.link(prev, tmp)
        except OSError:
            import shutil

            shutil.copyfile(prev, tmp)
        os.replace(tmp, path)

    # -- the loop ----------------------------------------------------------
    def run(self, source, *, metrics_path: str | None = None,
            metrics_max_bytes: int | None = None,
            checkpoint_path: str | None = None, checkpoint_every: int = 1,
            max_windows: int | None = None, batch_size: int = 1_000_000) -> ControllerResult:
        """Drive the controller over a log (path, EventLog or batch iterable).

        ``checkpoint_path``: resume from an existing snapshot (earlier
        windows are skipped unfolded; the log is re-read from its start, so
        the grid is the same) and snapshot every ``checkpoint_every``
        processed windows and at a clean exit.  The snapshot stays after
        the run: a later run over the grown append-only log continues from
        it, folding the late tail of the last processed window first.

        ``metrics_path``: append each window record, with ``"kind":
        "window"``, to a ``JsonlSink`` (rotated past ``metrics_max_bytes``),
        or to the active instrument's sink when it writes that path.
        ``max_windows`` stops after that
        many processed windows (skipped ones do not count).
        """
        with deterministic():
            return self._run(source, metrics_path, metrics_max_bytes, checkpoint_path,
                             checkpoint_every, max_windows, batch_size)

    def _run(self, source, metrics_path, metrics_max_bytes, checkpoint_path, checkpoint_every,
             max_windows, batch_size) -> ControllerResult:
        if checkpoint_path:
            self._load_checkpoint_with_fallback(checkpoint_path)
        records: list[dict] = []
        sink = None
        own_sink = False
        if metrics_path:
            # One stream, one writer: an active instrument's sink on this
            # very path takes the window records too (two sinks on one file
            # would each rotate it under the other); it closes with the
            # instrument.
            tel = _obs_current()
            if tel is not None and tel.sink is not None and tel.sink.path == metrics_path:
                sink = tel.sink
            else:
                sink = JsonlSink(metrics_path, max_bytes=metrics_max_bytes)
                own_sink = True
        processed = 0
        since_ckpt = 0
        t0_box: dict = {}
        every = max(1, checkpoint_every)
        #: Window dispatched (phase A) but not yet planned (phase B).
        pending: dict | None = None

        def finish(ctx: dict) -> None:
            nonlocal processed, since_ckpt
            rec = self._window_phase_b(ctx)
            self.window_index = ctx["w"] + 1
            self._last_window_events = len(ctx["events"])
            records.append(rec)
            if sink:
                sink.emit({"kind": "window", **rec})
            processed += 1
            since_ckpt += 1

        try:
            for w, events in iter_windows(source, self.manifest, self.cfg.window_seconds,
                                          batch_size=batch_size, t0=self._t0,
                                          t0_out=t0_box):
                # Before any work: max_windows=0 changes nothing, and a held
                # window counts as if it were done.
                if max_windows is not None and \
                        processed + (pending is not None) >= max_windows:
                    break
                if self._t0 is None:
                    self._t0 = t0_box.get("t0")
                if w < self.window_index:
                    # Already processed; fold the late tail of the last one.
                    if (w == self.window_index - 1
                            and len(events) > self._last_window_events):
                        self._fold_window(_slice(events, self._last_window_events,
                                                 len(events)), new_window=False)
                        self._last_window_events = len(events)
                        since_ckpt += 1
                    continue
                ctx = self._window_phase_a(w, events)
                if pending is not None:
                    finish(pending)
                    pending = None
                # A window is held only when finishing it cannot trigger a
                # snapshot, so no snapshot holds a dispatched window's fold.
                if self.cfg.overlap_windows and not (checkpoint_path
                                                     and since_ckpt + 1 >= every):
                    pending = ctx
                else:
                    finish(ctx)
                    if checkpoint_path and since_ckpt >= every:
                        self.save_checkpoint(checkpoint_path)
                        since_ckpt = 0
            if pending is not None:
                finish(pending)
                pending = None
        finally:
            if own_sink:
                sink.close()
        # Only on a clean exit: an exception can land mid-window, and that
        # torn state would fold the window twice on resume.
        if checkpoint_path and since_ckpt:
            self.save_checkpoint(checkpoint_path)
        return ControllerResult(records=records, rf=self.current_rf.copy(),
                                category_idx=self.current_cat.copy(),
                                manifest=self.manifest, checkpoints=list(self.checkpoint_log))
