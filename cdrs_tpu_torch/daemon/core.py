"""The always-on streaming controller loop: ``cdrs_tpu/daemon/core.py`` on
the port's controller.

:class:`StreamDaemon` drives a ``control.ReplicationController`` window by
window over a live stream: a growing ``.cdrsb`` log (the tailer) or an
in-process feed of ``EventLog`` batches.  Windows come from the batch
loop's own carver (``control.windows.iter_windows``) and each one runs
through the controller's ``process_window``, so the daemon makes exactly
the decisions of the batch ``run`` over the same stream.  Around that
loop it adds:

* **epoch publication** — every processed window's plan freezes into a
  ``PlacementEpoch`` over a new ``placement_fn.EpochMap`` revision of the
  controller's topology (the fault path's, else ``cfg.topology``, else
  flat), published by one reference swap (resolution is lazy, per request
  batch);
* **live alerting** — each record feeds ``obs.alerts.AlertEngine``; a
  page-severity alert lands a protective checkpoint at once;
* **cursor checkpoints** — the controller's snapshot carries the ingest
  cursor (byte offset of the block holding the first unprocessed event,
  events to skip in it) in its meta blob, so a resume reads only new data;
* **graceful stop** — SIGTERM sets a flag; the window in flight finishes,
  a checkpoint lands, buffered events of the next window stay unfolded
  and are re-read on resume, so a stopped and resumed daemon gives the
  uninterrupted run's records bit for bit;
* **lag and brownout** — the decision lag (from log bytes and
  timestamps, never the wall clock) drives ``daemon.brownout``'s ladder,
  whose ``coalesce`` rung merges pending windows into one decision; a
  window with fault events is never merged (the controller applies a
  window's events at its own index only);
* **decision tracing** — with a metrics sink, one ``decision_trace``
  event per decision whose integer-ns segments sum to its total, the
  slowest ``trace_exemplars`` with their span trees;
* **mini-batch tracking** (``recluster="minibatch"``) — one Sculley step
  per window on the device snapshot: rows drawn on the host with the
  reference's numpy generator and call, gathered on the device, one fused
  Lloyd launch (``ops/kmeans_stream.minibatch_update``), the inertia one
  device reduction read once.  Observability only: records and plans do
  not depend on it;
* **the live operational plane** (``attach_http``, obs/httpz.py) — one
  immutable ``ObsSnapshot`` published per processed window, readiness
  from the first epoch until the drain, the tailer's poll as the liveness
  heartbeat.  Off the decision path: records are the same with it.

Not ported yet: the ambient telemetry spans (ROADMAP A10b).  ``run`` holds
the loop inside ``device.deterministic()``, as the controller's ``run``
does.
"""

from __future__ import annotations

import heapq
import os
import signal
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..cluster.placement import ClusterTopology
from ..control.windows import _concat, _slice, iter_windows
from ..device import deterministic
from ..io.events import EventLog, is_binary_log
from ..obs.alerts import SEVERE_ALERTS, AlertEngine, default_rules
from ..obs.sink import JsonlSink
from ..obs.trace import STAGE_ORDER, build_span_tree, decision_trace_id
from ..ops.kmeans_stream import MiniBatchKMeans
from ..placement_fn import EpochMap
from .brownout import RUNGS, BrownoutConfig, BrownoutLadder
from .epochs import EpochPublisher, PlacementEpoch
from .tailer import tail_binary_log

__all__ = ["DaemonConfig", "StreamDaemon"]

_RECLUSTER_MODES = ("controller", "minibatch")

#: Decision-latency samples kept before the reservoir decimates 2:1 (the
#: reference's ``obs.telemetry.HIST_RAW_CAP``).
HIST_RAW_CAP = 8192


@dataclass
class DaemonConfig:
    """Daemon-side knobs; every decision knob is the controller's."""

    #: Tail the log for appended blocks (False = process to EOF once).
    follow: bool = False
    #: Poll cadence of the follow-mode tailer, seconds.
    poll: float = 0.5
    #: Checkpoint every N processed windows (and once at exit).
    checkpoint_every: int = 1
    #: Stop after this many windows processed in this run (None = no cap).
    max_windows: int | None = None
    #: Stop after this much wall clock, seconds (None = no cap).
    max_seconds: float | None = None
    #: "controller", or "minibatch": also one mini-batch step per window.
    recluster: str = "controller"
    #: Rows drawn from the feature snapshot per mini-batch step.
    minibatch_rows: int = 2048
    #: Seed of the EpochMap hash placement.
    placement_seed: int = 0
    #: The N slowest decisions so far keep their span tree in their
    #: ``decision_trace`` event (0 = none).
    trace_exemplars: int = 8
    #: Brownout ladder; None keeps every record as the batch run's.
    brownout: BrownoutConfig | None = None

    def __post_init__(self):
        if self.recluster not in _RECLUSTER_MODES:
            raise ValueError(f"unknown recluster mode {self.recluster!r} "
                             f"(want one of {_RECLUSTER_MODES})")
        if self.poll <= 0:
            raise ValueError(f"poll must be > 0, got {self.poll}")
        if self.trace_exemplars < 0:
            raise ValueError(f"trace_exemplars must be >= 0, got {self.trace_exemplars}")


@dataclass
class _Inflight:
    """An ingested batch still overlapping an unprocessed window."""

    offset: int        # block-boundary byte offset (0 for feeds)
    base: int          # events to skip at ``offset`` before this batch
    ts: np.ndarray     # the batch's timestamps


class StreamDaemon:
    """Drive a ReplicationController over a live stream.

    ``run`` takes a ``.cdrsb`` path (tailed; a CSV log raises), an
    ``EventLog``, or an iterable of ``EventLog`` batches.  For feeds the
    resume cursor is an event count: the feed must replay from its start.
    """

    def __init__(self, controller, cfg: DaemonConfig | None = None, *, rules=None):
        self.controller = controller
        self.cfg = cfg or DaemonConfig()
        self.publisher = EpochPublisher()
        self.engine = AlertEngine(rules if rules is not None else default_rules())
        self.records: list[dict] = []
        self.alert_log: list[dict] = []
        self.decision_seconds: list[float] = []
        self.minibatch: dict | None = None
        self.alert_checkpoints = 0
        self.checkpoint_count = 0
        self.windows_processed = 0
        self.events_ingested = 0
        self._stop = threading.Event()
        self._stop_reason: str | None = None
        self._cursor = {"offset": 0, "skip": 0}
        self._inflight: list[_Inflight] = []
        self._tail = (0, 0)       # cursor when nothing is in flight
        self._emap = None
        self._flat_topo = None
        self._mbk = None
        # Decision-latency reservoir: sample i is kept iff i % stride == 0;
        # the stride doubles each time the list fills.
        self._dec_seen = 0
        self._dec_stride = 1
        self.traced_decisions = 0
        self._ingest_box: dict = {"ns": 0}
        self._batch_cursor = (0, 0)   # (offset, skip) of the last batch
        self._prev_end_ns = 0
        # (total_ns, window, event) of the slowest decisions, a min-heap.
        self._exemplar_heap: list[tuple[int, int, dict]] = []
        self._publish_info: dict[int, tuple[int, int, str]] = {}
        self._pins_seen: set[int] = set()
        self._last_epoch_id = 0
        self._source_path: str | None = None
        # Lag: how far the cursor trails the log head, re-measured after
        # every window from the log's bytes and the consumed log's own
        # block-size and timestamp-density averages (never the wall clock).
        self._lag = {"bytes": 0, "blocks": 0.0, "seconds": 0.0, "windows": 0.0}
        self._bytes_ingested = 0
        self._blocks_ingested = 0
        self._counted_upto = 0
        self._ts_first: float | None = None
        self._ts_last: float | None = None
        self._ladder = None if self.cfg.brownout is None else BrownoutLadder(self.cfg.brownout)
        self._degraded: frozenset = frozenset()
        self._exemplar_cap = int(self.cfg.trace_exemplars)
        self.brownout_log: list[dict] = []
        self.windows_coalesced = 0
        self.reads_shed_total = 0
        # The live operational plane (``attach_http``) and the running totals
        # its snapshots carry.
        self._obs = None
        self._reclusters = 0
        self._bytes_migrated = 0
        self._stage_ns: dict[str, int] = {}

    # -- lifecycle ---------------------------------------------------------
    def attach_http(self, server) -> None:
        """Attach an ``obs.httpz.ObsServer``: one snapshot per processed
        window, plus the readiness and health bits.  Call before :meth:`run`;
        the caller owns the server's lifecycle."""
        self._obs = server
        server.heartbeat()

    def request_stop(self, reason: str = "requested") -> None:
        """Stop after the window in flight (thread- and signal-safe)."""
        if self._stop_reason is None:
            self._stop_reason = reason
        self._stop.set()
        obs = self._obs
        if obs is not None:
            # The drain begins now: readiness drops before the window ends.
            obs.set_draining(True)

    def install_signal_handlers(self, signals=(signal.SIGTERM, signal.SIGINT)) -> None:
        """SIGTERM/SIGINT -> finish the window, checkpoint, return (main
        thread only)."""
        for s in signals:
            signal.signal(s, lambda signum, frame: self.request_stop(
                signal.Signals(signum).name))

    # -- ingest ------------------------------------------------------------
    def _ingest_stop(self) -> bool:
        """The tailer's stop probe, also the liveness heartbeat: it runs at
        every poll and batch boundary."""
        obs = self._obs
        if obs is not None:
            obs.heartbeat()
        return self._stop.is_set()

    def _batches(self, source):
        """Any source as EventLog batches, each registered in ``_inflight``
        so a checkpoint can name the position of the first unprocessed
        event."""
        skip = int(self._cursor["skip"])
        if isinstance(source, (str, bytes, os.PathLike)):
            if os.path.exists(source) and not is_binary_log(source):
                raise ValueError(
                    f"daemon ingest needs the binary event log (.cdrsb), got a CSV/unknown "
                    f"file: {source!r} — produce one with `simulate --format binary` or "
                    f"EventLog.write_binary")
            stream = tail_binary_log(str(source), self.controller.manifest,
                                     follow=self.cfg.follow, poll=self.cfg.poll,
                                     stop=self._ingest_stop,
                                     start_offset=int(self._cursor["offset"]),
                                     ingest_box=self._ingest_box)
            for ev, off, nxt in stream:
                # Lag calibration over everything consumed, skipped blocks
                # included; the high-water mark keeps a resume from counting
                # a re-read block twice.
                if int(off) >= self._counted_upto:
                    self._bytes_ingested += int(nxt - off)
                    self._blocks_ingested += 1
                    self._counted_upto = int(nxt)
                    if len(ev):
                        if self._ts_first is None:
                            self._ts_first = float(ev.ts[0])
                        self._ts_last = float(ev.ts[-1])
                base = 0
                if skip:
                    take = min(skip, len(ev))
                    skip -= take
                    if take == len(ev):
                        self._tail = (nxt, 0)
                        continue
                    ev = _slice(ev, take, len(ev))
                    base = take
                self._inflight.append(_Inflight(off, base, ev.ts))
                self._batch_cursor = (off, base)
                self._tail = (nxt, 0)
                self.events_ingested += len(ev)
                yield ev
            return
        if int(self._cursor["offset"]):
            raise ValueError("resume cursor carries a byte offset but the source is an "
                             "in-process feed — the checkpoint belongs to a binary-log daemon")
        feed = iter([source]) if isinstance(source, EventLog) else iter(source)
        gidx = 0
        for ev in feed:
            if self._stop.is_set():
                return
            n = len(ev)
            if n:
                if self._ts_first is None:
                    self._ts_first = float(ev.ts[0])
                self._ts_last = float(ev.ts[-1])
            if skip:
                take = min(skip, n)
                skip -= take
                gidx += take
                if take == n:
                    self._tail = (0, gidx)
                    continue
                ev = _slice(ev, take, n)
            self._inflight.append(_Inflight(0, gidx, ev.ts))
            # No tailer stamps a feed: its arrival is the yield.
            self._ingest_box["ns"] = time.perf_counter_ns()
            self._batch_cursor = (0, gidx)
            gidx += len(ev)
            self._tail = (0, gidx)
            self.events_ingested += len(ev)
            yield ev

    def _advance_cursor(self, w: int) -> None:
        """After window ``w`` closed: the cursor is the position of the
        first event of window ``w + 1``, or the ingest tail when nothing
        is buffered."""
        w_end = self.controller._t0 + (w + 1) * float(self.controller.cfg.window_seconds)
        keep: list[_Inflight] = []
        cursor = None
        for fl in self._inflight:
            cut = int(np.searchsorted(fl.ts, w_end, side="left"))
            if cut < len(fl.ts):
                if cursor is None:
                    cursor = (fl.offset, fl.base + cut)
                keep.append(fl)
        self._inflight = keep
        off, sk = cursor if cursor is not None else self._tail
        self._cursor = {"offset": int(off), "skip": int(sk)}

    # -- overload: lag + brownout ------------------------------------------
    def _update_lag(self, w: int) -> None:
        """Decision lag after window ``w``: bytes from the cursor to the log
        head (exact), blocks and stream seconds estimated from the consumed
        log's averages, windows = seconds over the grid.  A feed has no
        byte head: its lag is the buffered, unprocessed timestamp span."""
        ctl = self.controller
        W = float(ctl.cfg.window_seconds)
        w_end = float(ctl._t0) + (w + 1) * W
        lag_bytes = 0
        if self._source_path is not None:
            try:
                lag_bytes = max(0, os.path.getsize(self._source_path)
                                - int(self._cursor["offset"]))
            except OSError:
                pass
        lag_blocks = 0.0
        lag_seconds = 0.0
        if lag_bytes and self._blocks_ingested and self._bytes_ingested:
            lag_blocks = lag_bytes / max(self._bytes_ingested / self._blocks_ingested, 1.0)
            if self._ts_first is not None and self._ts_last > self._ts_first:
                lag_seconds = lag_bytes * ((self._ts_last - self._ts_first)
                                           / self._bytes_ingested)
        buf_last = None
        for fl in self._inflight:
            if len(fl.ts):
                t = float(fl.ts[-1])
                buf_last = t if buf_last is None else max(buf_last, t)
        if buf_last is not None and buf_last > w_end:
            lag_seconds = max(lag_seconds, buf_last - w_end)
        self._lag = {"bytes": int(lag_bytes), "blocks": float(lag_blocks),
                     "seconds": float(lag_seconds), "windows": max(0.0, lag_seconds / W)}

    def _apply_brownout(self) -> None:
        """Install the ladder's engaged modes: the controller's degraded set
        and serve shed, and the daemon's exemplar cap."""
        modes = self._ladder.modes()
        self._degraded = modes
        ctl = self.controller
        ctl.degraded_modes = modes
        bcfg = self.cfg.brownout
        ctl.serve_shed = ((float(bcfg.shed_fraction), int(bcfg.shed_seed))
                          if "shed_reads" in modes else None)
        self._exemplar_cap = 0 if "cap_trace" in modes else int(self.cfg.trace_exemplars)

    def _step_ladder(self, w: int, rec: dict, sink) -> None:
        """One ladder step after each decision: a rung engaged here first
        affects the next window."""
        for t in self._ladder.step(w, self._lag["windows"],
                                   slo_burn=float(rec.get("slo_burn") or 0.0)):
            ev = {"kind": f"degraded.brownout.{t['state']}", **t}
            self.brownout_log.append(ev)
            if sink is not None:
                sink.emit(ev)
        self._apply_brownout()

    def _coalesce(self, win_iter, w: int, events):
        """Merge up to ``coalesce_max`` consecutive pending windows onto the
        last one and decide once over their union (every event folds once;
        the group size is a function of the lag).  A window with fault
        events is never merged: the group stops before it, and a faulted
        ``w`` runs alone.  Returns ``(last_w, events, n_merged, pending)``:
        ``pending`` is a pulled window the caller processes next."""
        group = min(int(self.cfg.brownout.coalesce_max), 1 + int(self._lag["windows"]))
        sched = self.controller._fault_schedule
        if group <= 1 or (sched is not None and len(sched.for_window(w))):
            return w, events, 1, None
        parts = [events]
        last = w
        pending = None
        while last - w + 1 < group:
            if sched is not None and len(sched.for_window(last + 1)):
                break
            try:
                nw, nev = next(win_iter)
            except StopIteration:
                break
            if nw != last + 1:   # the carver is consecutive; defensive
                pending = (nw, nev)
                break
            parts.append(nev)
            last = nw
        if last == w:
            return w, events, 1, pending
        return last, _concat(parts, self.controller.manifest), last - w + 1, pending

    # -- per-window actions ------------------------------------------------
    def _publish(self, w: int, rec: dict, trace_id: str | None = None) -> PlacementEpoch:
        ctl = self.controller
        if ctl._cluster_state is not None:
            topo = ctl._cluster_state.topology
        elif ctl.cfg.topology is not None:
            topo = ctl.cfg.topology
        else:
            if self._flat_topo is None:
                self._flat_topo = ClusterTopology(nodes=tuple(ctl.manifest.nodes))
            topo = self._flat_topo
        if self._emap is None:
            self._emap = EpochMap(ctl.manifest.nodes, topo, seed=self.cfg.placement_seed)
        # Every admitted plan is a new map revision (the topology is fixed).
        map_ep = self._emap.advance(topo)
        rf = ctl.current_rf.copy()
        cat = ctl.current_cat.copy()
        emap, prim = self._emap, ctl.manifest.primary_node_id

        def resolver(uniq, _eid=map_ep.epoch_id, _rf=rf):
            slots, _ = emap.placement(_eid, np.asarray(uniq), _rf[uniq], prim[uniq])
            return slots

        epoch = self.publisher.publish(PlacementEpoch(
            epoch_id=self.publisher.published_total + 1, window=int(w),
            plan_hash=str(rec.get("plan_hash", "")), rf=rf, category_idx=cat,
            n_nodes=len(topo.nodes), map_epoch_id=map_ep.epoch_id,
            resolver=resolver, trace_id=trace_id))
        self._last_epoch_id = int(epoch.epoch_id)
        if trace_id is not None:
            # Kept until the epoch's first pin (``_drain_pins``); dropped
            # once 256 publications behind.
            self._publish_info[int(epoch.epoch_id)] = (time.perf_counter_ns(), int(w), trace_id)
            stale = epoch.epoch_id - 256
            for eid in [e for e in self._publish_info if e < stale]:
                del self._publish_info[eid]
        if self._obs is not None and not self._stop.is_set():
            self._obs.set_ready(True)   # an epoch exists to pin
        return epoch

    def _observe_alerts(self, rec: dict, sink, checkpoint_path: str | None) -> None:
        for t in self.engine.observe({"kind": "window", **rec}):
            self.alert_log.append(t)
            if sink is not None:
                sink.emit({"kind": "alert", **t})
            if t.get("state") == "firing" and t.get("alert") in SEVERE_ALERTS \
                    and checkpoint_path:
                # A page-severity alert lands a protective snapshot at once.
                self._save(checkpoint_path)
                self.alert_checkpoints += 1

    def _minibatch_step(self) -> None:
        """One mini-batch Lloyd step on the device snapshot (see the module
        docstring): the same rows as the reference, one kernel launch."""
        ctl = self.controller
        X = ctl._feature_snapshot()
        k = int(ctl.cfg.kmeans.k)
        if self._mbk is None:
            self._mbk = MiniBatchKMeans(k=k, seed=ctl.cfg.kmeans.seed, device=X.device)
        n_b = self._mbk.state.n_batches if self._mbk.state else 0
        rng = np.random.default_rng((int(ctl.cfg.kmeans.seed or 0) << 16) ^ n_b)
        rows = min(max(int(self.cfg.minibatch_rows), k), len(X))
        idx = np.sort(rng.choice(len(X), size=rows, replace=False))
        sample = X[torch.from_numpy(idx).to(X.device)]
        self._mbk.partial_fit(sample)
        d = sample[:, None, :] - self._mbk.centroids[None, :, :]
        inertia = torch.mean(torch.min((d * d).sum(-1), dim=1).values)
        self.minibatch = {"n_batches": int(self._mbk.state.n_batches),
                          "inertia": float(inertia)}

    def _record_decision(self, seconds: float) -> None:
        """Bounded reservoir: 2:1 decimation past ``HIST_RAW_CAP``."""
        if self._dec_seen % self._dec_stride == 0:
            lst = self.decision_seconds
            lst.append(float(seconds))
            if len(lst) >= HIST_RAW_CAP:
                del lst[1::2]
                self._dec_stride *= 2
        self._dec_seen += 1

    def _emit_decision_trace(self, sink, w: int, trace_id: str, rec: dict,
                             epoch: PlacementEpoch, segments_ns: dict, total_ns: int,
                             ref_ns: int, n_events: int) -> None:
        """One ``decision_trace`` event, emitted when ``sink`` is given; the
        ``trace_exemplars`` slowest so far also embed their span tree (kept
        for ``/debug/trace`` with or without a sink)."""
        ev = {
            "kind": "decision_trace", "trace": trace_id, "window": int(w),
            "total_ns": int(total_ns),
            "segments_ns": {k: int(v) for k, v in segments_ns.items()},
            "ref_ns": int(ref_ns), "n_events": int(n_events),
            "epoch_id": int(epoch.epoch_id), "map_epoch_id": int(epoch.map_epoch_id),
            "plan_hash": epoch.plan_hash,
            "batch": {"offset": int(self._batch_cursor[0]),
                      "skip": int(self._batch_cursor[1])},
        }
        # The live cap: the ladder's ``cap_trace`` rung zeroes it.
        cap = int(self._exemplar_cap)
        exemplar = cap > 0 and (len(self._exemplar_heap) < cap
                                or (int(total_ns), int(w)) > self._exemplar_heap[0][:2])
        ev["exemplar"] = exemplar
        if exemplar:
            ev["spans"] = build_span_tree(ev, rec)
            item = (int(total_ns), int(w), ev)
            if len(self._exemplar_heap) < cap:
                heapq.heappush(self._exemplar_heap, item)
            else:
                heapq.heapreplace(self._exemplar_heap, item)
        if sink is not None:
            sink.emit(ev)
            self.traced_decisions += 1

    def _drain_pins(self, sink) -> None:
        """First serve-path pins as ``epoch_pin`` events (publish-to-pin
        latency); entries of epochs older than the latest are pruned."""
        fp = self.publisher.first_pins
        for eid in sorted(fp):
            if eid not in self._pins_seen:
                self._pins_seen.add(eid)
                ev = {"kind": "epoch_pin", "epoch_id": int(eid)}
                info = self._publish_info.get(eid)
                if info is not None:
                    pub_ns, win, tid = info
                    ev["window"] = win
                    ev["trace"] = tid
                    ev["publish_to_pin_ns"] = int(fp[eid] - pub_ns)
                sink.emit(ev)
            if eid < self._last_epoch_id:
                fp.pop(eid, None)
                self._pins_seen.discard(eid)
                self._publish_info.pop(eid, None)

    def _publish_snapshot(self, w: int, rec: dict, segments_ns: dict) -> None:
        """Build one ``ObsSnapshot`` and install it by one reference swap;
        runs after the decision's segment clocks close."""
        from ..obs.httpz import ObsSnapshot

        # The decide segment expands into the controller's stages, scaled to
        # the segment's integer nanoseconds.
        secs = rec.get("seconds") or {}
        decide_ns = int(segments_ns.get("decide", 0))
        stage_sum = sum(float(secs[k]) for k in STAGE_ORDER if k in secs)
        for name, ns in segments_ns.items():
            if name == "decide" and decide_ns > 0 and stage_sum > 0:
                for k in STAGE_ORDER:
                    if k in secs:
                        self._stage_ns[k] = self._stage_ns.get(k, 0) + int(
                            round(float(secs[k]) / stage_sum * decide_ns))
                continue
            self._stage_ns[name] = self._stage_ns.get(name, 0) + int(ns)
        total_stage = sum(self._stage_ns.values()) or 1
        order = ("tail",) + STAGE_ORDER + ("decide", "observe", "publish", "minibatch")
        stages = tuple((name, self._stage_ns[name] / 1e9, self._stage_ns[name] / total_stage)
                       for name in order if name in self._stage_ns)
        self._reclusters += 1 if rec.get("recluster") else 0
        self._bytes_migrated += int(rec.get("bytes_migrated", 0) or 0)
        backlog_bytes = 0
        if self._source_path is not None:
            try:
                # Block-granular: the log at and after the resume cursor.
                backlog_bytes = max(0, os.path.getsize(self._source_path)
                                    - int(self._cursor["offset"]))
            except OSError:
                pass
        # Buffered events past the closed window (a batch keeps its whole ts).
        w_end = self.controller._t0 + (w + 1) * float(self.controller.cfg.window_seconds)
        backlog_events = int(sum(len(fl.ts) - int(np.searchsorted(fl.ts, w_end, side="left"))
                                 for fl in self._inflight))
        lat = self.decision_seconds
        arr = np.asarray(lat, dtype=np.float64)
        alerts = tuple({k: r[k] for k in ("name", "severity", "kind", "firing", "fired",
                                          "since", "streak")}
                       for r in self.engine.results())
        self._obs.publish(ObsSnapshot(
            seq=int(self.windows_processed),
            epoch_id=int(self._last_epoch_id) or None,
            window=int(w),
            windows_processed=int(self.windows_processed),
            events_ingested=int(self.events_ingested),
            epochs_published=int(self.publisher.published_total),
            checkpoints_written=int(self.checkpoint_count),
            reclusters=int(self._reclusters),
            bytes_migrated=int(self._bytes_migrated),
            traced_decisions=int(self.traced_decisions),
            backlog_events=backlog_events,
            backlog_bytes=int(backlog_bytes),
            lag_bytes=int(self._lag["bytes"]),
            lag_blocks=round(float(self._lag["blocks"]), 3),
            lag_seconds=round(float(self._lag["seconds"]), 3),
            lag_windows=round(float(self._lag["windows"]), 3),
            brownout_level=0 if self._ladder is None else int(self._ladder.level),
            brownout_rungs=() if self._ladder is None else tuple(RUNGS[:self._ladder.level]),
            reads_shed=int(self.reads_shed_total),
            windows_coalesced=int(self.windows_coalesced),
            decision_seconds=tuple(lat),
            decision_p50_seconds=(None if arr.size == 0
                                  else round(float(np.quantile(arr, 0.5)), 6)),
            decision_p99_seconds=(None if arr.size == 0
                                  else round(float(np.quantile(arr, 0.99)), 6)),
            stages=stages,
            alerts=alerts,
            exemplars=tuple(ev for _t, _w, ev in sorted(self._exemplar_heap,
                                                        key=lambda it: it[1])),
        ))

    def _save(self, path: str) -> None:
        dmeta = {
            "offset": int(self._cursor["offset"]),
            "skip": int(self._cursor["skip"]),
            "epochs_published": int(self.publisher.published_total),
            # The lag estimator's calibration and last lag vector: the next
            # decision's coalescing reads them, so a resume must see them.
            "lag_est": {"bytes": int(self._bytes_ingested),
                        "blocks": int(self._blocks_ingested),
                        "upto": int(self._counted_upto),
                        "ts_first": self._ts_first, "ts_last": self._ts_last},
            "lag": dict(self._lag),
        }
        if self._ladder is not None:
            dmeta["brownout"] = self._ladder.state_dict()
            dmeta["windows_coalesced"] = int(self.windows_coalesced)
            dmeta["reads_shed"] = int(self.reads_shed_total)
        self.controller.save_checkpoint(path, extra_meta={"daemon": dmeta})
        self.checkpoint_count += 1

    def _restore(self, checkpoint_path: str) -> None:
        """Load the controller's snapshot and the daemon meta it carries."""
        ctl = self.controller
        ctl._load_checkpoint_with_fallback(checkpoint_path)
        dmeta = (ctl.last_checkpoint_meta or {}).get("daemon") or {}
        self._cursor = {"offset": int(dmeta.get("offset", 0)),
                        "skip": int(dmeta.get("skip", 0))}
        self._tail = (self._cursor["offset"], self._cursor["skip"])
        self.publisher.published_total = int(dmeta.get("epochs_published", 0))
        est = dmeta.get("lag_est") or {}
        self._bytes_ingested = int(est.get("bytes", 0))
        self._blocks_ingested = int(est.get("blocks", 0))
        self._counted_upto = int(est.get("upto", 0))
        self._ts_first = est.get("ts_first")
        self._ts_last = est.get("ts_last")
        if dmeta.get("lag"):
            self._lag = {k: dmeta["lag"].get(k, 0)
                         for k in ("bytes", "blocks", "seconds", "windows")}
        if self._ladder is not None:
            self._ladder.load_state_dict(dmeta.get("brownout") or {})
            self.windows_coalesced = int(dmeta.get("windows_coalesced", 0))
            self.reads_shed_total = int(dmeta.get("reads_shed", 0))
            self._apply_brownout()

    # -- the loop ----------------------------------------------------------
    def run(self, source, *, metrics_path: str | None = None,
            metrics_max_bytes: int | None = None,
            checkpoint_path: str | None = None) -> dict:
        """Ingest -> carve -> decide -> publish until the stream ends
        (without ``follow``), a cap is reached or a stop arrives.  Returns
        :meth:`digest`."""
        with deterministic():
            return self._run(source, metrics_path, metrics_max_bytes, checkpoint_path)

    def _run(self, source, metrics_path, metrics_max_bytes, checkpoint_path) -> dict:
        ctl = self.controller
        cfg = self.cfg
        if isinstance(source, (str, bytes, os.PathLike)):
            self._source_path = os.fspath(source)
        if checkpoint_path:
            self._restore(checkpoint_path)
        # Decision tracing rides the metrics sink.
        sink = JsonlSink(metrics_path, max_bytes=metrics_max_bytes) if metrics_path \
            else None
        trace_on = sink is not None
        if trace_on:
            self.publisher.record_pins = True
        deadline = (time.monotonic() + float(cfg.max_seconds)
                    if cfg.max_seconds is not None else None)
        every = max(1, int(cfg.checkpoint_every))
        since_ckpt = 0
        t0_box: dict = {}
        win_iter = iter_windows(self._batches(source), ctl.manifest, ctl.cfg.window_seconds,
                                t0=ctl._t0, t0_out=t0_box)
        pending: tuple | None = None   # pulled by the coalescer, not merged
        try:
            while True:
                if pending is not None:
                    w, events = pending
                    pending = None
                else:
                    try:
                        w, events = next(win_iter)
                    except StopIteration:
                        if self._stop_reason is None:
                            self._stop_reason = "end_of_stream"
                        break
                if self._stop.is_set():
                    # Includes the carver's flush of a partial window after a
                    # stopped tail: those events stay for the resume.
                    break
                if ctl._t0 is None:
                    ctl._t0 = t0_box.get("t0")
                if w < ctl.window_index:
                    # Planned before the checkpoint: events re-read past the
                    # cursor are a late tail of that window; fold them.
                    if len(events):
                        ctl._fold_window(events, new_window=False)
                        ctl._last_window_events += len(events)
                        self._advance_cursor(w)
                        since_ckpt += 1
                    continue
                coalesced = 1
                if self._ladder is not None and "coalesce" in self._degraded:
                    w, events, coalesced, pending = self._coalesce(win_iter, w, events)
                # Segment clocks: consecutive reads of one integer clock, so
                # the segments sum to the total exactly.  ``ref`` is the
                # ingest of the closing batch or the previous decision's end,
                # whichever is later.
                t_start = time.perf_counter_ns()
                ref = max(self._ingest_box["ns"], self._prev_end_ns)
                if ref == 0 or ref > t_start:
                    ref = t_start
                tid = decision_trace_id(w)
                rec = ctl.process_window(w, events)
                t1 = time.perf_counter_ns()
                ctl.window_index = w + 1
                ctl._last_window_events = len(events)
                # The cursor advances with the window index, before anything
                # below can land a checkpoint (the alert path's save first):
                # a snapshot with the new index and the old cursor would fold
                # window w twice on resume.
                self._advance_cursor(w)
                self._update_lag(w)
                if self._ladder is not None:
                    # Only under a brownout config, so that otherwise the
                    # records stay the batch run's.
                    rec["daemon"] = {
                        "lag_bytes": int(self._lag["bytes"]),
                        "lag_blocks": round(self._lag["blocks"], 3),
                        "lag_seconds": round(self._lag["seconds"], 3),
                        "lag_windows": round(self._lag["windows"], 3),
                        "brownout_level": int(self._ladder.level),
                        "coalesced": int(coalesced),
                    }
                    if coalesced > 1:
                        self.windows_coalesced += coalesced - 1
                    self.reads_shed_total += int(rec.get("reads_shed") or 0)
                self.records.append(rec)
                if sink is not None:
                    sink.emit({"kind": "window", **rec})
                self._observe_alerts(rec, sink, checkpoint_path)
                t2 = time.perf_counter_ns()
                epoch = self._publish(w, rec, trace_id=tid if trace_on else None)
                t3 = time.perf_counter_ns()
                t4 = t3
                did_minibatch = (cfg.recluster == "minibatch"
                                 and "skip_minibatch" not in self._degraded)
                if did_minibatch:
                    self._minibatch_step()
                    t4 = time.perf_counter_ns()
                segments = {"tail": t_start - ref, "decide": t1 - t_start,
                            "observe": t2 - t1, "publish": t3 - t2}
                if did_minibatch:
                    segments["minibatch"] = t4 - t3
                self._record_decision((t4 - t_start) / 1e9)
                if trace_on or self._obs is not None:
                    # Exemplars also feed /debug/trace: a sink-less run with
                    # the plane attached builds the events without emitting.
                    self._emit_decision_trace(sink, w, tid, rec, epoch, segments,
                                              t4 - ref, ref, len(events))
                if trace_on:
                    self._drain_pins(sink)
                self._prev_end_ns = t4
                self.windows_processed += 1
                since_ckpt += 1
                if self._ladder is not None:
                    self._step_ladder(w, rec, sink)
                if self._obs is not None:
                    self._publish_snapshot(w, rec, segments)
                if checkpoint_path and since_ckpt >= every:
                    self._save(checkpoint_path)
                    since_ckpt = 0
                if cfg.max_windows is not None \
                        and self.windows_processed >= int(cfg.max_windows):
                    self.request_stop("max_windows")
                if deadline is not None and time.monotonic() > deadline:
                    self.request_stop("max_seconds")
        finally:
            if sink is not None:
                sink.close()
            if self._obs is not None:
                # The loop is over: a pinned epoch stays with its holders,
                # but no new work should come here.
                self._obs.set_ready(False)
        if checkpoint_path and since_ckpt:
            self._save(checkpoint_path)
        return self.digest()

    # -- reporting ---------------------------------------------------------
    def digest(self) -> dict:
        """A JSON-able summary of the run (the CLI prints it)."""
        lat = np.asarray(self.decision_seconds, dtype=np.float64)
        cur = self.publisher.peek()   # reporting: never a serve-path pin
        out = {
            "windows_processed": int(self.windows_processed),
            "window_index": int(self.controller.window_index),
            "events_ingested": int(self.events_ingested),
            "epochs_published": int(self.publisher.published_total),
            "current_epoch": None if cur is None else int(cur.epoch_id),
            "plan_hash": None if cur is None else cur.plan_hash,
            "alerts_fired": sorted({t["alert"] for t in self.alert_log
                                    if t.get("state") == "firing"}),
            "alert_checkpoints": int(self.alert_checkpoints),
            "checkpoints": int(self.checkpoint_count),
            "decision_p50_seconds": (None if lat.size == 0
                                     else round(float(np.quantile(lat, 0.5)), 6)),
            "decision_p99_seconds": (None if lat.size == 0
                                     else round(float(np.quantile(lat, 0.99)), 6)),
            "traced_decisions": int(self.traced_decisions),
            "stop_reason": self._stop_reason,
            "cursor": dict(self._cursor),
        }
        if self.minibatch is not None:
            out["minibatch"] = dict(self.minibatch)
        if self._ladder is not None:
            out["lag"] = {"bytes": int(self._lag["bytes"]),
                          "blocks": round(float(self._lag["blocks"]), 3),
                          "seconds": round(float(self._lag["seconds"]), 3),
                          "windows": round(float(self._lag["windows"]), 3)}
            out["brownout"] = {"level": int(self._ladder.level),
                               "rungs": list(RUNGS[:self._ladder.level]),
                               "transitions": len(self.brownout_log),
                               "windows_coalesced": int(self.windows_coalesced),
                               "reads_shed": int(self.reads_shed_total)}
        return out
