"""Vectorized read router: ``cdrs_tpu/serve/router.py``, host numpy, identical
to it bit for bit.

The router serves one time-ordered batch of reads against a replica map:

* **Replica selection** among each file's reachable slots.  A client that
  holds a replica reads locally (the short-circuit read, applied after
  selection so that the load-feedback policies charge their busy time in
  order).  Remote reads pick by policy: ``primary`` (first reachable
  slot), ``random`` (seeded uniform), ``least_loaded`` (the holder with the
  least busy time) or ``p2c`` (two seeded probes, keep the less loaded).
  The load-feedback policies route in chunks of ``ServeConfig.chunk``
  reads against a load snapshot taken at the chunk boundary.
* **Queue model**: one FIFO server per node with the constant service time
  ``service_ms / node_throughput``; the recurrence ``f_k = max(a_k,
  f_{k-1}) + s`` has the closed form ``f_k = s(k+1) + cummax(a_j - s j)``,
  so every read gets an exact latency sample.
* **SLO accounting**: reads over ``SloSpec.target_ms`` plus unavailable
  reads, over the error budget ``1 - availability``, is the window's burn.
* **Detect-on-read** (``slot_corrupt`` with ``verify_reads``): a read that
  selects a rotten copy redirects to the first clean reachable slot at one
  extra service time, or is refused when no clean copy is left; the unique
  (file, node) pairs go back to the caller for quarantine.

The random draws, the float64 load comparisons and ``np.percentile`` are
the reference's, which keeps every percentile equal to its.
``emit_window_telemetry`` is the one emission path of the ``serve.*``
telemetry, shared by the controller's serve plane and ``serve --metrics``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["POLICIES", "SloSpec", "ServeConfig", "WindowServeResult", "ReadRouter",
           "emit_window_telemetry"]


def emit_window_telemetry(tel, rec: dict, latency_ms=None) -> None:
    """One serving window's observations through the instrument ``tel``:
    the ``serve.*`` and read-integrity counters and gauges of the record
    (``WindowServeResult.record_fields()`` plus the hotspot fields), and
    the window's raw latency samples as one bucketed ``serve.latency_ms``
    ``hist_bulk`` event.  Nothing for a record that served no reads."""
    if rec.get("reads_routed") is None:
        return
    if rec["reads_routed"]:
        tel.counter_inc("serve.reads_routed", rec["reads_routed"])
    if rec.get("reads_unavailable"):
        tel.counter_inc("serve.reads_unavailable", rec["reads_unavailable"])
    if rec.get("reads_corrupt_served"):
        tel.counter_inc("integrity.reads_corrupt_served", rec["reads_corrupt_served"])
    if rec.get("reads_corrupt_detected"):
        tel.counter_inc("integrity.reads_corrupt_detected", rec["reads_corrupt_detected"])
    if rec.get("latency_p99_ms") is not None:
        tel.gauge("serve.latency_p50_ms", rec["latency_p50_ms"])
        tel.gauge("serve.latency_p99_ms", rec["latency_p99_ms"])
    tel.gauge("serve.utilization_max", rec.get("utilization_max", 0.0))
    tel.gauge("serve.slo_burn", rec.get("slo_burn", 0.0))
    if rec.get("hotspot_files"):
        tel.counter_inc("serve.hotspot.windows")
        tel.gauge("serve.hotspot.score", rec.get("hotspot_score", 0.0))
    if rec.get("recluster_trigger") == "hotspot":
        tel.counter_inc("serve.reclusters.hotspot")
    if latency_ms is not None and len(latency_ms):
        tel.histogram_bulk("serve.latency_ms", latency_ms)


POLICIES: tuple[str, ...] = ("primary", "random", "least_loaded", "p2c")


@dataclass(frozen=True)
class SloSpec:
    """Read-path SLO: latency target and availability objective."""

    #: A read slower than this counts against the error budget.
    target_ms: float = 10.0
    #: Fraction of reads that must be served within the target; the error
    #: budget is ``1 - availability``.
    availability: float = 0.999

    def __post_init__(self):
        if self.target_ms <= 0:
            raise ValueError(f"target_ms must be > 0, got {self.target_ms}")
        if not 0.0 < self.availability < 1.0:
            raise ValueError(f"availability must be in (0, 1), got {self.availability}")


@dataclass
class ServeConfig:
    """Knobs of the read router and the hotspot feedback."""

    policy: str = "p2c"
    #: Seed of the replica-choice draws; the controller derives the window's
    #: stream from ``(seed, window_index)`` so that a resume replays it.
    seed: int = 0
    #: Per-read service time at nominal throughput (a straggler at factor m
    #: serves one read in ``service_ms / m``).
    service_ms: float = 0.5
    #: Reads per load snapshot of ``least_loaded`` and ``p2c``.
    chunk: int = 4096
    slo: SloSpec = field(default_factory=SloSpec)
    #: Hotspot detector (``serve/hotspot.py``): EWMA smoothing, spike
    #: factor, absolute floor and the number of files on the record.
    hotspot_alpha: float = 0.3
    hotspot_spike_factor: float = 4.0
    hotspot_min_reads: int = 50
    hotspot_top_k: int = 8
    #: A fired hotspot triggers a re-cluster in its window.
    recluster_on_hotspot: bool = True
    #: Detect rotten copies on read (redirect or refuse); False serves them
    #: and only counts ``reads_corrupt_served``.
    verify_reads: bool = True

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown routing policy {self.policy!r} (want one of "
                             f"{POLICIES})")
        if self.service_ms <= 0:
            raise ValueError(f"service_ms must be > 0, got {self.service_ms}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if not 0.0 < self.hotspot_alpha <= 1.0:
            raise ValueError(f"hotspot_alpha must be in (0, 1], got {self.hotspot_alpha}")
        if self.hotspot_spike_factor <= 1.0:
            raise ValueError(f"hotspot_spike_factor must be > 1, got "
                             f"{self.hotspot_spike_factor}")
        if self.hotspot_top_k < 1:
            raise ValueError(f"hotspot_top_k must be >= 1, got {self.hotspot_top_k}")


@dataclass
class WindowServeResult:
    """One routed batch of reads and its latency and SLO digest."""

    n_reads: int                  # reads presented to the router
    n_routed: int                 # reads that found a reachable replica
    n_unavailable: int            # reads with no reachable replica
    n_local: int                  # served by the client's own node
    server: np.ndarray            # (n_reads,) int32 node id, -1 unavailable
    latency_ms: np.ndarray        # (n_routed,) float64, routed reads only
    #: None when no read was routed: a full outage has no latency sample.
    p50_ms: float | None
    p95_ms: float | None
    p99_ms: float | None
    reads_per_node: np.ndarray    # (n_nodes,) int64
    utilization: np.ndarray       # (n_nodes,) busy time / window span
    slo_violations: int           # over target + unavailable
    slo_burn: float               # violation fraction / error budget
    #: Reads that selected a rotten copy and were served (verification off)
    #: or detected (verification on: redirected or refused).
    n_corrupt_served: int = 0
    n_corrupt_detected: int = 0
    #: (k, 2) int64 unique (file, node) pairs of detected rotten copies;
    #: None when verification was off or nothing was detected.
    corrupt_pairs: np.ndarray | None = None

    @property
    def locality(self) -> float:
        """Local reads over all reads (unavailable reads are not local)."""
        return self.n_local / self.n_reads if self.n_reads else 1.0

    @property
    def utilization_max(self) -> float:
        return float(self.utilization.max()) if self.utilization.size else 0.0

    def record_fields(self) -> dict:
        """The window record's serving keys (percentiles None for a window
        that routed nothing)."""
        rnd = lambda v: None if v is None else round(v, 6)  # noqa: E731
        return {
            "reads_routed": self.n_routed,
            "reads_unavailable": self.n_unavailable,
            "serve_locality": round(self.locality, 6),
            "latency_p50_ms": rnd(self.p50_ms),
            "latency_p95_ms": rnd(self.p95_ms),
            "latency_p99_ms": rnd(self.p99_ms),
            "utilization_max": round(self.utilization_max, 6),
            "slo_violations": self.slo_violations,
            "slo_burn": round(self.slo_burn, 6),
            "reads_corrupt_served": self.n_corrupt_served,
            "reads_corrupt_detected": self.n_corrupt_detected,
        }


def _pick_rank(ok: np.ndarray, rank: np.ndarray) -> np.ndarray:
    """Slot index of the ``rank``-th True of each row of ``ok`` (rows with
    no True give slot 0; callers mask them)."""
    csum = np.cumsum(ok, axis=1)
    return np.argmax(csum > rank[:, None], axis=1).astype(np.int32)


class ReadRouter:
    """Routes read batches against a replica map (module docstring)."""

    def __init__(self, n_nodes: int, cfg: ServeConfig):
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        self.n_nodes = int(n_nodes)
        self.cfg = cfg

    def _select(self, cand: np.ndarray, ok: np.ndarray, n_ok: np.ndarray,
                service_s: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """(e,) int32 server per read, -1 unavailable; the reads are in time
        order, which the chunked load feedback consumes."""
        policy = self.cfg.policy
        e = cand.shape[0]
        any_ok = n_ok > 0
        if policy == "primary":
            slot = np.argmax(ok, axis=1)
            server = cand[np.arange(e), slot].astype(np.int32)
            server[~any_ok] = -1
            return server
        if policy == "random":
            rank = np.minimum((rng.random(e) * n_ok).astype(np.int64), np.maximum(n_ok - 1, 0))
            server = cand[np.arange(e), _pick_rank(ok, rank)].astype(np.int32)
            server[~any_ok] = -1
            return server

        server = np.full(e, -1, dtype=np.int32)
        load = np.zeros(self.n_nodes, dtype=np.float64)   # busy seconds
        chunk = self.cfg.chunk
        safe = np.clip(cand, 0, None)
        if policy == "p2c":
            # Both draws up front, r1 then r2: the reference's order.
            r1 = rng.random(e)
            r2 = rng.random(e)
        for lo in range(0, e, chunk):
            hi = min(lo + chunk, e)
            c_cand = cand[lo:hi]
            c_ok = ok[lo:hi]
            rows = np.arange(hi - lo)
            if policy == "least_loaded":
                node_load = np.where(c_ok, load[safe[lo:hi]], np.inf)
                srv = c_cand[rows, np.argmin(node_load, axis=1)].astype(np.int32)
            else:   # p2c: two probes with replacement, keep the cooler one
                n1 = np.maximum(n_ok[lo:hi] - 1, 0)
                rank1 = np.minimum((r1[lo:hi] * n_ok[lo:hi]).astype(np.int64), n1)
                rank2 = np.minimum((r2[lo:hi] * n_ok[lo:hi]).astype(np.int64), n1)
                s1 = c_cand[rows, _pick_rank(c_ok, rank1)]
                s2 = c_cand[rows, _pick_rank(c_ok, rank2)]
                srv = np.where(load[np.clip(s2, 0, None)] < load[np.clip(s1, 0, None)],
                               s2, s1).astype(np.int32)
            srv[~any_ok[lo:hi]] = -1
            server[lo:hi] = srv
            routed = srv[srv >= 0]
            if routed.size:
                load += np.bincount(routed, minlength=self.n_nodes) * service_s
        return server

    def _latency(self, server: np.ndarray, ts: np.ndarray,
                 service_s: np.ndarray) -> np.ndarray:
        """(e,) seconds, NaN for unavailable reads: the exact FIFO per node."""
        lat = np.full(server.shape[0], np.nan)
        for node in range(self.n_nodes):
            m = server == node
            if not m.any():
                continue
            a = ts[m]
            s = service_s[node]
            k = np.arange(a.size, dtype=np.float64)
            finish = s * (k + 1.0) + np.maximum.accumulate(a - s * k)
            lat[m] = finish - a
        return lat

    def route(self, replica_map: np.ndarray, slot_ok: np.ndarray,
              node_throughput: np.ndarray, *, ts: np.ndarray, pid: np.ndarray,
              client: np.ndarray, window_seconds: float | None = None,
              rng: np.random.Generator | None = None, extra_ms: np.ndarray | None = None,
              edge_ms: np.ndarray | None = None,
              slot_corrupt: np.ndarray | None = None) -> WindowServeResult:
        """Route one time-ordered batch of reads.

        ``replica_map`` (n_files, R) int32 node ids, -1 empty; ``slot_ok``
        the same shape, True where the slot can serve; ``node_throughput``
        (n_nodes,) straggler factors; ``ts``/``pid``/``client`` per read
        (ascending seconds, file row, client node or -1).  ``window_seconds``
        scales utilization (default: the batch's span).  ``extra_ms`` adds
        per-read client-side latency; ``edge_ms`` (n_nodes, n_nodes) adds
        ``[client, server]`` propagation for clients inside the topology;
        neither occupies the server.  ``slot_corrupt`` marks rotten copies
        (module docstring).
        """
        rng = rng or np.random.default_rng(self.cfg.seed)
        ts = np.asarray(ts, dtype=np.float64)
        pid = np.asarray(pid)
        client = np.asarray(client)
        e = int(pid.shape[0])
        thr = np.asarray(node_throughput, dtype=np.float64)
        service_s = (self.cfg.service_ms / 1000.0) / np.maximum(thr, 1e-9)

        if e == 0:
            z = np.zeros(self.n_nodes)
            return WindowServeResult(
                n_reads=0, n_routed=0, n_unavailable=0, n_local=0,
                server=np.zeros(0, dtype=np.int32), latency_ms=np.zeros(0),
                p50_ms=None, p95_ms=None, p99_ms=None, reads_per_node=z.astype(np.int64),
                utilization=z, slo_violations=0, slo_burn=0.0)

        cand = replica_map[pid]                       # (e, R)
        ok = slot_ok[pid]
        n_ok = ok.sum(axis=1)
        local = ((cand == client[:, None]) & ok).any(axis=1) & (client >= 0)

        server = self._select(cand, ok, n_ok, service_s, rng)
        server = np.where(local, client.astype(np.int32), server)

        n_corrupt_served = n_corrupt_detected = 0
        corrupt_pairs = None
        retry_ms = None
        if slot_corrupt is not None:
            corr = slot_corrupt[pid]                   # (e, R)
            sel_corrupt = ((cand == server[:, None]) & corr).any(axis=1) & (server >= 0)
            if sel_corrupt.any():
                if self.cfg.verify_reads:
                    n_corrupt_detected = int(sel_corrupt.sum())
                    pairs = np.stack([pid[sel_corrupt].astype(np.int64),
                                      server[sel_corrupt].astype(np.int64)], axis=1)
                    corrupt_pairs = np.unique(pairs, axis=0)
                    clean_ok = ok & ~corr
                    alt = cand[np.arange(e), np.argmax(clean_ok, axis=1)]
                    has_clean = clean_ok.any(axis=1)
                    redirect = sel_corrupt & has_clean
                    server = np.where(redirect, alt.astype(np.int32), server)
                    server[sel_corrupt & ~has_clean] = -1
                    retry_ms = np.where(redirect, float(self.cfg.service_ms), 0.0)
                    # Locality is a fact about the final server.
                    local = (server >= 0) & (server == client.astype(np.int32))
                else:
                    n_corrupt_served = int(sel_corrupt.sum())

        unavailable = server < 0
        n_unavail = int(unavailable.sum())
        lat_s = self._latency(server, ts, service_s)
        routed = ~unavailable
        latency_ms = lat_s[routed] * 1000.0
        if extra_ms is not None:
            latency_ms = latency_ms + np.asarray(extra_ms, dtype=np.float64)[routed]
        if retry_ms is not None:
            latency_ms = latency_ms + retry_ms[routed]
        if edge_ms is not None:
            cl = np.where(client >= 0, client, 0)
            hop = np.asarray(edge_ms, dtype=np.float64)[cl, np.clip(server, 0, None)]
            hop = np.where(client >= 0, hop, 0.0)
            latency_ms = latency_ms + hop[routed]

        counts = np.bincount(server[routed], minlength=self.n_nodes).astype(np.int64)
        span = float(window_seconds) if window_seconds else max(float(ts[-1] - ts[0]), 1e-9)
        utilization = counts * service_s / max(span, 1e-9)

        if latency_ms.size:
            p50, p95, p99 = (float(np.percentile(latency_ms, q)) for q in (50.0, 95.0, 99.0))
        else:
            p50 = p95 = p99 = None
        slo = self.cfg.slo
        violations = int((latency_ms > slo.target_ms).sum()) + n_unavail
        burn = (violations / e) / (1.0 - slo.availability)

        return WindowServeResult(
            n_reads=e, n_routed=int(routed.sum()), n_unavailable=n_unavail,
            n_local=int(local.sum()), server=server, latency_ms=latency_ms,
            p50_ms=p50, p95_ms=p95, p99_ms=p99, reads_per_node=counts,
            utilization=utilization, slo_violations=violations, slo_burn=float(burn),
            n_corrupt_served=n_corrupt_served, n_corrupt_detected=n_corrupt_detected,
            corrupt_pairs=corrupt_pairs)
