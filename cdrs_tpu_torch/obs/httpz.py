"""The daemon's live operational plane: ``cdrs_tpu/obs/httpz.py``.

``daemon --http HOST:PORT`` runs this stdlib ``ThreadingHTTPServer`` in a
thread of its own, off the decision path:

* ``/metrics`` — Prometheus text (obs/prom.py's renderer) with the process
  start time and build info;
* ``/healthz`` — 200 while the tailer makes progress (a fresh heartbeat)
  and no page-severity alert fires;
* ``/readyz`` — 200 once a placement epoch is published and until the
  daemon drains;
* ``/statusz`` — JSON: epoch, window, backlog, lag, brownout, firing
  alerts, decision p50/p99, per-stage shares of the decision time;
* ``/debug/trace`` — the slowest decisions kept as exemplars, as Chrome
  trace JSON (obs/trace.chrome_trace).

The daemon never hands live state to the server: once per processed
window it builds one immutable :class:`ObsSnapshot` and installs it with a
single reference assignment (:meth:`ObsServer.publish`), and a handler
reads ``snapshot`` once and renders from that object only.  So within one
response ``epochs_published == windows_processed == seq`` (one epoch a
window), and ``seq`` never goes back between responses.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import prom

__all__ = ["ObsSnapshot", "ObsServer", "EMPTY_SNAPSHOT", "STATUSZ_WALL_KEYS"]

#: /statusz keys whose values follow the wall clock or host timing; the
#: rest of /statusz is deterministic for a seeded run.
STATUSZ_WALL_KEYS = ("captured_unix", "uptime_seconds", "decision", "stages")


@dataclass(frozen=True)
class ObsSnapshot:
    """One immutable cut of daemon state, built once per processed window.

    ``decision_seconds`` is the daemon's bounded latency reservoir;
    ``stages`` the ``(stage, seconds, share)`` table of the decision time;
    ``exemplars`` the kept slowest ``decision_trace`` events (span trees
    embedded)."""

    seq: int = 0
    epoch_id: int | None = None
    window: int | None = None
    windows_processed: int = 0
    events_ingested: int = 0
    epochs_published: int = 0
    checkpoints_written: int = 0
    reclusters: int = 0
    bytes_migrated: int = 0
    traced_decisions: int = 0
    backlog_events: int = 0
    backlog_bytes: int = 0
    lag_bytes: int = 0
    lag_blocks: float = 0.0
    lag_seconds: float = 0.0
    lag_windows: float = 0.0
    brownout_level: int = 0
    brownout_rungs: tuple = ()
    reads_shed: int = 0
    windows_coalesced: int = 0
    decision_seconds: tuple = ()
    decision_p50_seconds: float | None = None
    decision_p99_seconds: float | None = None
    stages: tuple = ()
    alerts: tuple = ()
    exemplars: tuple = ()
    captured_unix: float = field(default_factory=time.time)

    def severe_firing(self) -> tuple:
        """Firing page-severity alert rows (the /healthz trip wire)."""
        return tuple(a for a in self.alerts
                     if a.get("firing") and a.get("severity") == "page")


EMPTY_SNAPSHOT = ObsSnapshot(captured_unix=0.0)


def _metrics_text(snap: ObsSnapshot) -> str:
    """The live exposition, rendered from one snapshot."""
    lines: list[str] = []
    counters = {
        "daemon.windows_processed": snap.windows_processed,
        "daemon.events_ingested": snap.events_ingested,
        "daemon.epochs_published": snap.epochs_published,
        "daemon.checkpoints_written": snap.checkpoints_written,
        "daemon.reclusters": snap.reclusters,
        "daemon.bytes_migrated": snap.bytes_migrated,
        "daemon.traced_decisions": snap.traced_decisions,
        "daemon.reads_shed": snap.reads_shed,
        "daemon.windows_coalesced": snap.windows_coalesced,
    }
    for name in sorted(counters):
        lines += prom.counter_lines(name, counters[name])
    gauges = {
        "daemon.backlog_bytes": snap.backlog_bytes,
        "daemon.backlog_events": snap.backlog_events,
        "daemon.brownout_level": snap.brownout_level,
        "daemon.epoch_id": snap.epoch_id or 0,
        "daemon.lag_blocks": snap.lag_blocks,
        "daemon.lag_bytes": snap.lag_bytes,
        "daemon.lag_seconds": snap.lag_seconds,
        "daemon.lag_windows": snap.lag_windows,
        "daemon.window": snap.window if snap.window is not None else -1,
        "obs.snapshot_seq": snap.seq,
    }
    for name in sorted(gauges):
        lines += prom.gauge_lines(name, gauges[name])
    if snap.decision_seconds:
        lines += prom.summary_lines("daemon.decision.seconds", list(snap.decision_seconds))
    for stage, _seconds, share in snap.stages:
        lines += prom.gauge_lines(f"daemon.stage.{stage}.share", share)
    lines += prom.alerts_lines([a for a in snap.alerts if a.get("firing")])
    lines += prom.meta_lines()
    return "\n".join(lines) + "\n"


def _statusz_json(snap: ObsSnapshot, *, ready: bool, draining: bool,
                  started_unix: float) -> str:
    doc = {
        "seq": snap.seq,
        "captured_unix": snap.captured_unix,
        "uptime_seconds": max(0.0, time.time() - started_unix),
        "ready": ready,
        "draining": draining,
        "epoch_id": snap.epoch_id,
        "window": snap.window,
        "windows_processed": snap.windows_processed,
        "events_ingested": snap.events_ingested,
        "epochs_published": snap.epochs_published,
        "checkpoints_written": snap.checkpoints_written,
        "reclusters": snap.reclusters,
        "bytes_migrated": snap.bytes_migrated,
        "traced_decisions": snap.traced_decisions,
        "backlog": {"events": snap.backlog_events, "bytes": snap.backlog_bytes},
        "lag": {"bytes": snap.lag_bytes, "blocks": snap.lag_blocks,
                "seconds": snap.lag_seconds, "windows": snap.lag_windows},
        "brownout": {"level": snap.brownout_level, "rungs": list(snap.brownout_rungs),
                     "reads_shed": snap.reads_shed,
                     "windows_coalesced": snap.windows_coalesced},
        "decision": {"count": len(snap.decision_seconds),
                     "p50_seconds": snap.decision_p50_seconds,
                     "p99_seconds": snap.decision_p99_seconds},
        "stages": [{"stage": s, "seconds": sec, "share": share}
                   for s, sec, share in snap.stages],
        "alerts": [dict(a) for a in snap.alerts if a.get("fired")],
    }
    return json.dumps(doc, sort_keys=True, indent=1) + "\n"


def _trace_json(snap: ObsSnapshot) -> str:
    """``/debug/trace``: the exemplars as Chrome trace JSON (they embed their
    span trees); no exemplar is a valid empty trace."""
    from .trace import chrome_trace

    doc = (chrome_trace(list(snap.exemplars)) if snap.exemplars
           else {"displayTimeUnit": "ms", "traceEvents": []})
    return json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"


_TEXT = "text/plain; charset=utf-8"
_JSON = "application/json; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # noqa: ARG002 - no per-request stderr lines
        pass

    def _send(self, status: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(data)

    def do_HEAD(self):  # noqa: N802
        self.do_GET()

    def do_GET(self):  # noqa: N802
        obs: ObsServer = self.server.obs  # type: ignore[attr-defined]
        snap = obs.snapshot   # read once: everything below renders from it
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._send(200, _metrics_text(snap), "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                ok, reason = obs.health(snap)
                if ok and snap.brownout_level:
                    # Shedding load by design is not unhealth; the body says so.
                    body = (f"ok (degraded: rung {snap.brownout_level} — "
                            f"{','.join(snap.brownout_rungs)})\n")
                elif ok:
                    body = "ok\n"
                else:
                    body = f"unhealthy: {reason}\n"
                self._send(200 if ok else 503, body, _TEXT)
            elif path == "/readyz":
                ready, reason = obs.readiness()
                self._send(200 if ready else 503,
                           "ready\n" if ready else f"unready: {reason}\n", _TEXT)
            elif path == "/statusz":
                self._send(200, _statusz_json(snap, ready=obs.ready, draining=obs.draining,
                                              started_unix=obs.started_unix), _JSON)
            elif path == "/debug/trace":
                self._send(200, _trace_json(snap), _JSON)
            elif path == "/":
                self._send(200, "cdrs daemon: /metrics /healthz /readyz /statusz "
                                "/debug/trace\n", _TEXT)
            else:
                self._send(404, f"no such endpoint {path}\n", _TEXT)
        except BrokenPipeError:
            pass  # the scraper hung up mid-response
        except Exception as e:  # pragma: no cover - defensive
            try:
                self._send(500, f"internal error: {e}\n", _TEXT)
            except Exception:
                pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    obs: ObsServer


class ObsServer:
    """The daemon's observability server.

    Constructing it binds the socket (a bad address fails before the daemon
    loop starts); :meth:`start` serves from a thread; the daemon calls
    :meth:`publish` once per processed window, :meth:`set_ready` and
    :meth:`set_draining` at the epoch and drain transitions, and
    :meth:`heartbeat` from the tailer's poll loop; :meth:`close` stops it.
    ``port=0`` binds an ephemeral port; :attr:`url` gives the bound one."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 stale_after: float = 30.0):
        self._httpd = _Server((host, port), _Handler)
        self._httpd.obs = self
        self._thread: threading.Thread | None = None
        self.snapshot: ObsSnapshot = EMPTY_SNAPSHOT
        self.ready: bool = False
        self.draining: bool = False
        self.started_unix: float = time.time()
        self.stale_after = float(stale_after)
        self._heartbeat_mono = time.monotonic()

    @property
    def address(self) -> tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> ObsServer:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        name="cdrs-obs-http", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> ObsServer:
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def publish(self, snapshot: ObsSnapshot) -> None:
        """Install a new snapshot: one reference assignment."""
        self.snapshot = snapshot

    def set_ready(self, ready: bool) -> None:
        self.ready = bool(ready)

    def set_draining(self, draining: bool) -> None:
        """Drain begins: readiness drops at once (attribute stores only, safe
        from a signal handler)."""
        self.draining = bool(draining)
        if draining:
            self.ready = False

    def heartbeat(self) -> None:
        """The tailer's progress stamp."""
        self._heartbeat_mono = time.monotonic()

    def readiness(self) -> tuple[bool, str]:
        if self.ready:
            return True, ""
        if self.draining:
            return False, "draining"
        return False, "no placement epoch published yet"

    def health(self, snap: ObsSnapshot | None = None) -> tuple[bool, str]:
        snap = self.snapshot if snap is None else snap
        severe = snap.severe_firing()
        if severe:
            return False, f"severe alert firing: {','.join(a.get('name', '?') for a in severe)}"
        age = time.monotonic() - self._heartbeat_mono
        if age > self.stale_after:
            return False, (f"tailer stalled: no ingest progress for {age:.1f}s "
                           f"(bound {self.stale_after:g}s)")
        return True, ""
