"""The port's live operational plane (``obs/prom.py``, ``obs/httpz.py``,
``StreamDaemon.attach_http``, ``daemon --http``) against the reference's.

The renderer and the lint give the reference's bytes and verdicts; the
server's five endpoints keep the probe semantics; and on the same daemon
run (the port from the reference's D² init, the reference on its jax
backend) ``/metrics``, ``/statusz`` and ``/debug/trace`` agree once the
wall-clock parts are taken out (``STATUSZ_WALL_KEYS``, the decision-time
summary and stage shares, the trace's ``ts``/``dur``).
"""

import io
import json
import threading
import urllib.error
import urllib.request
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.control import ControllerConfig as RefConfig  # noqa: E402
from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.daemon import StreamDaemon as RefDaemon  # noqa: E402
from cdrs_tpu.obs import prom as ref_prom  # noqa: E402
from cdrs_tpu.obs.httpz import ObsServer as RefServer  # noqa: E402
from cdrs_tpu.obs.trace import chrome_trace as ref_chrome_trace  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as ref_simulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402

from cdrs_tpu_torch import cli as port_cli  # noqa: E402
from cdrs_tpu_torch.config import (GeneratorConfig, KMeansConfig,  # noqa: E402
                                   SimulatorConfig, validated_scoring_config)
from cdrs_tpu_torch.control.controller import (ControllerConfig,  # noqa: E402
                                               ReplicationController)
from cdrs_tpu_torch.daemon import StreamDaemon  # noqa: E402
from cdrs_tpu_torch.io.events import EventLog  # noqa: E402
from cdrs_tpu_torch.obs import prom  # noqa: E402
from cdrs_tpu_torch.obs.alerts import AlertRule  # noqa: E402
from cdrs_tpu_torch.obs.httpz import STATUSZ_WALL_KEYS, ObsServer, ObsSnapshot  # noqa: E402
from cdrs_tpu_torch.obs.trace import chrome_trace  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

N_FILES, GEN_SEED, SIM_SEED, DURATION = 150, 31, 32, 600.0


@pytest.fixture(scope="module")
def workload():
    manifest = generate_population(GeneratorConfig(n_files=N_FILES, seed=GEN_SEED))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=DURATION,
                                                       seed=SIM_SEED))
    return manifest, events


def _cfg(**kw):
    base = dict(window_seconds=120.0, kmeans=KMeansConfig(k=8, seed=42),
                scoring=validated_scoring_config(), device="cpu")
    base.update(kw)
    return ControllerConfig(**base)


def _get(url: str):
    """(status, body) of one GET; a 503 is data, not an error."""
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def _synthetic_batches(n_files: int, sizes, window_seconds: float, seed: int = 7):
    """One EventLog batch per window, ``sizes[w]`` events inside window w."""
    rng = np.random.default_rng(seed)
    batches = []
    for w, size in enumerate(sizes):
        ts = np.sort(rng.uniform(w * window_seconds, (w + 1) * window_seconds, size))
        batches.append(EventLog(ts=ts.astype(np.float64),
                                path_id=rng.integers(0, n_files, size).astype(np.int32),
                                op=np.zeros(size, dtype=np.int8),
                                client_id=np.zeros(size, dtype=np.int32), clients=["c0"]))
    return batches


# -- obs/prom.py ------------------------------------------------------------------

EVENTS = [
    {"kind": "counter", "name": "reads.routed", "value": 12345, "run": "r1"},
    {"kind": "counter", "name": "reads.routed", "value": 7, "run": "r2"},
    {"kind": "counter", "name": "jit.recompiles", "value": 3, "run": "r1"},
    {"kind": "gauge", "name": "serve.p99_ms", "value": 41.5},
    {"kind": "gauge", "name": "9weird name!", "value": 2.0},
    {"kind": "hist", "name": "plan.seconds", "value": 0.25},
    {"kind": "hist", "name": "plan.seconds", "value": 0.75},
    {"kind": "span", "name": "window", "dur": 1.5, "id": 1, "run": "r1"},
    {"kind": "hist_bulk", "name": "serve.latency_ms", "count": 4, "sum": 10.0, "min": 1.0,
     "max": 4.0, "buckets": [[1.0, 1], [3.0, 2], ["+Inf", 1]]},
    {"kind": "hist_bulk", "name": "serve.latency_ms", "count": 2, "sum": 3.0, "min": 0.5,
     "max": 2.5, "buckets": [[1.0, 1], [3.0, 1]]},
    {"kind": "window", "window": 0, "durability": {"lost": 1}},
    {"kind": "window", "window": 1, "durability": {"lost": 1}},
    {"kind": "window", "window": 1, "durability": {"lost": 0, "at_risk": 2}},
]


def test_prometheus_lines_equal_the_reference():
    got = "\n".join(prom.prometheus_lines(EVENTS)) + "\n"
    assert got == "\n".join(ref_prom.prometheus_lines(EVENTS)) + "\n"
    assert prom.lint(got) == [] and "ALERTS{" in got and "cdrs_reads_routed 12352" in got


def test_meta_lines_and_names():
    assert prom.meta_lines(start_time=123.4564, version="1.2.3") == \
        ref_prom.meta_lines(start_time=123.4564, version="1.2.3") == [
            "# TYPE cdrs_process_start_time_seconds gauge",
            "cdrs_process_start_time_seconds 123.456",
            "# TYPE cdrs_build_info gauge",
            'cdrs_build_info{version="1.2.3"} 1']
    for name, prefix in (("reads.routed", "cdrs_"), ("9weird name!", "cdrs_"), ("9lead", "")):
        assert prom.prom_name(name, prefix) == ref_prom.prom_name(name, prefix)
    assert prom.lint("\n".join(prom.meta_lines()) + "\n") == []


@pytest.mark.parametrize("bad,needle", [
    ("cdrs_x 1\n", "no preceding TYPE"),
    ("# TYPE cdrs_x counter\ncdrs_x nope\n", "non-numeric"),
    ("# TYPE cdrs_x counter\n# TYPE cdrs_x gauge\ncdrs_x 1\n", "duplicate TYPE"),
    ("# TYPE cdrs_x counter\ncdrs_x 1", "end with a newline"),
    ('# TYPE cdrs_x counter\ncdrs_x{9bad="v"} 1\n', "bad label"),
    ("# TYPE cdrs_x counter\nnot a sample at all !\n", "unparseable"),
    ("# TYPE cdrs_x wobbly\ncdrs_x 1\n", "unknown type"),
    ("# TYPE 9x counter\n", "invalid metric name"),
    ("# TYPE cdrs_x\n", "malformed TYPE"),
])
def test_lint_rejects_malformed_as_the_reference(bad, needle):
    errs = prom.lint(bad)
    assert errs == ref_prom.lint(bad)
    assert any(needle in e for e in errs), errs


# -- ObsServer --------------------------------------------------------------------

def test_server_probe_lifecycle():
    with ObsServer() as srv:
        code, body = _get(srv.url + "/")
        assert code == 200 and "/metrics" in body
        code, body = _get(srv.url + "/readyz")
        assert code == 503 and "no placement epoch" in body
        assert _get(srv.url + "/healthz") == (200, "ok\n")
        srv.set_ready(True)
        assert _get(srv.url + "/readyz") == (200, "ready\n")
        srv.set_draining(True)
        code, body = _get(srv.url + "/readyz")
        assert code == 503 and "draining" in body
        assert srv.readiness() == (False, "draining")
        assert _get(srv.url + "/nope")[0] == 404
        req = urllib.request.Request(srv.url + "/metrics", method="HEAD")
        with urllib.request.urlopen(req, timeout=5) as r:
            assert r.status == 200 and r.read() == b""


def test_server_health_trips_on_severe_alert_or_stale_heartbeat_and_recovers():
    page = {"name": "files_lost", "severity": "page", "kind": "threshold", "firing": True,
            "fired": True, "since": 3, "streak": 2}
    ticket = dict(page, name="durability_degraded", severity="ticket")
    with ObsServer() as srv:
        srv.publish(ObsSnapshot(seq=1, alerts=(ticket,)))
        assert _get(srv.url + "/healthz")[0] == 200
        srv.publish(ObsSnapshot(seq=2, alerts=(page, ticket)))
        code, body = _get(srv.url + "/healthz")
        assert code == 503 and "files_lost" in body
        _, text = _get(srv.url + "/metrics")
        assert 'ALERTS{alertname="files_lost"' in text
        assert 'ALERTS{alertname="durability_degraded"' in text
        srv.publish(ObsSnapshot(seq=3, alerts=(ticket,), brownout_level=2,
                                brownout_rungs=("skip_minibatch", "defer_scrub")))
        code, body = _get(srv.url + "/healthz")
        assert code == 200 and "degraded: rung 2" in body
        srv.stale_after = 0.0
        code, body = _get(srv.url + "/healthz")
        assert code == 503 and "tailer stalled" in body
        srv.stale_after = 60.0
        srv.heartbeat()
        assert _get(srv.url + "/healthz")[0] == 200


def test_empty_snapshot_surfaces_lint_clean():
    with ObsServer() as srv, RefServer() as ref:
        code, text = _get(srv.url + "/metrics")
        assert code == 200 and prom.lint(text) == [] and "cdrs_obs_snapshot_seq 0" in text
        ref_text = _get(ref.url + "/metrics")[1]
        assert _stable_metrics(text) == _stable_metrics(ref_text)
        code, body = _get(srv.url + "/statusz")
        doc = json.loads(body)
        assert code == 200 and doc["seq"] == 0 and set(STATUSZ_WALL_KEYS) <= set(doc)
        assert _stable_statusz(body) == _stable_statusz(_get(ref.url + "/statusz")[1])
        assert json.loads(_get(srv.url + "/debug/trace")[1]) == {"displayTimeUnit": "ms",
                                                                  "traceEvents": []}
    with pytest.raises(ValueError, match="decision_trace"):
        chrome_trace([{"kind": "window", "window": 0}])


# -- the daemon against the reference's -----------------------------------------------

_WALL_SERIES = ("cdrs_process_start_time_seconds", "cdrs_build_info",
                "cdrs_daemon_decision_seconds", "cdrs_daemon_stage_")


def _stable_metrics(text: str) -> list[str]:
    """The exposition without the samples that follow the wall clock (the
    TYPE lines stay)."""
    return [ln for ln in text.splitlines()
            if ln.startswith("#") or not ln.startswith(_WALL_SERIES)]


def _stable_statusz(body: str) -> dict:
    doc = json.loads(body)
    return {k: v for k, v in doc.items() if k not in STATUSZ_WALL_KEYS}


def _canonical_trace(body: str) -> dict:
    doc = json.loads(body)
    for ev in doc["traceEvents"]:
        if "ts" in ev:
            ev["ts"] = ev["dur"] = 0.0
    return doc


@pytest.fixture(scope="module")
def scraped(workload):
    """One daemon run on each side with the plane attached: the final
    snapshot, records and scrapes of the port's and the reference's."""
    manifest, events = workload
    rm = ref_generate(jcfg.GeneratorConfig(n_files=N_FILES, seed=GEN_SEED))
    rev = ref_simulate(rm, jcfg.SimulatorConfig(duration_seconds=DURATION, seed=SIM_SEED))
    ref_cfg = RefConfig(window_seconds=120.0, backend="jax", kmeans=jcfg.KMeansConfig(k=8, seed=42),
                        scoring=jcfg.validated_scoring_config())
    out = {}
    for side, daemon, server, log in (
            ("ref", lambda: RefDaemon(RefController(rm, ref_cfg)), RefServer, rev),
            ("port", lambda: StreamDaemon(ReplicationController(manifest, _cfg())), ObsServer,
             events)):
        with carried_init():
            d = daemon()
            with server() as srv:
                d.attach_http(srv)
                dig = d.run(log)
                out[side] = {"daemon": d, "digest": dig, "snap": srv.snapshot,
                             "ready": srv.readiness(),
                             **{p: _get(srv.url + p)[1]
                                for p in ("/metrics", "/statusz", "/debug/trace")}}
    return out


def test_daemon_publishes_consistent_snapshots(scraped, workload):
    _, events = workload
    got = scraped["port"]
    d, snap, dig = got["daemon"], got["snap"], got["digest"]
    assert (snap.seq == snap.windows_processed == snap.epochs_published
            == dig["windows_processed"] == len(d.records) >= 2)
    assert snap.epoch_id == d.publisher.peek().epoch_id
    assert snap.events_ingested == len(events)
    assert snap.backlog_events == 0 and snap.backlog_bytes == 0
    assert got["ready"][0] is False   # the loop is over: no new epochs
    text = got["/metrics"]
    assert prom.lint(text) == []
    assert f"cdrs_daemon_windows_processed {snap.seq}" in text
    assert "cdrs_daemon_decision_seconds_count" in text
    doc = json.loads(got["/statusz"])
    assert doc["seq"] == snap.seq and doc["decision"]["count"] == len(d.decision_seconds)
    assert sum(s["share"] for s in doc["stages"]) == pytest.approx(1.0, abs=1e-6)
    # Exemplars serve without a metrics sink (the kept heap).
    assert d.traced_decisions == 0
    names = {e["name"] for e in json.loads(got["/debug/trace"])["traceEvents"]}
    assert any(n.startswith("decision w") for n in names)


def test_scrapes_equal_the_reference_apart_from_the_wall_clock(scraped):
    got, want = scraped["port"], scraped["ref"]
    drift = ("drift", "centroid_shift", "population_delta")
    for g, w in zip(got["daemon"].records, want["daemon"].records, strict=True):
        assert {k: v for k, v in g.items() if k != "seconds" and k not in drift} == \
            {k: v for k, v in w.items() if k != "seconds" and k not in drift}
        assert all(abs(g[k] - w[k]) <= 1e-6 for k in drift if w[k] is not None)
    assert _stable_metrics(got["/metrics"]) == _stable_metrics(want["/metrics"])
    assert _stable_statusz(got["/statusz"]) == _stable_statusz(want["/statusz"])
    assert _canonical_trace(got["/debug/trace"]) == _canonical_trace(want["/debug/trace"])
    assert [s[0] for s in got["snap"].stages] == [s[0] for s in want["snap"].stages]
    assert got["snap"].alerts == want["snap"].alerts
    exemplars = list(got["snap"].exemplars)
    assert chrome_trace(exemplars) == ref_chrome_trace(exemplars)


def test_attaching_the_plane_does_not_change_decisions(scraped, workload):
    manifest, events = workload
    with carried_init():
        bare = StreamDaemon(ReplicationController(manifest, _cfg()))
        bare.run(events)

    def strip(rs):
        return [{k: v for k, v in r.items() if k != "seconds"} for r in rs]

    assert strip(bare.records) == strip(scraped["port"]["daemon"].records)


def test_concurrent_scrapes_never_tear(workload):
    manifest, _ = workload
    batches = _synthetic_batches(len(manifest), [250] * 20, window_seconds=60.0, seed=11)
    d = StreamDaemon(ReplicationController(manifest, _cfg(window_seconds=60.0)))
    done = threading.Event()
    errors: list[str] = []
    last_seq: dict = {}

    def hammer(tid: int, path: str):
        while not done.is_set():
            code, body = _get(srv.url + path)
            if code != 200:
                errors.append(f"{path} -> {code}")
                return
            if path == "/statusz":
                doc = json.loads(body)
                seq, wp, ep = doc["seq"], doc["windows_processed"], doc["epochs_published"]
            else:
                vals = dict(line.split(" ", 1) for line in body.splitlines()
                            if line and not line.startswith("#") and "{" not in line)
                seq = float(vals["cdrs_obs_snapshot_seq"])
                wp = float(vals["cdrs_daemon_windows_processed"])
                ep = float(vals["cdrs_daemon_epochs_published"])
            if not seq == wp == ep:
                errors.append(f"torn {path}: seq={seq} windows={wp} epochs={ep}")
                return
            if seq < last_seq.get(tid, 0):
                errors.append(f"seq went backwards on {path}")
                return
            last_seq[tid] = seq

    with ObsServer() as srv:
        d.attach_http(srv)
        threads = [threading.Thread(target=hammer, args=(i, p))
                   for i, p in enumerate(["/metrics", "/statusz"] * 2)]
        for t in threads:
            t.start()
        d.run(iter(batches))
        done.set()
        for t in threads:
            t.join(timeout=10.0)
    assert errors == []
    assert max(last_seq.values()) >= 2


def test_readiness_flips_false_at_drain_request(workload):
    manifest, _ = workload
    batches = _synthetic_batches(len(manifest), [200] * 8, window_seconds=60.0, seed=13)
    d = StreamDaemon(ReplicationController(manifest, _cfg(window_seconds=60.0)))
    seen: list[tuple[str, int]] = []

    def feed():
        for k, b in enumerate(batches):
            if k == 4:
                seen.append(("pre", _get(srv.url + "/readyz")[0]))
                d.request_stop("SIGTERM")
                # Readiness drops at the request, before the window ends.
                seen.append(("drain", _get(srv.url + "/readyz")[0]))
            yield b

    with ObsServer() as srv:
        d.attach_http(srv)
        dig = d.run(feed())
    assert dig["stop_reason"] == "SIGTERM"
    assert seen == [("pre", 200), ("drain", 503)]
    assert srv.readiness() == (False, "draining")


def test_healthz_flips_on_page_alert_and_recovers(workload):
    manifest, _ = workload
    batches = _synthetic_batches(len(manifest), [120, 120, 500, 500, 120, 120],
                                 window_seconds=60.0, seed=17)
    rules = [AlertRule("hot_window", kind="threshold", field="n_events", op=">", value=300,
                       for_windows=1, severity="page")]
    d = StreamDaemon(ReplicationController(manifest, _cfg(window_seconds=60.0)), rules=rules)
    health: list[tuple[int, int]] = []

    def feed():
        for k, b in enumerate(batches):
            if k >= 2:
                # Windows 0..k-2 are processed before batch k is pulled.
                health.append((k - 2, _get(srv.url + "/healthz")[0]))
            yield b

    with ObsServer() as srv:
        d.attach_http(srv)
        d.run(feed())
        final = _get(srv.url + "/healthz")[0]
        snap = srv.snapshot
    assert health == [(0, 200), (1, 200), (2, 503), (3, 503)]
    assert final == 200 and snap.severe_firing() == ()
    rows = {a["name"]: a for a in snap.alerts}
    assert rows["hot_window"]["fired"] and not rows["hot_window"]["firing"]


def test_cli_daemon_http(tmp_path, workload):
    """``daemon --http 127.0.0.1:0`` serves while it runs and prints the
    bound address; an address it cannot bind exits 2 before running."""
    manifest, events = workload
    manifest.write_csv(str(tmp_path / "m.csv"))
    events.write_binary(str(tmp_path / "a.cdrsb"), manifest)
    base = ["daemon", "--manifest", str(tmp_path / "m.csv"), "--access_log",
            str(tmp_path / "a.cdrsb"), "--window_seconds", "120", "--k", "8",
            "--scoring_config", "validated", "--device", "cpu"]
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert port_cli.main(base + ["--http", "127.0.0.1:0"]) == 0
    assert "http: serving /metrics /healthz /readyz /statusz /debug/trace on " \
        "http://127.0.0.1:" in err.getvalue()
    assert json.loads(out.getvalue())["windows_processed"] == 5
    with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()) as bad:
        assert port_cli.main(base + ["--http", "127.0.0.1:notaport"]) == 2
    assert "cannot bind --http" in bad.getvalue()
