"""The telemetry of the port's controller, serve plane and daemon against
the reference's (``backend="jax"``), each under its own instrument whose
sink also takes the window records (one stream, one writer), and the
audit's geometry proxy against the reference's on the same inputs.

Both sides run the same workload from the reference's D² init (carried
into the port's cold re-clusters as ``tests/test_torch_serve_control.py``
and ``tests/test_torch_daemon.py`` carry it).  Under the name table of the
port's ``obs`` package (``jit.calls.<k>`` -> ``kernel.calls.<k>`` with the
entry point's port name; the reference's compile counters
``jit.recompiles.*`` and ``xla.*`` have no counterpart, since a CUDA kernel
is built per source, not compiled per signature; the port's own kernel
counters ``kernel.calls.<wrapper>`` and ``kernel.builds.*`` have none in
the reference) the final counters are equal, the gauges equal (floats
within 1e-9 relative), the audit events equal (for the geometry see
below), the ``serve.latency_ms`` buckets exact and the lineage events
equal.  Timing fields (``t``, ``dur``, ``seconds``) are
dropped.

The audit's silhouette and Davies-Bouldin index are held within 1e-9 of
the reference's on the same inputs (``silhouette_db_proxy``, float64 in
both).  In the streams they are held within 1e-6: there they score each
side's own accepted centroids, which agree within float32 rounding (the
Lloyd sums are added in another order; ``tests/test_torch_kmeans.py``
holds centroids within 1e-5)."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.daemon import StreamDaemon as RefDaemon  # noqa: E402
from cdrs_tpu.faults import ScrubConfig as RefScrub  # noqa: E402
from cdrs_tpu.obs import JsonlSink as RefSink  # noqa: E402
from cdrs_tpu.obs import Telemetry as RefTelemetry  # noqa: E402
from test_torch_daemon import _controller as daemon_controller  # noqa: E402
from test_torch_daemon import _ref_cfg as daemon_ref_cfg  # noqa: E402
from test_torch_daemon import _workload as daemon_workload  # noqa: E402
from test_torch_serve_control import CHAOS, _controller, _ref_controller, _workload  # noqa: E402

from cdrs_tpu_torch.daemon import StreamDaemon  # noqa: E402
from cdrs_tpu_torch.device import deterministic  # noqa: E402
from cdrs_tpu_torch.faults import ScrubConfig  # noqa: E402
from cdrs_tpu_torch.obs import JsonlSink, Telemetry, read_events  # noqa: E402
from cdrs_tpu_torch.obs.aggregate import collect, dedup_windows  # noqa: E402

#: The reference's entry points under their port names.
RENAMED = {"jit.calls.kmeans_jax_full": "kernel.calls.kmeans_full"}
#: Reference-only compile counters and port-only kernel counters.
REF_ONLY = ("jit.recompiles.", "xla.")
PORT_ONLY = ("kernel.builds.", "kernel.calls.classify", "kernel.calls.lloyd_assign_reduce",
             "kernel.calls.label_threshold_count", "kernel.calls.minibatch_update")
REL = 1e-9
#: The audit's geometry over each side's own float32 centroids (docstring).
GEOMETRY = ("silhouette", "davies_bouldin")
GEOMETRY_REL = 1e-6


def _counters(digest, ref: bool) -> dict:
    out = {}
    for name, v in digest["counters"].items():
        if ref:
            if name.startswith(REF_ONLY):
                continue
            name = RENAMED.get(name, name)
        elif name.startswith(PORT_ONLY):
            continue
        out[name] = v
    return out


def _audits(digest) -> list[dict]:
    return [{k: v for k, v in a.items() if k not in ("t", "run")} for a in digest["audits"]]


def _bulk(events) -> list[dict]:
    return [{k: e[k] for k in ("name", "count", "sum", "min", "max", "buckets")}
            for e in events if e["kind"] == "hist_bulk"]


def _lineage(events) -> list[dict]:
    return [{k: v for k, v in e.items() if k not in ("t", "run")}
            for e in events if e["kind"] == "lineage"]


def assert_streams_match(port_events, ref_events):
    got, want = collect(port_events), collect(ref_events)
    assert _counters(got, False) == _counters(want, True)
    assert got["counters"]["controller.windows"] > 0
    assert set(got["gauges"]) == set(want["gauges"])
    for name, v in want["gauges"].items():
        rel = GEOMETRY_REL if name.split(".")[-1] in GEOMETRY else REL
        assert got["gauges"][name] == pytest.approx(v, rel=rel, abs=0.0), name
    ga, wa = _audits(got), _audits(want)
    assert len(ga) == len(wa) > 0
    for g, w in zip(ga, wa):
        assert set(g) == set(w)
        for key, v in w.items():
            if key in GEOMETRY:
                assert g[key] == pytest.approx(v, rel=GEOMETRY_REL), (w["window"], key)
            else:
                assert g[key] == v, (w["window"], key)
    assert _bulk(port_events) == _bulk(ref_events)
    assert _lineage(port_events) == _lineage(ref_events)
    assert {n for n in got["hists"] if n.startswith("controller.")} == \
        {n for n in want["hists"] if n.startswith("controller.")}
    assert got["hists"]["kmeans.iterations"] == want["hists"]["kmeans.iterations"]
    assert [w["plan_hash"] for w in got["windows"]] == [w["plan_hash"] for w in want["windows"]]


@pytest.mark.parametrize("seed,chaos", [(0, True), (1, False)])
def test_controller_and_serve_streams_match_the_reference(tmp_path, seed, chaos):
    m, ev, rm, rev = _workload(seed)
    faults = CHAOS if chaos else None
    kw = dict(scrub=ScrubConfig(bytes_per_window=2_000_000)) if chaos else {}
    rkw = dict(scrub=RefScrub(bytes_per_window=2_000_000)) if chaos else {}
    p, rp = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    with deterministic(), Telemetry(JsonlSink(p)):
        got = _controller(m, faults=faults, **kw).run(ev, metrics_path=p)
    with RefTelemetry(RefSink(rp)):
        want = _ref_controller(rm, faults=faults, **rkw).run(rev, metrics_path=rp)
    port_events, ref_events = read_events(p), read_events(rp)
    assert_streams_match(port_events, ref_events)
    windows = dedup_windows(port_events)
    assert len(windows) == len(got.records) == len(want.records)
    counters = collect(port_events)["counters"]
    assert counters["serve.reads_routed"] == sum(r.get("reads_routed", 0) for r in windows)
    if chaos:
        assert counters["fault.events"] > 0 and "durability.lost" in collect(port_events)["gauges"]


@pytest.mark.parametrize("seed", [0, 1])
def test_daemon_stream_matches_the_reference(tmp_path, seed):
    manifest, events, ref_manifest, ref_events = daemon_workload(seed)
    p, rp = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    with deterministic(), Telemetry(JsonlSink(p)):
        d = StreamDaemon(daemon_controller(manifest))
        d.run(events, metrics_path=p)
    with RefTelemetry(RefSink(rp)):
        ref = RefDaemon(RefController(ref_manifest, daemon_ref_cfg()))
        ref.run(ref_events, metrics_path=rp)
    port_events = read_events(p)
    assert_streams_match(port_events, read_events(rp))
    spans = [e for e in port_events if e["kind"] == "span"]
    decisions = [s for s in spans if s["name"] == "daemon.decision"]
    assert [s["attrs"]["window"] for s in decisions] == [r["window"] for r in d.records]
    ids = {s["id"]: s["attrs"]["trace"] for s in decisions}
    stages = [s for s in spans if s["name"].startswith("controller.")]
    assert stages and all(ids[s["parent"]] == s["attrs"]["trace"] for s in stages)
    names = lambda evs: sorted(e["name"] for e in evs  # noqa: E731
                               if e["kind"] == "span" and e["name"].startswith(
                                   ("daemon.", "controller.")))
    assert names(port_events) == names(read_events(rp))
    # The records of a run without an instrument are the same.
    bare = StreamDaemon(daemon_controller(manifest))
    with deterministic():
        bare.run(events)
    assert [r["plan_hash"] for r in bare.records] == [r["plan_hash"] for r in d.records]
    assert np.array_equal(bare.controller.current_rf, d.controller.current_rf)


@pytest.mark.parametrize("seed, n, k, labels", [(0, 500, 8, False), (1, 4096, 4, False),
                                                (2, 300, 8, True), (3, 50, 1, False)])
def test_silhouette_db_proxy_matches_the_reference(seed, n, k, labels):
    import torch

    from cdrs_tpu.obs.audit import silhouette_db_proxy as ref_proxy

    from cdrs_tpu_torch.obs.audit import silhouette_db_proxy

    rng = np.random.default_rng(seed)
    X = rng.random((n, 5)).astype(np.float32)
    c = rng.random((k, 5)).astype(np.float32)
    c[-1] = 10.0   # an empty cluster where k > 1
    lab = rng.integers(0, max(1, k - 1), n) if labels else None
    want = ref_proxy(X, c, lab)
    got = silhouette_db_proxy(torch.from_numpy(X), c, lab)
    assert got == pytest.approx(want, rel=REL, abs=1e-15)
    assert silhouette_db_proxy(X, c, lab) == pytest.approx(want, rel=REL, abs=1e-15)


def test_auditor_event_matches_the_reference():
    import torch

    from cdrs_tpu.obs.audit import DecisionAuditor as RefAuditor

    from cdrs_tpu_torch.obs.audit import DecisionAuditor

    rng = np.random.default_rng(7)
    sizes = rng.integers(1, 1 << 20, 600)
    X = rng.random((600, 5)).astype(np.float32)
    c = rng.random((4, 5)).astype(np.float32)
    recs = [{"recluster": True, "deferred_budget": 3, "locality_before": 0.9,
             "locality_after": 0.85, "repair_backlog": 2},
            {"recluster": False, "deferred_budget": 1, "locality_before": 0.8,
             "locality_after": 0.8, "latency_p99_ms": 12.0, "slo_burn": 2.0},
            {"recluster": True, "deferred_budget": 2, "repair_backlog": 1,
             "recluster_trigger": "hotspot"}]
    got_aud, want_aud = DecisionAuditor(sizes, 5), RefAuditor(sizes, 5)
    with Telemetry() as tel, RefTelemetry() as ref_tel:
        for w, rec in enumerate(recs):
            rf = rng.integers(1, 4, 600)
            cat = rng.integers(-1, 5, 600)
            Xw = None if w == 1 else X * (1 + 0.1 * w)
            want = want_aud.audit_window(ref_tel, window=w, rec=rec, X=Xw, centroids=c,
                                         rf=rf, cat=cat)
            got = got_aud.audit_window(tel, window=w, rec=rec,
                                       X=None if Xw is None else torch.from_numpy(Xw),
                                       centroids=c, rf=rf, cat=cat)
            for key, v in want.items():
                if key in GEOMETRY:
                    assert got[key] == pytest.approx(v, rel=REL), key
                elif key != "t":
                    assert got[key] == v, key
        assert tel.counters == ref_tel.counters

