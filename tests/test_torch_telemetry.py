"""The port's ambient instrument (``cdrs_tpu_torch/obs/telemetry.py``) and
its shims (``utils/logging.py``, ``utils/profiling.py``), the
counterparts of ``tests/test_obs.py``'s core cases and
``tests/test_obs_shims.py``: the sink, spans, counters, histograms, the
bucket ladder (equal to the reference's bit for bit on the same values),
the run stamp, and the stage timers."""

import json
import sys
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from cdrs_tpu_torch.obs import (HIST_BUCKETS, HIST_BULK_SAMPLE_CAP, HIST_RAW_CAP,  # noqa: E402
                                JsonlSink, Telemetry, bucket_counts, current, read_events,
                                run_metadata)
from cdrs_tpu_torch.utils.logging import MetricsLog, StageTimer, stage_span  # noqa: E402


# -- the sink ---------------------------------------------------------------------------

def test_sink_one_line_per_event_and_append(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with JsonlSink(p) as s:
        s.emit({"kind": "counter", "name": "a", "value": 1})
    with JsonlSink(p) as s:   # append-only across re-opens (kill/resume)
        s.emit({"kind": "counter", "name": "a", "value": 2})
    assert [e["value"] for e in read_events(p)] == [1, 2]


def test_sink_thread_safety(tmp_path):
    p = str(tmp_path / "t.jsonl")
    sink = JsonlSink(p)

    def work(tid):
        for i in range(200):
            sink.emit({"tid": tid, "i": i})

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sink.close()
    events = read_events(p)
    assert len(events) == 800
    for tid in range(4):
        assert [e["i"] for e in events if e["tid"] == tid] == list(range(200))


def test_read_events_skips_torn_tail(tmp_path):
    p = tmp_path / "t.jsonl"
    p.write_text('{"kind": "gauge", "name": "x", "value": 1.0}\n{"kind": "ga')
    events = read_events(str(p))
    assert len(events) == 1 and events[0]["value"] == 1.0


def test_sink_serializes_numpy_scalars(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with JsonlSink(p) as s:
        s.emit({"v": np.float32(1.5), "a": np.arange(3)})
    e = read_events(p)[0]
    assert e["v"] == 1.5 and e["a"] == [0, 1, 2]


# -- the instrument ---------------------------------------------------------------------

def test_span_nesting_and_tree_fields(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with Telemetry(JsonlSink(p), meta=False) as tel:
        with tel.span("outer"):
            with tel.span("inner"):
                pass
            with tel.span("inner"):
                pass
    spans = [e for e in read_events(p) if e["kind"] == "span"]
    assert [s["name"] for s in spans] == ["inner", "inner", "outer"]
    outer = spans[-1]
    assert all(s["parent"] == outer["id"] for s in spans[:2])
    assert outer["parent"] is None and all(s["dur"] >= 0 for s in spans)
    assert len({s["run"] for s in spans}) == 1


def test_ambient_activation_and_counters():
    assert current() is None
    with Telemetry() as tel:   # no sink: in-memory aggregates only
        assert current() is tel
        tel.counter_inc("c", 2)
        tel.counter_inc("c", 3)
        tel.gauge("g", 7.0)
        tel.histogram("h", 1.0)
        tel.histogram("h", 9.0)
        assert tel.counters["c"] == 5 and tel.gauges["g"] == 7.0
        assert tel.histograms["h"] == [1.0, 9.0]
    assert current() is None


def test_spans_are_per_thread():
    with Telemetry() as tel:
        parents = {}

        def work():
            with tel.span("worker") as s:
                parents["worker"] = s.parent

        with tel.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
        assert parents["worker"] is None


def test_emit_span_joins_the_open_span(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with Telemetry(JsonlSink(p), meta=False) as tel:
        with tel.span("root") as root:
            sid = tel.emit_span("stage", 0.25, trace="d000001")
    spans = {e["name"]: e for e in read_events(p) if e["kind"] == "span"}
    assert spans["stage"]["id"] == sid and spans["stage"]["parent"] == root.id
    assert spans["stage"]["dur"] == 0.25 and spans["stage"]["attrs"] == {"trace": "d000001"}


def test_histogram_raw_cap_decimates_uniformly():
    with Telemetry() as tel:
        for i in range(HIST_RAW_CAP * 2):
            tel.histogram("h", float(i))
        kept = tel.histograms["h"]
    assert len(kept) < HIST_RAW_CAP and kept[:3] == [0.0, 4.0, 8.0]


def test_record_kernel_call_counts_calls_and_first_signatures():
    with Telemetry() as tel:
        assert tel.record_kernel_call("k_test", ("sig", 1)) is True
        assert tel.record_kernel_call("k_test", ("sig", 1)) is False
        assert tel.record_kernel_call("k_test", ("sig", 2)) is True
        assert tel.counters == {"kernel.calls.k_test": 3.0}


def test_emit_kmeans_trace_events_and_histogram(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with Telemetry(JsonlSink(p), meta=False) as tel:
        tel.emit_kmeans_trace("kmeans_full", inertia=[3.0, 2.0], shift=[0.5, 0.0], k=2)
        assert tel.histograms["kmeans.iterations"] == [2.0]
    it = [e for e in read_events(p) if e["kind"] == "kmeans_iter"]
    assert [(e["step"], e["inertia"], e["shift"], e["k"]) for e in it] == \
        [(0, 3.0, 0.5, 2), (1, 2.0, 0.0, 2)]


def test_run_metadata_stamps_the_environment(tmp_path):
    import torch

    meta = run_metadata()
    assert meta["python"] and meta["numpy"] and meta["torch"] == torch.__version__
    assert meta["torch_cuda"] == torch.version.cuda
    # A CPU run never initialises CUDA, so the card's fields stay out.
    if not torch.cuda.is_initialized():
        assert "device_name" not in meta and "power_limit" not in meta
    p = str(tmp_path / "t.jsonl")
    with Telemetry(JsonlSink(p)):
        pass
    metas = [e for e in read_events(p) if e["kind"] == "meta"]
    assert len(metas) == 2 and metas[-1]["run"]["torch"] == torch.__version__


# -- the bucket ladder against the reference ----------------------------------------------

def test_hist_buckets_equal_the_reference():
    pytest.importorskip("jax")
    from cdrs_tpu.obs import telemetry as ref

    assert HIST_BUCKETS == ref.HIST_BUCKETS
    assert (HIST_RAW_CAP, HIST_BULK_SAMPLE_CAP) == (ref.HIST_RAW_CAP, ref.HIST_BULK_SAMPLE_CAP)


@pytest.mark.parametrize("seed, n", [(0, 1), (1, 500), (2, HIST_BULK_SAMPLE_CAP + 7),
                                     (3, 100_003)])
def test_bucket_counts_equal_the_reference(seed, n):
    pytest.importorskip("jax")
    from cdrs_tpu.obs.telemetry import bucket_counts as ref_bucket_counts

    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.lognormal(0.0, 3.0, n), [0.0, -1.0, 1e12]])
    assert bucket_counts(values) == ref_bucket_counts(values)
    sparse, count, *_ = bucket_counts(values)
    assert count == n + 3 and sum(c for _, c in sparse) == count


def test_histogram_bulk_aggregates_and_emits_once(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with Telemetry(JsonlSink(p), meta=False) as tel:
        tel.histogram_bulk("serve.latency_ms", [0.5, 0.6, 50.0])
        tel.histogram_bulk("serve.latency_ms", [])
        agg = tel.hist_buckets["serve.latency_ms"]
    assert agg["count"] == 3 and agg["min"] == 0.5 and agg["max"] == 50.0
    bulk = [e for e in read_events(p) if e["kind"] == "hist_bulk"]
    assert len(bulk) == 1 and sum(c for _, c in bulk[0]["buckets"]) == 3


# -- the shims ----------------------------------------------------------------------------

def test_metricslog_repeated_key_keeps_both_values():
    m = MetricsLog()
    for _ in range(3):
        with m.timer("stream"):
            pass
    rec = m.records["stream.seconds"]
    assert isinstance(rec, list) and len(rec) == 3 and all(v >= 0 for v in rec)


def test_metricslog_increment_semantics():
    m = MetricsLog()
    assert m.increment("counter") == 1.0
    assert m.increment("counter", 2.5) == 3.5
    m.record("listy", 1.0)
    m.record("listy", 2.0)
    with pytest.raises(TypeError, match="list"):
        m.increment("listy")


def test_metricslog_to_json_with_lists_and_none():
    m = MetricsLog()
    m.record("a", 1)
    m.record("a", 2)
    m.record("accuracy", None)
    assert json.loads(m.to_json()) == {"a": [1.0, 2.0], "accuracy": None}


def test_metricslog_feeds_the_instrument():
    with Telemetry() as tel:
        m = MetricsLog()
        m.record("g", 4.0)
        m.increment("c", 2.0)
        assert tel.gauges["g"] == 4.0 and tel.counters["c"] == 2.0


def test_config_metricslog_is_the_one_class():
    from cdrs_tpu_torch.config import MetricsLog as ConfigMetricsLog

    assert ConfigMetricsLog is MetricsLog


def test_stage_timer_opens_span_under_active_telemetry(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with Telemetry(JsonlSink(p), meta=False) as tel:
        with tel.span("root"):
            m = MetricsLog()
            with m.timer("stage_x"):
                pass
    spans = {e["name"]: e for e in read_events(p) if e["kind"] == "span"}
    assert spans["stage_x"]["parent"] == spans["root"]["id"]
    assert m.records["stage_x.seconds"] >= 0


@pytest.mark.parametrize("active", [False, True])
def test_stage_span_is_null_without_telemetry(active):
    if not active:
        with StageTimer("solo") as t:
            pass
        assert t.elapsed >= 0
        with stage_span("x") as s:
            assert s is None
        return
    with Telemetry() as tel:
        with stage_span("x") as s:
            assert isinstance(s, StageTimer) and s.metrics is None
        assert tel.gauges == {}


def test_trace_region_writes_a_chrome_trace(tmp_path):
    import torch

    from cdrs_tpu_torch.utils.profiling import TRACE_FILE, trace_region

    with trace_region(str(tmp_path / "prof")):
        torch.ones(64).sum()
    doc = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())
    assert doc["traceEvents"]


def test_trace_region_noop_without_dir(tmp_path):
    from cdrs_tpu_torch.utils.profiling import trace_region

    with trace_region(None):
        pass
    assert list(tmp_path.iterdir()) == []


def test_obs_imports_without_jax():
    """The port's observability imports nothing of JAX (checked in a child
    process, whose modules start empty)."""
    import subprocess

    code = ("import sys\n"
            "import cdrs_tpu_torch.obs, cdrs_tpu_torch.obs.kprof, cdrs_tpu_torch.obs.metrics_cli\n"
            "import cdrs_tpu_torch.obs.report, cdrs_tpu_torch.obs.audit, cdrs_tpu_torch.cli\n"
            "assert 'jax' not in sys.modules and 'cdrs_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("cuda", [False, True], ids=["cpu", "mocked-cards"])
def test_device_memory_gauges(monkeypatch, cuda):
    """``--device_memory``: per-card allocator gauges at every span's end,
    nothing in a process that never initialised CUDA (mocked cards check
    the names without a card)."""
    import torch

    if cuda:
        stats = {0: {"allocated_bytes.all.current": 10, "allocated_bytes.all.peak": 30},
                 1: {"allocated_bytes.all.current": 20, "allocated_bytes.all.peak": 40}}
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    else:
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    with Telemetry(device_memory=True, meta=False) as tel:
        with tel.span("stage"):
            pass
    if not cuda:
        assert tel.gauges == {}
        return
    assert tel.gauges == {"device.mem.bytes_in_use.d0.stage": 10.0,
                          "device.mem.peak_bytes_in_use.d0.stage": 30.0,
                          "device.mem.bytes_in_use.d1.stage": 20.0,
                          "device.mem.peak_bytes_in_use.d1.stage": 40.0}
