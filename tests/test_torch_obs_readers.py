"""The port's stream readers against the reference's on one stream.

The stream is written by the reference's daemon (serving, faults and a
scrubber on, its telemetry active without XLA captures, so the stream
holds no ``xla`` events the port has no name for): spans, counters,
gauges, histograms with ``serve.latency_ms`` buckets, kmeans traces,
audits, alerts, window records and decision traces.  Both packages'
``metrics summarize``, ``tail``, ``export --format prometheus``,
``report``, ``alerts``, ``watch --once`` and ``trace list|show|export``
print the same bytes.  The exposition's two meta series (process start
time and build version) belong to each process and are compared apart.
"""

import io
from contextlib import redirect_stderr, redirect_stdout

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.daemon import DaemonConfig as RefDaemonConfig  # noqa: E402
from cdrs_tpu.daemon import StreamDaemon as RefDaemon  # noqa: E402
from cdrs_tpu.faults import FaultSchedule as RefSchedule  # noqa: E402
from cdrs_tpu.faults import ScrubConfig as RefScrub  # noqa: E402
from cdrs_tpu.obs import JsonlSink as RefSink  # noqa: E402
from cdrs_tpu.obs import Telemetry as RefTelemetry  # noqa: E402
from cdrs_tpu.obs import metrics_cli as ref_metrics  # noqa: E402
from cdrs_tpu.obs import trace as ref_trace  # noqa: E402
from cdrs_tpu.serve import ServeConfig as RefServe  # noqa: E402
from test_torch_daemon import _ref_cfg, _workload  # noqa: E402

from cdrs_tpu_torch.obs import metrics_cli, read_events, trace  # noqa: E402
from cdrs_tpu_torch.obs.report import render_html  # noqa: E402

FAULTS = ("crash:dn2@1-2", "corrupt:dn1@1:0.3")


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    d = tmp_path_factory.mktemp("readers")
    _, _, manifest, events = _workload(1)
    p = str(d / "ref.jsonl")
    cfg = _ref_cfg(serve=RefServe(policy="p2c", seed=3), default_rf=2,
                   fault_schedule=RefSchedule.from_specs(FAULTS),
                   scrub=RefScrub(bytes_per_window=2_000_000))
    with RefTelemetry(RefSink(p), xprof=False):
        RefDaemon(RefController(manifest, cfg),
                  RefDaemonConfig(trace_exemplars=2)).run(events, metrics_path=p)
    kinds = {e["kind"] for e in read_events(p)}
    assert {"span", "counter", "gauge", "hist", "hist_bulk", "kmeans_iter", "audit",
            "window", "decision_trace", "meta"} <= kinds and "xla" not in kinds
    return d, p


def _out(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["summarize", "{p}"],
    ["summarize", "{p}", "--peak_flops", "1e12", "--peak_gbps", "100"],
    ["tail", "{p}", "-n", "60"],
    ["alerts", "{p}"],
    ["watch", "{p}", "--once"],
], ids=["summarize", "summarize-peaks", "tail", "alerts", "watch"])
def test_metrics_readers_print_the_reference_bytes(stream, argv):
    """``watch``'s header carries the session's elapsed seconds, its one
    wall-clock field, which is taken out."""
    import re

    _, p = stream
    argv = [a.format(p=p) for a in argv]
    got = _out(metrics_cli.main, argv)
    want = _out(ref_metrics.main, argv)

    def stable(text):
        return re.sub(r"( events, )\d+s\)", r"\1Xs)", text)

    assert got[0] == want[0] == 0 and got[1] and stable(got[1]) == stable(want[1])


def test_prometheus_export_prints_the_reference_bytes(stream):
    d, p = stream
    events = read_events(p)
    assert metrics_cli.prometheus_lines(events) == ref_metrics.prometheus_lines(events)
    got, want = str(d / "port.prom"), str(d / "ref.prom")
    assert metrics_cli.main(["export", p, "--format", "prometheus", "--out", got]) == 0
    assert ref_metrics.main(["export", p, "--format", "prometheus", "--out", want]) == 0
    got_lines, want_lines = (open(f).read().splitlines() for f in (got, want))
    n_meta = len(metrics_cli.meta_lines())
    assert got_lines[:-n_meta] == want_lines[:-n_meta] and len(got_lines) == len(want_lines)
    assert [ln.split(" ")[0].split("{")[0] for ln in got_lines[-n_meta:]] == \
        [ln.split(" ")[0].split("{")[0] for ln in want_lines[-n_meta:]]


def test_html_report_is_the_reference_bytes(stream):
    from cdrs_tpu.obs.report import render_html as ref_render_html

    d, p = stream
    events = read_events(p)
    assert render_html(events, title="t") == ref_render_html(events, title="t")
    assert metrics_cli.main(["report", p, "-o", str(d / "port.html")]) == 0
    assert ref_metrics.main(["report", p, "-o", str(d / "ref.html")]) == 0
    # The title names the stream, the same file for both.
    assert (d / "port.html").read_text() == (d / "ref.html").read_text()


@pytest.mark.parametrize("argv", [
    ["list", "{p}"], ["list", "{p}", "--limit", "2"], ["show", "{p}"], ["show", "{p}", "2"],
    ["show", "{p}", "d000001"], ["export", "{p}"], ["export", "{p}", "--canonical"],
], ids=["list", "list-limit", "show", "show-window", "show-trace", "export", "canonical"])
def test_trace_readers_print_the_reference_bytes(stream, argv):
    _, p = stream
    argv = [a.format(p=p) for a in argv]
    got = _out(trace.main, argv)
    want = _out(ref_trace.main, argv)
    assert got[0] == want[0] == 0 and got[1] and got[1] == want[1]


@pytest.mark.parametrize("main_pair", ["metrics", "trace"])
def test_readers_fail_alike_on_a_stream_without_data(tmp_path, main_pair):
    p = tmp_path / "empty.jsonl"
    p.write_text('{"kind": "window", "window": 0}\n')
    if main_pair == "metrics":
        empty = tmp_path / "none.jsonl"
        empty.write_text("")
        got = _out(metrics_cli.main, ["summarize", str(empty)])
        want = _out(ref_metrics.main, ["summarize", str(empty)])
        assert got == want and got[0] == 1
        assert _out(metrics_cli.main, ["regress", "x.json"])[0] == 2
        return
    with pytest.raises(SystemExit) as got, redirect_stdout(io.StringIO()):
        trace.main(["list", str(p)])
    with pytest.raises(SystemExit) as want, redirect_stdout(io.StringIO()):
        ref_trace.main(["list", str(p)])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags", [[], ["--json"]], ids=["block", "json"])
def test_status_prints_the_reference_block(flags):
    """``status HOST:PORT`` against a live plane (here the port's server,
    not ready yet): the reference's block and probe lines, up to the
    uptime, which moves between the two reads."""
    import re

    from cdrs_tpu import cli as ref_cli

    from cdrs_tpu_torch import cli as port_cli
    from cdrs_tpu_torch.obs.httpz import ObsServer

    def stable(text):
        return re.sub(r'(up |"uptime_seconds": )[0-9.]+', r"\1X", text)

    with ObsServer("127.0.0.1", 0) as srv:
        host, port = srv.address
        got = _out(port_cli.main, ["status", f"{host}:{port}", *flags])
        want = _out(ref_cli.main, ["status", f"{host}:{port}", *flags])
    assert got[0] == want[0] == 0 and stable(got[1]) == stable(want[1])
    assert "state:    not ready" in got[1] or '"ready": false' in got[1]
