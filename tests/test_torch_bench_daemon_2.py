"""The port's ``benchmarks/daemon_bench`` entry point (part 2 of
``test_torch_bench_daemon.py``): ``main --quick`` on the CPU keeps the
reference's artifact keys, prints the decision-against-window timing on a
line of its own and never appends to the history."""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_bench_parity import one_torch_thread  # noqa: E402

from cdrs_tpu_torch.benchmarks import daemon_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_daemon_bench_main_quick_keeps_the_references_keys(tmp_path, capsys, monkeypatch):
    """``main --quick``; serving under re-clustering stops at 8 batches here
    (a loaded host keeps its daemon slow, and the reader routes until the
    daemon ends)."""
    serve = daemon_bench.run_serve_under_recluster
    monkeypatch.setattr(daemon_bench, "run_serve_under_recluster",
                        lambda **kw: serve(**dict(kw, max_batches=8)))
    out = tmp_path / "d.json"
    assert daemon_bench.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    timing = json.loads(lines[-2])["decision_vs_window"]
    assert timing["n_files"] == 2_000 and timing["daemon_decision_p50_seconds"] > 0
    doc = json.loads(out.read_text())
    assert set(doc) == {"round", "decision_latency", "serve_under_recluster",
                        "decay_identity", "criteria", "bench_records", "run_meta",
                        "cold_init"}
    assert json.loads(lines[-1])["history_appended"] == 0
    assert doc["criteria"]["trace_reconciled"] and doc["criteria"]["decay_one_decision_identical"]
