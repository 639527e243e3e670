"""The port's ``benchmarks/search_bench`` entry point (part 2 of
``test_torch_bench_search.py``): ``main --quick`` on the CPU writes the
reference's artifact keys with ``run_meta`` and ``cold_init``, holds the
shrinker's criteria and never appends to the history."""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_bench_parity import one_torch_thread  # noqa: E402

from cdrs_tpu_torch.benchmarks import search_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_search_bench_main_quick_writes_no_history(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "s.json"
    assert search_bench.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert set(doc) == {"round", "effectiveness", "shrinker", "criteria", "bench_records",
                        "run_meta", "cold_init"}
    assert doc["effectiveness"]["budget_cells"] == 12 and doc["round"] == 19
    assert doc["criteria"]["planted_violation_detected"]
    assert doc["criteria"]["shrunk_to_3_events_or_fewer"]
    assert doc["criteria"]["shrunk_repro_reruns_red"]
    assert [r["metric"] for r in doc["bench_records"]] == [
        "search_coverage_bits", "search_coverage_advantage_bits", "search_shrunk_repro_events"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["history_appended"] == 0 and not (tmp_path / "data").exists()
