"""The port's ``benchmarks/placement_bench`` entry point (part 2 of
``test_torch_bench_placement.py``): ``main --quick`` on the CPU, its
controller window cut to 100,000 files, holds the window's and the host
rows' criteria, names the reference's bench_records and never appends to
the history."""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_bench_parity import one_torch_thread  # noqa: E402

from cdrs_tpu_torch.benchmarks import placement_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_placement_bench_main_quick(tmp_path, capsys):
    out = tmp_path / "p.json"
    assert placement_bench.main(["--quick", "--window_n", "100000", "--device", "cpu",
                                 "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["controller_window"]["n_files"] == 100_000
    assert doc["criteria"]["window_completed"] and doc["criteria"]["epoch_diff_prune_exact"]
    assert doc["criteria"]["checkpoint_20x_smaller"]
    assert [r["metric"] for r in doc["bench_records"]] == [
        "placement_recompute_mplacements", "placement_checkpoint_ratio",
        "placement_resident_ratio", "placement_epoch_diff_speedup",
        "placement_window_seconds"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["history_appended"] == 0
