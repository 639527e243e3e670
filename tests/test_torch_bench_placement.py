"""The port's ``benchmarks/placement_bench`` against the reference's
``run_placement_bench`` pieces on the CPU.

The chooser, checkpoint and epoch-diff rows are host numpy: slot counts,
exceptions, checkpoint and resident bytes, moved sets and the prune check
must be the reference's (times and rates are wall clock).  The controller
window runs the port's fold, Lloyd and medians on the device from the
reference's cold init (decay 1: the reference on ``backend="jax"``): its
reads routed, locality, p99 and plan hash must be the reference's."""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.placement_bench as ref  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import assert_matches, reference_on_jax, round_trips  # noqa: E402

from cdrs_tpu_torch.benchmarks import placement_bench  # noqa: E402

WALL = {"seconds", "note", "peak_rss_gb", "flat_files_per_sec", "flat_placements_per_sec",
        "racked_files_per_sec", "racked_placements_per_sec", "racked_mixed_files_per_sec",
        "racked_mixed_placements_per_sec", "legacy_rng_seconds", "racked_seconds",
        "recompute_vs_legacy_speedup", "sparse_save_seconds", "dense_save_seconds",
        "functional_seconds", "materialized_seconds", "speedup"}


@pytest.mark.parametrize("fn,n", [("_bench_checkpoint", 50_000), ("_bench_epoch_diff", 50_000),
                                  ("_bench_recompute", 50_000)])
def test_host_rows_match_the_reference(fn, n, tmp_path):
    args = (n,) if fn == "_bench_checkpoint" else (n, 1)
    got, want = getattr(placement_bench, fn)(*args), getattr(ref, fn)(*args)
    assert_matches(got, want, skip=WALL)
    round_trips(got, tmp_path)
    if fn == "_bench_epoch_diff":
        assert got["prune_matches_full"] and got["same_epoch_zero_moves"]
        assert got["moved_functional"] == want["moved_functional"] > 0


@pytest.mark.parametrize("n", [50_000, 300_000])
def test_controller_window_matches_the_reference(n):
    with reference_on_jax(ref):
        want = ref._bench_window(n, 20_000)
    with carried_init():
        got = placement_bench._bench_window(n, 20_000, "cpu")
    assert_matches(got, want, skip=WALL)
    assert got["completed"] and got["reads_routed"] == 20_000


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
