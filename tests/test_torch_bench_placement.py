"""The port's ``benchmarks/placement_bench`` against the reference's
``run_placement_bench`` pieces on the CPU.

The chooser, checkpoint and epoch-diff rows are host numpy: slot counts,
exceptions, checkpoint and resident bytes, moved sets and the prune check
must be the reference's (times and rates are wall clock).  The controller
window runs the port's fold, Lloyd and medians on the device from the
reference's cold init (decay 1: the reference on ``backend="jax"``): its
reads routed, locality, p99 and plan hash must be the reference's.
``main --quick``: ``test_torch_bench_placement_2.py``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.placement_bench as ref  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import (assert_matches, one_torch_thread,  # noqa: E402
                                reference_on_jax, round_trips)

from cdrs_tpu_torch.benchmarks import placement_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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
