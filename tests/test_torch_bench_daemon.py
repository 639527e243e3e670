"""The port's ``benchmarks/daemon_bench`` against the reference's
``run_decision_latency``, ``run_serve_under_recluster`` and
``run_decay_identity`` on the CPU.

Decision latency runs from the reference's cold init (decay 1: the
reference on ``backend="jax"``); windows, events, epochs, traced decisions,
the trace reconciliation and the live endpoint's snapshot must be the
reference's (latencies and stage shares are wall clock).  Serving under
re-clustering races a background daemon, so its batch count and the epochs
each batch pins are wall clock too: both sides must publish the same
epochs, and the verdict must follow the epochs the batches pinned.  The decay identity forces the
decayed fold on, which the reference does on its numpy backend; both sides
must be decision-identical on every seed.  ``main --quick``:
``test_torch_bench_daemon_2.py``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.daemon_bench as ref  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import (assert_matches, one_torch_thread,  # noqa: E402
                                reference_on_jax, round_trips)

from cdrs_tpu_torch.benchmarks import daemon_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WALL = {"decision_p50_seconds", "decision_p99_seconds", "decision_max_seconds",
        "sub_second_p99", "stage_attribution", "event_to_decision_p99_seconds", "scrapes"}


def test_decision_latency_matches_the_reference(tmp_path):
    kw = dict(n_files=2_000, n_windows=8)
    with reference_on_jax(ref):
        want = ref.run_decision_latency(**kw)
    with carried_init():
        got = daemon_bench.run_decision_latency(**kw, device="cpu")
    assert_matches(got, want, skip=WALL)
    assert got["trace_reconciled"] and got["traced_decisions"] == got["n_windows"] == 8
    assert got["live_endpoint"]["scrapes"] > 0 and got["live_endpoint"]["metrics_lint_clean"]
    assert set(got["stage_attribution"]) == set(want["stage_attribution"])
    round_trips(got, tmp_path)


@pytest.mark.parametrize("seeds", [(0,), (1, 2)])
def test_decay_identity_matches_the_reference(seeds):
    kw = dict(n_files=500, n_windows=8, seeds=seeds)
    want = ref.run_decay_identity(**kw)
    got = daemon_bench.run_decay_identity(**kw, device="cpu")
    assert_matches(got, want)
    assert got["decay_one_identical"]


def test_serve_under_recluster_publishes_the_references_epochs():
    kw = dict(n_files=1 << 13, n_windows=12, reads_per_batch=200_000, min_batches=3,
              max_batches=8)
    with reference_on_jax(ref):
        want = ref.run_serve_under_recluster(**kw)
    with carried_init():
        got = daemon_bench.run_serve_under_recluster(**kw, device="cpu")
    assert set(got) == set(want)
    assert got["epochs_published"] == want["epochs_published"] == 12
    assert 3 <= got["batches"] <= 8 and len(got["per_batch"]) == got["batches"]
    seen = got["epochs_seen_while_routing"]
    assert set(seen) <= set(range(1, 13)) and seen == sorted(seen)
    assert got["reclustered_underneath"] == (len(seen) >= 2)


def test_decision_vs_window_times_both_sides():
    out = daemon_bench.decision_vs_window(n_files=500, n_windows=4, rounds=2, device="cpu")
    for key in ("daemon_decision_p50_seconds", "controller_window_p50_seconds",
                "daemon_over_controller_p50"):
        assert out[key] > 0
