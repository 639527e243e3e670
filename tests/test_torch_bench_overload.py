"""The port's ``benchmarks/overload_bench`` against the reference's
``run_availability``, ``run_coalesce_determinism``, ``_window_slices`` and
``run_overload_sustain`` on the CPU.

A pre-written overfed log is deterministic: from the reference's cold init
(decay 1: the reference on ``backend="jax"``) the availability run and the
coalescing run must be the reference's in every field.  The sustained
overfeed paces a live writer by wall clock, so only its structure and its
verdicts at a feed the daemon outruns are compared here; the card's run is
chip_smoke's phase 18.  The coalescing run: ``test_torch_bench_overload_2.py``."""

import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.overload_bench as ref  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import (assert_matches, one_torch_thread,  # noqa: E402
                                reference_on_jax, round_trips)

from cdrs_tpu_torch.benchmarks import overload_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QUICK = dict(n_files=1_500, n_windows=12)


def check_overfed_run(fn, tmp_path):
    """One overfed run at ``--quick``'s scale against the reference's."""
    with reference_on_jax(ref):
        want = getattr(ref, fn)(**QUICK)
    with carried_init():
        got = getattr(overload_bench, fn)(**QUICK, device="cpu")
    assert_matches(got, want)
    round_trips(got, tmp_path)
    if fn == "run_availability":
        assert got["available_99"] and got["sheds_exercised"]
    else:
        assert got["records_identical"] and got["coalescing_engaged"]


@pytest.mark.parametrize("fn", ["run_availability"])
def test_overfed_runs_match_the_reference(fn, tmp_path):
    check_overfed_run(fn, tmp_path)


def test_window_slices_are_the_references():
    manifest, events = overload_bench._population(300, 600.0, 47)
    ref_manifest, ref_events = ref._population(300, 600.0, 47)
    got = overload_bench._window_slices(events, 60.0)
    want = ref._window_slices(ref_events, 60.0)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        for col in ("ts", "path_id", "op", "client_id"):
            assert np.array_equal(getattr(g, col), getattr(w, col))


def test_sustain_at_a_feed_the_daemon_outruns():
    """At a quarter of the calibrated rate the lag never builds: no rung
    engages, the run recovers at once, and the artifact has the
    reference's keys."""
    kw = dict(n_files=300, n_burst=3, n_calm=2, overfeed=0.25)
    got = overload_bench.run_overload_sustain(**kw, device="cpu")
    want = ref.run_overload_sustain(**kw)
    assert set(got) == set(want)
    assert got["n_windows"] == want["n_windows"] == 6
    assert got["lag_bounded"] and got["recovered_to_rung0"] and got["final_rung"] == 0
    assert got["stop_reason"] == want["stop_reason"] == "bench_done"


def test_overload_bench_main_criteria(tmp_path, capsys, monkeypatch):
    """``main`` on small scales (the sustain phase at a feed the daemon
    outruns, so its overfeed criterion is false by construction)."""
    calls = {}

    def small(name):
        fn = getattr(overload_bench, name)

        def run(**kw):
            calls[name] = kw
            kw = dict(kw, n_files=300)
            if name == "run_overload_sustain":
                kw.update(n_burst=3, n_calm=2, overfeed=0.25)
            else:
                kw.update(n_windows=8)
            return fn(**kw)
        return run

    for name in ("run_overload_sustain", "run_availability", "run_coalesce_determinism"):
        monkeypatch.setattr(overload_bench, name, small(name))
    out = tmp_path / "o.json"
    assert overload_bench.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    assert calls["run_availability"]["n_files"] == 1_500
    doc = json.loads(out.read_text())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["history_appended"] == 0
    assert set(doc["criteria"]) == {"lag_bounded_under_2x_overfeed",
                                    "ladder_recovered_to_rung0",
                                    "availability_99_excluding_sheds",
                                    "coalescing_deterministic"}
    assert doc["criteria"]["ladder_recovered_to_rung0"]
    assert [r["metric"] for r in doc["bench_records"]] == [
        "overload_max_lag_windows", "overload_availability_excluding_sheds",
        "overload_windows_coalesced"]
