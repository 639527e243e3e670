"""The port's scenario cells against the reference's ``run_cell`` from the
reference's cold init carried in (part 2): integrity and scrub, the
streaming daemon with its live HTTP plane, the random cells, and the
decay-0.7 cells against ``backend="numpy"`` (``control-shift`` also
reproducing the pinned ``data/control_bench.json``).  The helpers and the
comparison are part 1's (``test_torch_scenario_parity.py``)."""

import json
import os

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.scenarios import run_cell as ref_run_cell  # noqa: E402
from test_torch_scenario_parity import (COMPARED, NumpyDraws, assert_cells_match,  # noqa: E402
                                        carried_init, run_pair, spec_pair)

from cdrs_tpu_torch.scenarios import run_cell  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_integrity_scrub_matches_the_reference():
    got, want = run_pair("integrity-scrub")
    assert_cells_match(got, want)
    inv = got["invariants"]
    assert got["ok"] and inv["corruption_engaged"] and inv["rot_cleaned"]
    assert inv["zero_silent_loss"] and inv["resume_bit_identical"]


def test_daemon_stream_matches_the_reference():
    """Three daemons, the live HTTP plane scraped over real HTTP, the
    SIGTERM-flag stop and resume: the same verdicts as the reference's."""
    got, want = run_pair("daemon-stream")
    assert_cells_match(got, want)
    inv = got["invariants"]
    for key in ("endpoint_engaged", "trace_engaged", "trace_reconciled", "daemon_engaged",
                "daemon_decisions_identical", "daemon_epoch_pinned",
                "daemon_resume_bit_identical", "drift_engaged", "faults_engaged"):
        assert inv[key] is True, key


@pytest.mark.parametrize("name,seed", [("random-s0-0", 0), ("random-s2-0", 2)])
def test_random_cell_matches_the_reference(name, seed):
    got, want = run_pair(name, seed)
    assert_cells_match(got, want)
    assert got["ok"], got["invariants"]


@pytest.mark.parametrize("name", ["adversarial-drift", "gradual-drift"])
def test_decay_cell_matches_the_numpy_reference(name):
    got, want = run_pair(name)
    assert_cells_match(got, want)
    assert got["ok"] and got["invariants"]["drift_engaged"]
    assert got["invariants"]["alerts_silent"]


def test_gradual_drift_departs_only_through_the_reseed_generator():
    """ROADMAP C3: from the numpy reference's inits alone, ``gradual-drift``
    differs only where its one empty cluster is reseeded (window 14's warm
    re-cluster empties cluster 3 at its first Lloyd iteration): the port
    draws the row from its own generator, the reference from
    ``default_rng(42)``.  Verdicts and coverage stay the reference's; the
    moved bytes and the final plan do not (with the row carried, the cell
    is the reference's: ``test_decay_cell_matches_the_numpy_reference``)."""
    port_spec, ref_spec = spec_pair("gradual-drift")
    draws = NumpyDraws()
    with draws.recording():
        want = ref_run_cell(ref_spec)
    reseeded = [r for r in draws.reseeds.values() if r]
    assert len(reseeded) == 1 and list(reseeded[0]) == [0] and list(reseeded[0][0]) == [3]
    with carried_init(draws, reseeds=False):
        got = run_cell(port_spec, device="cpu")
    for key in COMPARED:
        if key != "metrics":
            assert got[key] == want[key], key
    assert {k for k in want["metrics"] if got["metrics"][k] != want["metrics"][k]} == \
        {"bytes_migrated_total", "churn_bytes_total", "plan_hash"}


def test_control_shift_matches_the_reference_and_the_pinned_artifact():
    """``control-shift`` (decay 0.7) from the numpy reference's inits gives
    the reference's cell and the controller headline pinned in
    ``data/control_bench.json``."""
    got, want = run_pair("control-shift")
    assert_cells_match(got, want)
    with open(os.path.join(REPO, "data", "control_bench.json"), encoding="utf-8") as f:
        pinned = json.load(f)["controller"]
    assert got["metrics"]["bytes_migrated_total"] == pinned["bytes_migrated_total"]
    assert got["metrics"]["reclusters"] == pinned["reclusters"]
    assert got["ok"], got["invariants"]
