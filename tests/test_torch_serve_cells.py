"""The port's serving scenario cells, part 2: ``integrity-read``,
``diurnal`` and ``random-s0-1`` of ``ci-smoke`` at seed 0 against the
reference's ``run_cell`` from its carried cold init (the helpers of
``test_torch_scenario_parity.py``), and ``random-s0-3`` of the ``full``
suite (its ``least_loaded`` policy) holding its invariants on the port's
own CPU init.  The other serving cells of suite seeds 1 and 2 hold theirs
in ``test_torch_scenario_seeds.py``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_scenario_parity import assert_cells_match, run_pair  # noqa: E402

from cdrs_tpu_torch.scenarios import run_cell, suite_cells  # noqa: E402


@pytest.mark.parametrize("name", ["integrity-read", "diurnal", "random-s0-1"])
def test_serving_cell_matches_the_reference(name):
    got, want = run_pair(name)
    assert_cells_match(got, want)
    assert got["ok"], got["invariants"]
    assert got["invariants"]["serve_engaged"] and got["invariants"]["slo_p99"]
    if name == "integrity-read":
        assert "integrity:detected_read" in got["coverage"]
        assert got["invariants"]["corruption_engaged"]


def test_least_loaded_random_cell_holds_its_invariants_on_the_port_init():
    spec = {c.name: c for c in suite_cells("full", 0)}["random-s0-3"]
    assert spec.serve["policy"] == "least_loaded"
    cell = run_cell(spec, suite="full", suite_seed=0, device="cpu")
    assert cell["ok"], {k: v for k, v in cell["invariants"].items() if not v}
    assert cell["invariants"]["serve_engaged"]
