"""The port's serving scenario cells against the reference's ``run_cell``
from the reference's cold init carried in (part 4: the serving chaos,
flash-crowd and SLO-burn cells of ``ci-smoke`` at seed 0).  The helpers
and the comparison are part 1's (``test_torch_scenario_parity.py``): the
cell records agree in invariants, metrics (``latency_p99_ms_final``
included), coverage bits and fingerprint."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_scenario_parity import assert_cells_match, run_pair  # noqa: E402

#: The serve invariants each cell must evaluate, besides the cell's own.
SERVE_INVARIANTS = {"serve_engaged", "slo_p99", "slo_no_unavailable_final"}


@pytest.mark.parametrize("name,extra", [
    ("serve-chaos", {"slo_burn", "faults_engaged"}),
    ("flash-crowd", set()),
    ("slo-burn", set()),
])
def test_serving_cell_matches_the_reference(name, extra):
    got, want = run_pair(name)
    assert_cells_match(got, want)
    assert got["ok"], got["invariants"]
    assert SERVE_INVARIANTS | extra <= set(got["invariants"])
    assert got["metrics"]["latency_p99_ms_final"] is not None
    assert f"scenario_{name}_p99_ms" in {r["metric"] for r in got["bench_records"]}
