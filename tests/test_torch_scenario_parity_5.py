"""The port's storage scenario cells against the reference's ``run_cell``
from the reference's cold init carried in (part 5): ``storage-ec`` at
seed 0 (EC(6,3)-cold Archival on 12 nodes in 4 racks, a rack crash) and
the random cells of the ``full`` suite that draw ``storage="replicate"``.
The helpers and the comparison are part 1's
(``test_torch_scenario_parity.py``): the cell records agree in
invariants, metrics, coverage bits and fingerprint."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_scenario_parity import assert_cells_match, run_pair, spec_pair  # noqa: E402


def test_storage_ec_cell_matches_the_reference():
    got, want = run_pair("storage-ec")
    assert_cells_match(got, want)
    assert got["ok"], got["invariants"]
    inv = got["invariants"]
    assert inv["ec_engaged"] and inv["zero_lost_final"] and inv["faults_engaged"]
    assert inv["domain_diversity"] and inv["alerts_expected"]
    assert got["metrics"]["files_lost_max"] == 0


@pytest.mark.parametrize("name,seed", [("random-s0-2", 0), ("random-s1-1", 1),
                                       ("random-s1-2", 1), ("random-s1-3", 1),
                                       ("random-s2-1", 2)])
def test_random_storage_cell_matches_the_reference(name, seed):
    assert spec_pair(name, seed)[0].storage == "replicate"
    got, want = run_pair(name, seed)
    assert_cells_match(got, want)
    assert got["ok"], got["invariants"]
    # A replicate-only config erasure-codes nothing: no ec_engaged check.
    assert "ec_engaged" not in got["invariants"]
