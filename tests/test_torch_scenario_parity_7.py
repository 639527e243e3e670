"""The port's mesh cell, ``scale-mesh`` (``{"data": 8}``, 300 files, a
hot/archival flip, a kill/resume at window 7), against the reference's
``run_cell`` on its 8 virtual CPU devices at suite seed 0, from the
reference's cold init carried in (part 1's helpers and comparison,
``test_torch_scenario_parity.py``): invariants, metrics, coverage bits and
fingerprint agree, and the cell is green with ``mesh_engaged``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_scenario_parity import assert_cells_match, run_pair  # noqa: E402

from cdrs_tpu_torch.scenarios import preset, run_cell  # noqa: E402


def test_scale_mesh_matches_the_reference():
    got, want = run_pair("scale-mesh")
    assert_cells_match(got, want)
    assert got["ok"], got["invariants"]
    inv = got["invariants"]
    assert inv["mesh_engaged"] and inv["resume_bit_identical"] and inv["drift_engaged"]


def test_scale_mesh_on_the_ports_own_init_is_green():
    cell = run_cell(preset("scale-mesh"), device="cpu")
    assert cell["ok"], cell["invariants"]
    assert cell["invariants"]["mesh_engaged"]
