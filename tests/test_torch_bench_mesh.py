"""The port's ``benchmarks/mesh_bench`` against the reference's on the CPU:
decision identity and the controller's records.

The reference runs its mesh on the 8 virtual CPU devices that
``tests/conftest.py`` sets; the port's CPU mesh puts every shard on the
CPU.  From the reference's cold init (``carried_init``; the reference's
controller runs on ``backend="jax"``), the port's controller at one device
and at ``{"data": 4}`` must give the reference's records exactly but for
the wall clock and the drift scalars, which agree within 1e-5 (the port
forms drift on the host in float64, the reference in float32).  The
throughput and data = 1 overhead blocks are held in
``test_torch_bench_mesh_2.py``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402

import cdrs_tpu.benchmarks.mesh_bench as ref  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import assert_matches, one_torch_thread, round_trips  # noqa: E402

from cdrs_tpu_torch.benchmarks import mesh_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: The drift scalars of a record, compared within ``mesh_bench.DRIFT_TOL``.
DRIFT = ("drift", "centroid_shift", "population_delta")


def test_decision_identity_on_the_cpu_mesh_is_ok(tmp_path):
    out = mesh_bench._decision_identity([0], 4, device="cpu")
    assert out["ok"] and out["devices"] == 4
    (row,) = out["seeds"]
    assert row["decisions_identical"] and row["resume_across_shapes_identical"]
    assert row["drift_score_max_diff"] < mesh_bench.DRIFT_TOL and row["windows"] == 12
    round_trips(out, tmp_path)


@pytest.mark.parametrize("mesh", [None, {"data": 4}], ids=["one_device", "data4"])
def test_controller_records_are_the_references(mesh):
    manifest, events, scoring = mesh_bench._controller_scenario(0)
    r_manifest, r_events, r_scoring = ref._controller_scenario(0)
    assert scoring.median_method == r_scoring.median_method == "hist"
    want = ref._controller_run(r_manifest, r_events, r_scoring, mesh, 0)
    with carried_init():
        got = mesh_bench._controller_run(manifest, events, scoring, mesh, 0, device="cpu")
    assert len(got.records) == len(want.records) == 12
    assert_matches(got.records, want.records, rel=0.0, skip={"seconds", *DRIFT})
    assert_matches([[r.get(f) for f in DRIFT] for r in got.records],
                   [[r.get(f) for f in DRIFT] for r in want.records], rel=mesh_bench.DRIFT_TOL)
    assert np.array_equal(got.rf, want.rf)
    assert np.array_equal(got.category_idx, want.category_idx)
