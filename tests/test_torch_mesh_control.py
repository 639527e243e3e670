"""The port's controller on a mesh (``ControllerConfig(mesh_shape=)``): the
counterparts of ``tests/test_mesh_control.py`` — decision identity with
one device, portability of a checkpoint across mesh shapes, the model's
labels and populations, the config's checks and the ``mesh`` record
stamp — on the reference's fixture (403 files, not divisible by 8; a
hot/archival flip at 600 s; histogram medians on both sides, whose counts
are integers at any mesh shape).  The drift scalars of a mesh run come
from the device (``detect_drift_torch``) and those of one device from the
host oracle, so they agree within 1e-5, as in the reference.  The run
against the reference's own mesh is in ``test_torch_mesh_control_2.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.parallel.mesh import collective_bytes_estimate  # noqa: E402

from cdrs_tpu_torch.config import (GeneratorConfig, KMeansConfig,  # noqa: E402
                                   SimulatorConfig, validated_scoring_config)
from cdrs_tpu_torch.control.controller import (ControllerConfig,  # noqa: E402
                                               ReplicationController)
from cdrs_tpu_torch.models.replication import ReplicationPolicyModel  # noqa: E402
from cdrs_tpu_torch.obs.aggregate import pacing_digest  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access_with_shift  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

DRIFT_FIELDS = ("drift", "centroid_shift", "population_delta")


@pytest.fixture(scope="module")
def scenario():
    manifest = generate_population(GeneratorConfig(n_files=403, seed=7))
    events, _ = simulate_access_with_shift(
        manifest, SimulatorConfig(duration_seconds=1200.0, seed=8), 600.0,
        {"hot": "archival", "archival": "hot"})
    scoring = dataclasses.replace(validated_scoring_config(), median_method="hist")
    return manifest, events, scoring


def run(scenario, mesh, checkpoint_path=None, max_windows=None):
    manifest, events, scoring = scenario
    cfg = ControllerConfig(window_seconds=100.0, drift_threshold=0.02,
                           kmeans=KMeansConfig(k=12, seed=42), scoring=scoring,
                           mesh_shape=mesh, default_rf=2, device="cpu")
    return ReplicationController(manifest, cfg).run(events, checkpoint_path=checkpoint_path,
                                                    max_windows=max_windows)


def strip(records):
    drop = ("seconds", "mesh") + DRIFT_FIELDS
    return [{k: v for k, v in r.items() if k not in drop} for r in records]


def assert_drift_close(got, want, tol=1e-5):
    for a, b in zip(got, want):
        for f in DRIFT_FIELDS:
            if b.get(f) is None:
                assert a.get(f) is None
            else:
                assert a[f] == pytest.approx(b[f], abs=tol), (b["window"], f)


@pytest.fixture(scope="module")
def one_device(scenario):
    return run(scenario, None)


@pytest.fixture(scope="module")
def data8(scenario):
    return run(scenario, {"data": 8})


def test_mesh_run_decision_identical_to_single_device(one_device, data8):
    r1, r8 = one_device, data8
    assert sum(r["recluster"] for r in r1.records) >= 2
    assert strip(r1.records) == strip(r8.records)
    assert np.array_equal(r1.rf, r8.rf) and np.array_equal(r1.category_idx, r8.category_idx)
    assert [r["plan_hash"] for r in r1.records] == [r["plan_hash"] for r in r8.records]
    assert_drift_close(r8.records, r1.records)
    assert all(r["mesh"]["devices"] == 8 for r in r8.records)
    assert all("mesh" not in r for r in r1.records)


def test_model_axis_run_decision_identical(scenario, one_device):
    r = run(scenario, {"data": 2, "model": 2})
    assert strip(r.records) == strip(one_device.records)
    assert all(rec["mesh"]["devices"] == 4 for rec in r.records)


@pytest.mark.parametrize("from_mesh,to_mesh", [(None, {"data": 8}), ({"data": 8}, None)])
def test_checkpoint_portable_across_mesh_shapes(scenario, tmp_path, from_mesh, to_mesh,
                                                one_device, data8):
    full = data8 if to_mesh else one_device
    ck = str(tmp_path / "mesh.npz")
    a = run(scenario, from_mesh, checkpoint_path=ck, max_windows=6)
    b = run(scenario, to_mesh, checkpoint_path=ck)
    assert strip(a.records) + strip(b.records) == strip(full.records)
    assert np.array_equal(b.rf, full.rf) and np.array_equal(b.category_idx, full.category_idx)
    assert_drift_close(b.records, full.records[len(a.records):])


def test_model_assignments_and_populations_identical(scenario):
    _, _, scoring = scenario
    X = torch.from_numpy(np.random.default_rng(5).random((403, 5)).astype(np.float32))
    km = KMeansConfig(k=12, seed=42)
    d1 = ReplicationPolicyModel(km, scoring).run(X)
    for mesh in ({"data": 8}, {"data": 2, "model": 2}):
        d = ReplicationPolicyModel(km, scoring, mesh_shape=mesh).run(X)
        np.testing.assert_array_equal(d1.labels, d.labels)
        np.testing.assert_array_equal(d1.category_idx, d.category_idx)
        np.testing.assert_array_equal(np.bincount(d1.category_idx[d1.labels], minlength=4),
                                      np.bincount(d.category_idx[d.labels], minlength=4))


def test_mesh_requires_decay_one():
    """The reference's mesh needs its jax backend, whose fold has no
    decayed counters: the port refuses a decayed mesh."""
    with pytest.raises(ValueError, match="mesh_shape requires decay 1.0"):
        ControllerConfig(decay=0.7, mesh_shape={"data": 8}, device="cpu")


def test_mesh_shape_validated_at_config():
    with pytest.raises(ValueError, match="unknown mesh axis"):
        ControllerConfig(mesh_shape={"rows": 8}, device="cpu")
    with pytest.raises(ValueError, match="must be >= 1"):
        ControllerConfig(mesh_shape={"data": 0}, device="cpu")
    assert ControllerConfig(mesh_shape={"data": "4"}, device="cpu").mesh_shape == {"data": 4}


def test_mesh_records_carry_collective_estimate(scenario):
    r = run(scenario, {"data": 4}, max_windows=3)
    want = collective_bytes_estimate(12 * 6 * 4, 4)
    assert all(rec["mesh"] == {"devices": 4, "collective_bytes_per_iter": want}
               for rec in r.records)
    assert list(r.records[0])[:3] == ["window", "n_events", "mesh"]


def test_pacing_digest_surfaces_devices(data8, one_device):
    pacing = pacing_digest(data8.records)
    assert pacing["devices"] == 8 and pacing["collective_bytes_per_iter"] > 0
    assert "devices" not in pacing_digest(one_device.records)
