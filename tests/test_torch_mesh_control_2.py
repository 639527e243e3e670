"""The port's controller on a mesh against the reference's controller on its
own mesh (``backend="jax"``, 8 virtual CPU devices), on
``test_torch_mesh_control.py``'s fixture: the port's cold re-clusters carry
the reference's D² init (the same at any mesh shape on both sides), and
then every record field is identical (the ``mesh`` stamp included) and
the drift scalars agree within 1e-6 (float32 on both sides, sums added in
another order)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.control import ControllerConfig as RefConfig  # noqa: E402
from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402
from cdrs_tpu.sim.access import simulate_access_with_shift as ref_shift  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402
from test_torch_mesh_control import DRIFT_FIELDS, run  # noqa: E402

from cdrs_tpu_torch.config import GeneratorConfig, validated_scoring_config  # noqa: E402
from cdrs_tpu_torch.io.events import EventLog  # noqa: E402
from cdrs_tpu_torch.models.replication import ReplicationPolicyModel  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    ref_m = ref_generate(jcfg.GeneratorConfig(n_files=403, seed=7))
    ref_e, _ = ref_shift(ref_m, jcfg.SimulatorConfig(duration_seconds=1200.0, seed=8), 600.0,
                         {"hot": "archival", "archival": "hot"})
    manifest = generate_population(GeneratorConfig(n_files=403, seed=7))
    events = EventLog(ts=ref_e.ts, path_id=ref_e.path_id, op=ref_e.op,
                      client_id=ref_e.client_id, clients=list(ref_e.clients))
    scoring = dataclasses.replace(validated_scoring_config(), median_method="hist")
    return (manifest, events, scoring), (ref_m, ref_e)


@pytest.fixture
def reference_init(monkeypatch):
    run_model = ReplicationPolicyModel.run

    def from_reference_init(self, X, feature_names=None, init_centroids=None, **kw):
        if init_centroids is None:
            init_centroids = np.asarray(kmeans_jax_full(
                X.cpu().numpy(), self.kmeans_cfg.k, seed=self.kmeans_cfg.seed,
                max_iter=0, tol=0.0)[0])
        return run_model(self, X, feature_names, init_centroids=init_centroids, **kw)

    monkeypatch.setattr(ReplicationPolicyModel, "run", from_reference_init)


@pytest.mark.parametrize("mesh", [{"data": 8}, {"data": 2, "model": 2}], ids=str)
def test_mesh_run_matches_the_reference_mesh_run(pair, reference_init, mesh):
    (port_scn, (ref_m, ref_e)) = pair
    cfg = RefConfig(window_seconds=100.0, drift_threshold=0.02, backend="jax",
                    kmeans=jcfg.KMeansConfig(k=12, seed=42),
                    scoring=dataclasses.replace(jcfg.validated_scoring_config(),
                                                median_method="hist"),
                    mesh_shape=mesh, default_rf=2)
    want = RefController(ref_m, cfg).run(ref_e)
    got = run(port_scn, mesh)
    assert len(got.records) == len(want.records) > 0
    assert sum(r["recluster"] for r in got.records) >= 2
    for g, w in zip(got.records, want.records):
        assert set(g) == set(w), set(g) ^ set(w)
        for key in w:
            if key == "seconds":
                continue
            if key in DRIFT_FIELDS and w[key] is not None:
                assert g[key] == pytest.approx(w[key], abs=1e-6), (w["window"], key)
            else:
                assert g[key] == w[key], (w["window"], key, g[key], w[key])
    np.testing.assert_array_equal(got.rf, want.rf)
    np.testing.assert_array_equal(got.category_idx, want.category_idx)
