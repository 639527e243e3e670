"""The port's pipeline against ``cdrs_tpu.run_pipeline(backend="jax")``.

At 2,000 files, k = 8, validated scoring with medians from the data, the
port runs on the CPU at float64 (the JAX package computes in float64 under
the suite's x64 mode) from the reference's D² init.  Labels, categories,
planted accuracy, ``assignments.csv`` and the category column of
``final_categories.csv`` are identical; centroid values agree within 1e-5.
"""

import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.features.jax_backend import compute_features_jax  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402
from cdrs_tpu.pipeline import run_pipeline as run_reference  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as jsimulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as jgenerate  # noqa: E402

from cdrs_tpu_torch import (GeneratorConfig, KMeansConfig, PipelineConfig,  # noqa: E402
                            SimulatorConfig, run_pipeline, validated_scoring_config)

ROOT = Path(__file__).resolve().parent.parent
N, K = 2000, 8


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_matches_reference(seed, tmp_path):
    ref_cfg = jcfg.PipelineConfig(
        backend="jax", generator=jcfg.GeneratorConfig(n_files=N, seed=seed),
        simulator=jcfg.SimulatorConfig(seed=seed + 1),
        kmeans=jcfg.KMeansConfig(k=K, seed=seed), scoring=jcfg.validated_scoring_config())
    ref = run_reference(ref_cfg, outdir=str(tmp_path / "jax"))
    manifest = jgenerate(ref_cfg.generator)
    norm = compute_features_jax(manifest, jsimulate(manifest, ref_cfg.simulator)).norm
    init = np.asarray(kmeans_jax_full(norm, K, seed=seed, max_iter=0, tol=0.0)[0])

    cfg = PipelineConfig(
        device="cpu", dtype="float64", generator=GeneratorConfig(n_files=N, seed=seed),
        simulator=SimulatorConfig(seed=seed + 1), kmeans=KMeansConfig(k=K, seed=seed),
        scoring=validated_scoring_config())
    got = run_pipeline(cfg, outdir=str(tmp_path / "port"), init_centroids=init)

    np.testing.assert_array_equal(got.decision.labels, np.asarray(ref.decision.labels))
    assert got.decision.categories == ref.decision.categories
    assert got.planted_accuracy == ref.planted_accuracy
    assert got.n_events == ref.n_events
    np.testing.assert_allclose(got.decision.centroids, ref.decision.centroids, atol=1e-5)
    for name in ("assignments.csv", "metadata.csv", "access.log"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    port_rows = _rows(tmp_path / "port" / "final_categories.csv")
    ref_rows = _rows(tmp_path / "jax" / "final_categories.csv")
    assert port_rows[0] == ref_rows[0]
    assert [r[1] for r in port_rows] == [r[1] for r in ref_rows]
    np.testing.assert_allclose(np.asarray([r[2:] for r in port_rows[1:]], float),
                               np.asarray([r[2:] for r in ref_rows[1:]], float), atol=1e-5)


def test_cli_writes_what_run_pipeline_writes(tmp_path):
    args = ["--n", "300", "--k", "4", "--seed", "3", "--duration_seconds", "120",
            "--scoring_config", "validated", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "cdrs_tpu_torch", "pipeline", *args,
         "--outdir", str(tmp_path / "cli")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout)
    assert summary["n_files"] == 300 and summary["device"] == "cpu"

    cfg = PipelineConfig(
        device="cpu", generator=GeneratorConfig(n_files=300, seed=3),
        simulator=SimulatorConfig(duration_seconds=120, seed=4),
        kmeans=KMeansConfig(k=4, seed=3), scoring=validated_scoring_config())
    result = run_pipeline(cfg, outdir=str(tmp_path / "api"))
    assert summary["planted_accuracy"] == result.planted_accuracy
    for name in ("metadata.csv", "access.log", "part-00000-features.csv",
                 "final_categories.csv", "assignments.csv"):
        assert (tmp_path / "cli" / name).read_bytes() == (tmp_path / "api" / name).read_bytes(), name


def test_model_state_dict_round_trips_the_scoring_tables():
    import dataclasses

    from cdrs_tpu_torch.convert import params_from_reference
    from cdrs_tpu_torch.models.replication import ReplicationPolicyModel

    ref = jcfg.validated_scoring_config()
    state = params_from_reference(np.eye(K, 5), dataclasses.asdict(ref))
    model = ReplicationPolicyModel(KMeansConfig(k=K), validated_scoring_config())
    model.load_state_dict(state)
    assert torch.equal(model.centroids, torch.eye(K, 5, dtype=torch.float64))
    np.testing.assert_array_equal(model.W.numpy(), np.asarray(ref.weight_matrix()))
    np.testing.assert_array_equal(model.rf.numpy(), np.asarray(ref.rf_vector(), float))
    assert model.band.item() == ref.moderate_band
    tables_only = params_from_reference(None, dataclasses.asdict(ref))
    assert "centroids" not in tables_only
    model.load_state_dict(tables_only, strict=False)
