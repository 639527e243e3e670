"""The port's drift detector (``control/drift.py``) against
``cdrs_tpu.control.drift``.

* The host oracle ``detect_drift`` is a copy of the reference's float64
  numpy code: the same report, bit for bit.
* ``detect_drift_torch`` (on the CPU it runs the fused step's plain
  version) against ``detect_drift_jax`` and the reference oracle:
  centroid shift within 1e-4 (float32 points and sums against float64),
  fractions within 1e-6 and, when the labels agree, exactly equal (they
  come from exact integer counts).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.control.drift import detect_drift as ref_detect_drift  # noqa: E402
from cdrs_tpu.control.drift import detect_drift_jax  # noqa: E402
from cdrs_tpu.features.jax_backend import compute_features_jax  # noqa: E402
from cdrs_tpu.ops.kmeans_np import assign_labels as ref_assign_labels  # noqa: E402
from cdrs_tpu.ops.kmeans_np import kmeans as ref_kmeans_np  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as jsimulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as jgenerate  # noqa: E402

from cdrs_tpu_torch.config import CATEGORIES  # noqa: E402
from cdrs_tpu_torch.control.drift import (assign_labels, detect_drift,  # noqa: E402
                                          detect_drift_torch)
from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce  # noqa: E402

NCAT = len(CATEGORIES)


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def _model_and_snapshot(seed, n=3000, k=8):
    """An accepted model from one window's features and the next window's
    features (another simulator seed) as the snapshot."""
    manifest = jgenerate(jcfg.GeneratorConfig(n_files=n, seed=seed))
    first = np.array(compute_features_jax(
        manifest, jsimulate(manifest, jcfg.SimulatorConfig(seed=seed + 1))).norm)
    later = np.array(compute_features_jax(
        manifest, jsimulate(manifest, jcfg.SimulatorConfig(seed=seed + 2))).norm)
    centroids, labels = ref_kmeans_np(first, k, random_state=seed)
    cat_idx = np.random.default_rng(seed).integers(0, NCAT, k)
    frac = np.bincount(cat_idx[labels], minlength=NCAT) / n
    return later, centroids, cat_idx, frac


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_is_the_reference_oracle(seed):
    X, c, cat, frac = _model_and_snapshot(seed)
    got, want = detect_drift(X, c, cat, frac, NCAT), ref_detect_drift(X, c, cat, frac, NCAT)
    assert (got.score, got.centroid_shift, got.population_delta) == \
        (want.score, want.centroid_shift, want.population_delta)
    np.testing.assert_array_equal(got.fractions, want.fractions)
    np.testing.assert_array_equal(assign_labels(X, c, tile=777), ref_assign_labels(X, c))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_drift_matches_the_jax_drift_and_the_oracle(seed):
    X, c, cat, frac = _model_and_snapshot(seed)
    got = detect_drift_torch(torch.from_numpy(X), c, cat, frac, NCAT)
    for want in (detect_drift_jax(X, c, cat, frac, NCAT),
                 ref_detect_drift(X, c, cat, frac, NCAT)):
        assert abs(got.centroid_shift - want.centroid_shift) <= 1e-4
        np.testing.assert_allclose(got.fractions, want.fractions, rtol=0, atol=1e-6)
        assert abs(got.population_delta - want.population_delta) <= 1e-6
        assert abs(got.score - want.score) <= 1e-4
    # Labels of the fused step agree with the oracle's here, so the
    # fractions are the oracle's exactly.
    lab = lloyd_assign_reduce(torch.from_numpy(X.astype(np.float32)),
                              torch.from_numpy(c.astype(np.float32)))[0]
    np.testing.assert_array_equal(lab.numpy(), ref_assign_labels(X, c))
    oracle = ref_detect_drift(X, c, cat, frac, NCAT)
    np.testing.assert_array_equal(got.fractions, oracle.fractions)
    assert got.population_delta == oracle.population_delta


def test_torch_drift_takes_arrays_and_float64_tensors_on_the_cpu():
    X, c, cat, frac = _model_and_snapshot(3, n=800, k=4)
    a = detect_drift_torch(X, c, cat, frac, NCAT, device="cpu")
    b = detect_drift_torch(torch.from_numpy(X), c, cat, frac, NCAT)
    assert (a.score, a.centroid_shift, a.population_delta) == \
        (b.score, b.centroid_shift, b.population_delta)
    np.testing.assert_array_equal(a.fractions, b.fractions)


def test_drift_zero_on_unchanged_features():
    """Mirror of the reference's check: a converged model over the same
    data shows no drift, and moving half the population fires both
    signals."""
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0.2, 0.02, (150, 5)),
                        rng.normal(0.8, 0.02, (150, 5))]).clip(0, 1)
    centroids, labels = ref_kmeans_np(X, 2, random_state=0)
    cat_idx = np.asarray([0, 3])
    frac = np.bincount(cat_idx[labels], minlength=NCAT) / len(X)
    for detect in (detect_drift, detect_drift_torch):
        kwargs = {"device": "cpu"} if detect is detect_drift_torch else {}
        rep = detect(X, centroids, cat_idx, frac, NCAT, **kwargs)
        assert rep.score < 1e-3
        X2 = X.copy()
        X2[:150] = (X2[:150] + 0.6).clip(0, 1)
        rep2 = detect(X2, centroids, cat_idx, frac, NCAT, **kwargs)
        assert rep2.score > 0.1
        assert rep2.centroid_shift > 0.0 and rep2.population_delta > 0.0


def test_torch_drift_without_cuda_raises_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    X, c, cat, frac = _model_and_snapshot(4, n=200, k=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detect_drift_torch(X, c, cat, frac, NCAT)
