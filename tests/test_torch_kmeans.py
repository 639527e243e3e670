"""The port's KMeans (``ops/kmeans.kmeans_full``) against ``kmeans_jax_full``.

The port draws its init and reseed noise from ``torch.Generator``s, not
JAX's threefry stream, so loop parity carries the reference's D² init
across (``kmeans_jax_full(..., max_iter=0)`` returns it; it reaches the
port through ``convert.params_from_reference``).  From there labels and
``n_iter`` are identical and centroids agree within 1e-5 (f32 sums taken
in another order).  Cold inits are compared by the quality they reach:
inertia within 5% of the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.config import ScoringConfig as JScoringConfig  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402

from cdrs_tpu_torch.convert import params_from_reference  # noqa: E402
from cdrs_tpu_torch.ops.kmeans import (kmeans, kmeans_full,  # noqa: E402
                                       resolve_init_method)


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def blobs(seed, n=1999, d=5, centers=7, spread=0.08):
    rng = np.random.default_rng(seed)
    mu = rng.random((centers, d))
    lab = rng.integers(0, centers, n)
    return (mu[lab] + spread * rng.normal(size=(n, d))).astype(np.float32)


def carried_init(X, k, seed):
    init = np.asarray(kmeans_jax_full(X, k, seed=seed, max_iter=0, tol=0.0,
                                      dtype=np.float32)[0])
    state = params_from_reference(init, dataclasses.asdict(JScoringConfig()))
    return init, state["centroids"]


def inertia(X, centroids, labels):
    c = np.asarray(centroids, np.float64)
    return float(((X.astype(np.float64) - c[np.asarray(labels)]) ** 2).sum())


@pytest.mark.parametrize("tol,max_iter", [(1e-4, 100), (0.0, 12)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loop_matches_reference_from_carried_init(seed, tol, max_iter):
    X = blobs(seed)
    k = 7
    init, init_t = carried_init(X, k, seed)
    c_j, lab_j, it_j, _ = kmeans_jax_full(X, k, seed=seed, tol=tol, max_iter=max_iter,
                                          init_centroids=init, dtype=np.float32)
    c, lab, it, shift = kmeans_full(torch.from_numpy(X), k, seed=seed, tol=tol,
                                    max_iter=max_iter, init_centroids=init_t)
    assert c.dtype == torch.float32 and lab.dtype == torch.int32
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
    assert it == it_j
    if tol <= 0:
        assert it == max_iter
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=1e-5)


def test_max_iter_zero_returns_the_init_and_its_labels():
    X = blobs(4)
    init, init_t = carried_init(X, 5, 4)
    c, lab, it, shift = kmeans_full(torch.from_numpy(X), 5, init_centroids=init_t,
                                    max_iter=0)
    _, lab_j, _, _ = kmeans_jax_full(X, 5, init_centroids=init, max_iter=0,
                                     dtype=np.float32)
    assert it == 0 and shift == float("inf")
    np.testing.assert_array_equal(c.numpy(), init.astype(np.float32))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))


def test_first_iteration_always_runs():
    """it == 0 runs whatever tol says (the reference's loop condition)."""
    X = blobs(5)
    init, init_t = carried_init(X, 4, 5)
    _, _, it, _ = kmeans_full(torch.from_numpy(X), 4, tol=1e9, init_centroids=init_t)
    _, _, it_j, _ = kmeans_jax_full(X, 4, tol=1e9, init_centroids=init, dtype=np.float32)
    assert it == it_j == 1


def test_empty_cluster_reseeds_to_a_data_row_deterministically():
    X = blobs(6, n=800)
    init = X[:5].copy()
    init[3] = 1e3                               # owns no point at iteration 0
    runs = [kmeans_full(torch.from_numpy(X), 5, seed=9, tol=0.0, max_iter=1,
                        init_centroids=init) for _ in range(2)]
    c = runs[0][0].numpy()
    assert (np.abs(X - c[3]).max(axis=1) == 0).any()     # a row of X
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    # Another global iteration index draws another row.
    c_off = kmeans_full(torch.from_numpy(X), 5, seed=9, tol=0.0, max_iter=1,
                        init_centroids=init, iter_offset=7)[0].numpy()
    assert (np.abs(X - c_off[3]).max(axis=1) == 0).any()


@pytest.mark.parametrize("init_method", ["d2", "kmeans||"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cold_init_reaches_reference_inertia(seed, init_method):
    X = blobs(seed + 10, n=2000, d=4, centers=8, spread=0.01)
    c_j, lab_j, _, _ = kmeans_jax_full(X, 8, seed=seed, max_iter=100,
                                       init_method=init_method, dtype=np.float32)
    c, lab = kmeans(torch.from_numpy(X), 8, seed=seed, max_iter=100,
                    init_method=init_method)
    ref = inertia(X, c_j, lab_j)
    got = inertia(X, c.numpy(), lab.numpy())
    assert got <= 1.05 * ref, (got, ref)


def test_cold_init_is_deterministic_per_seed():
    X = torch.from_numpy(blobs(3))
    a = kmeans_full(X, 6, seed=11)
    b = kmeans_full(X, 6, seed=11)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]


def test_init_method_resolution_and_auto_fallback():
    assert resolve_init_method("auto", 255) == "d2"
    assert resolve_init_method("auto", 256) == "kmeans||"
    assert resolve_init_method("d2", 4096) == "d2"
    X = torch.from_numpy(blobs(7, n=300))
    # per-round sample ceil(10 * 256 / 5) = 512 > 300 rows: auto falls back
    c, lab = kmeans(X, 256, seed=0, max_iter=2, init_method="auto", init_oversample=10)
    assert c.shape == (256, 5) and lab.shape == (300,)
    with pytest.raises(ValueError, match="kmeans\\|\\|"):
        kmeans(X, 256, seed=0, max_iter=2, init_method="kmeans||", init_oversample=10)


def test_padding_rows_are_never_clustered():
    X = blobs(8, n=500)
    pad = np.concatenate([X, np.full((12, 5), 50.0, np.float32)])
    init = X[:4].copy()
    a = kmeans_full(torch.from_numpy(X), 4, init_centroids=init, seed=1)
    b = kmeans_full(torch.from_numpy(pad), 4, init_centroids=init, seed=1, n_valid=500)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="exceeds"):
        kmeans_full(torch.from_numpy(X[:3]), 4)
