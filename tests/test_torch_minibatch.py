"""The port's mini-batch KMeans (``ops/kmeans_stream.py``) and the model's
``batch_size`` path against ``cdrs_tpu``'s.

From a carried init (the port's D² noise is not JAX's threefry stream),
over the same batches: labels identical, int32 totals exact, centroids
within 1e-5 (float32 sums taken in another order).  The model's
mini-batch path gives identical labels and categories to the reference
model with ``backend="jax"``: both shuffle with the same numpy generator.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.features.jax_backend import compute_features_jax  # noqa: E402
from cdrs_tpu.models.replication import ReplicationPolicyModel as JModel  # noqa: E402
from cdrs_tpu.ops.kmeans_stream import MiniBatchKMeans as JMiniBatchKMeans  # noqa: E402
from cdrs_tpu.ops.kmeans_stream import MiniBatchState as JMiniBatchState  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as jsimulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as jgenerate  # noqa: E402

from cdrs_tpu_torch.config import KMeansConfig, validated_scoring_config  # noqa: E402
from cdrs_tpu_torch.models.replication import ReplicationPolicyModel  # noqa: E402
from cdrs_tpu_torch.ops.kmeans_stream import (MiniBatchKMeans, MiniBatchState,  # noqa: E402
                                              minibatch_init, minibatch_update)
from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def blobs(seed, n, d=5, centers=6, spread=0.05):
    rng = np.random.default_rng(seed)
    mu = rng.random((centers, d))
    lab = rng.integers(0, centers, n)
    return (mu[lab] + spread * rng.normal(size=(n, d))).astype(np.float32), mu


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_updates_match_the_reference_from_a_carried_init(seed):
    X, _ = blobs(seed, 3000)
    k, bs = 6, 317                     # the last batch of the pass is short
    init = X[np.random.default_rng(seed + 100).choice(len(X), k, replace=False)]
    ref = JMiniBatchKMeans(k=k, seed=seed)
    ref.state = JMiniBatchState(jnp.asarray(init), jnp.zeros((k,), jnp.int32))
    port = MiniBatchKMeans(k=k, seed=seed, device="cpu")
    port.state = MiniBatchState(torch.from_numpy(init.copy()),
                                torch.zeros(k, dtype=torch.int32))
    for epoch in range(2):
        for lo in range(0, len(X), bs):
            want = np.asarray(ref.partial_fit(X[lo:lo + bs]))
            got = port.partial_fit(X[lo:lo + bs])
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(port.state.counts.numpy(), np.asarray(ref.state.counts))
        assert port.state.counts.dtype == torch.int32
        np.testing.assert_allclose(port.centroids.numpy(), ref.centroids, atol=1e-5)
    np.testing.assert_array_equal(port.predict(X).numpy(), ref.predict(X))
    assert port.state.n_batches == 2 * -(-len(X) // bs)


def test_one_update_is_one_fused_step_then_the_sculley_step():
    X, _ = blobs(5, 500)
    c = torch.from_numpy(X[:4].copy())
    state = MiniBatchState(c, torch.tensor([0, 3, 10, 2**20], dtype=torch.int32))
    new, labels = minibatch_update(state, torch.from_numpy(X))
    lab, sums, cnt = lloyd_assign_reduce(torch.from_numpy(X), c, len(X))
    assert torch.equal(labels, lab)
    total = state.counts + cnt.int()
    assert torch.equal(new.counts, total)
    eta = torch.where(cnt > 0, cnt / total.clamp(min=1).float(), 0.0)
    want = c + eta[:, None] * (sums / cnt.clamp(min=1)[:, None] - c)
    assert torch.equal(new.centroids, want)


def test_cold_init_recovers_blobs():
    """The first batch seeds the D² init; the learned centroids find every
    planted center and predict keeps each blob together."""
    X, mu = blobs(7, 4096, centers=5, spread=0.02)
    mb = MiniBatchKMeans(k=5, seed=3, device="cpu")
    for lo in range(0, len(X), 512):
        mb.partial_fit(torch.from_numpy(X[lo:lo + 512]))
    c = mb.centroids.numpy()
    assert np.linalg.norm(mu[:, None] - c[None], axis=2).min(axis=1).max() < 0.05
    again = MiniBatchKMeans(k=5, seed=3, device="cpu")
    again.partial_fit(X[:512])
    first = MiniBatchKMeans(k=5, seed=3, device="cpu")
    first.partial_fit(torch.from_numpy(X[:512]))
    assert torch.equal(again.centroids, first.centroids)


def test_first_batch_smaller_than_k_raises():
    X, _ = blobs(8, 50)
    with pytest.raises(ValueError, match="first mini-batch has 5 rows < k=6"):
        minibatch_init(X[:5], 6, seed=0, device="cpu")
    with pytest.raises(ValueError, match="no batches seen yet"):
        MiniBatchKMeans(k=3, device="cpu").predict(X)


def _feature_table(seed, n=2000):
    manifest = jgenerate(jcfg.GeneratorConfig(n_files=n, seed=seed))
    return compute_features_jax(manifest, jsimulate(
        manifest, jcfg.SimulatorConfig(seed=seed + 1))).norm


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_batch_size_matches_the_reference_model(seed):
    X = np.array(_feature_table(seed))
    k = 8
    init = X[np.random.default_rng(seed).choice(len(X), k, replace=False)]
    ref = JModel(kmeans_cfg=jcfg.KMeansConfig(k=k, seed=seed, batch_size=256),
                 scoring_cfg=jcfg.validated_scoring_config(), backend="jax").run(
                     X, init_centroids=init)
    model = ReplicationPolicyModel(KMeansConfig(k=k, seed=seed, batch_size=256),
                                   validated_scoring_config())
    got = model.run(torch.from_numpy(X), init_centroids=init)
    np.testing.assert_array_equal(got.labels, np.asarray(ref.labels))
    assert got.categories == ref.categories
    np.testing.assert_allclose(got.centroids, ref.centroids, atol=1e-5)
    assert model.n_iter == 5 * -(-len(X) // 256)
    assert model.centroids.dtype == torch.float32


def test_model_batch_size_rules():
    X = torch.from_numpy(blobs(9, 300)[0])
    with pytest.raises(ValueError, match="batch_size=4 must be >= k=6"):
        ReplicationPolicyModel(KMeansConfig(k=6, batch_size=4)).cluster(X)
    # A warm start takes batches smaller than k.
    c, lab = ReplicationPolicyModel(KMeansConfig(k=6, batch_size=4, batch_epochs=1)).cluster(
        X, init_centroids=X[:6].numpy())
    assert c.shape == (6, 5) and lab.shape == (300,)
    with pytest.raises(ValueError, match="batch_size must be >= 1"):
        ReplicationPolicyModel(KMeansConfig(k=2, batch_size=0)).cluster(X)
    with pytest.raises(ValueError, match="always runs float32"):
        ReplicationPolicyModel(KMeansConfig(k=2, batch_size=64, dtype="bfloat16")).cluster(X)
    with pytest.raises(ValueError, match="cannot cluster"):
        ReplicationPolicyModel(KMeansConfig(k=6, batch_size=64)).cluster(X[:5])
