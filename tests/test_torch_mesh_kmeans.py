"""The port's KMeans on a mesh (``kmeans_full(mesh_shape=)``) against its own
one-device run and against ``kmeans_jax_full(mesh_shape=)`` on the
reference's 8 virtual CPU devices.

From one init, data = 2, 4 and 8 and ``{"data": 2, "model": 2}`` give the
one-device labels and iteration count, and centroids within 1e-5 (float32
sums added in another order).  Those ULPs can flip the label of a point
that is all but equidistant from two centroids, and the runs then part
(seen with the reference's init on ``blobs(2)`` at k = 7: 18 iterations on
four shards against 16 on one); tests that hold a run bit for bit or
against the reference use points on a 1/64 grid, where every sum is
exact.  Cold D² and k-means|| inits are
bit-identical at any shard count (the noise is drawn over every valid row
from one generator).  The reference carries its D² init across, as in
``test_torch_kmeans.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.config import ScoringConfig as JScoringConfig  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402

from cdrs_tpu_torch.convert import params_from_reference  # noqa: E402
from cdrs_tpu_torch.ops import kmeans as port_kmeans  # noqa: E402
from cdrs_tpu_torch.ops import lloyd as port_lloyd  # noqa: E402
from cdrs_tpu_torch.ops.kmeans import kmeans_full  # noqa: E402
from cdrs_tpu_torch.utils.checkpoint import kmeans_checkpointed, load_state  # noqa: E402

MESHES = [{"data": 2}, {"data": 4}, {"data": 8}, {"data": 2, "model": 2}]


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


def run(X, k, **kw):
    return kmeans_full(X, k, device="cpu", **kw)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("seed", [0, 1])
def test_mesh_equals_one_device(seed, mesh):
    X = blobs(seed)
    c1, l1, it1, s1 = run(X, 8, seed=seed)
    c, lab, it, s = run(X, 8, seed=seed, mesh_shape=mesh)
    assert it == it1
    assert torch.equal(lab, l1)
    assert float((c - c1).abs().max()) <= 1e-5
    assert abs(s - s1) <= 1e-5


@pytest.mark.parametrize("init", ["d2", "kmeans||"])
@pytest.mark.parametrize("n", [403, 1999])
def test_cold_inits_are_bit_identical_across_shard_counts(init, n):
    X = blobs(3, n=n)
    ref = run(X, 8, seed=5, max_iter=0, tol=0.0, init_method=init)[0]
    for ndata in (2, 3, 8):
        got = run(X, 8, seed=5, max_iter=0, tol=0.0, init_method=init,
                  mesh_shape={"data": ndata})[0]
        assert torch.equal(got, ref), (init, ndata)


def dyadic(X):
    """``X`` on a grid of 1/64: every float32 sum of a few thousand rows is
    exact, in any order."""
    return (np.round(X * 64) / 64).astype(np.float32)


@pytest.mark.parametrize("mesh", [{"data": 4}, {"data": 8}, {"data": 2, "model": 2}], ids=str)
def test_mesh_matches_reference_mesh_from_carried_init(mesh):
    """From the reference's D² init, the port's mesh and the reference's
    mesh take the same iterations to the same labels; on the dyadic grid
    the sums are exact on both sides, so centroids agree to the division's
    rounding."""
    X = dyadic(blobs(2, centers=8))
    init = np.asarray(kmeans_jax_full(X, 8, seed=2, max_iter=0, tol=0.0,
                                      dtype=np.float32)[0])
    init_t = params_from_reference(init, dataclasses.asdict(JScoringConfig()))["centroids"]
    want_c, want_l, want_it, _ = kmeans_jax_full(X, 8, seed=2, init_centroids=init,
                                                 mesh_shape=mesh, dtype=np.float32)
    c, lab, it, _ = run(X, 8, seed=2, init_centroids=init_t, mesh_shape=mesh)
    assert it == int(want_it)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), atol=1e-6)
    # The reference's own cold init is the same at any data = N, as the port's is.
    ref8 = kmeans_jax_full(X, 8, seed=2, max_iter=0, tol=0.0, dtype=np.float32,
                           mesh_shape={"data": 8})[0]
    np.testing.assert_array_equal(np.asarray(ref8), init)


@pytest.mark.parametrize("n", [10, 403, 1001])
def test_uneven_rows_pad_without_counting(n):
    """Rows that do not divide over the shards are padded with zeros that
    are never counted, summed or drawn (the padding is far from every
    point, so any counted pad row would move a centroid).  The points are
    multiples of 1/64, so every sum is exact and the meshes give the
    one-device bits."""
    X = dyadic(blobs(4, n=n)) + 10.0
    k = 3 if n < 100 else 6
    c1, l1, it1, _ = run(X, k, seed=1)
    for ndata in (3, 8):
        c, lab, it, _ = run(X, k, seed=1, mesh_shape={"data": ndata})
        assert it == it1 and torch.equal(lab, l1) and lab.shape == (n,)
        assert torch.equal(c, c1)
        assert float(c.min()) > 5.0


def test_reseeds_across_shards_are_exact():
    """Three distinct rows (exact halves) and k = 6: empty clusters every
    iteration, each reseeded from a global row that one shard owns.  Sums
    of halves are exact, so every mesh gives the one-device bits."""
    rows = np.asarray([[0.5, 1.0, 0.0, 2.0, 0.5], [1.5, 0.0, 1.0, 0.5, 0.0],
                       [0.0, 0.5, 1.5, 1.0, 1.0]], np.float32)
    X = rows[np.random.default_rng(0).integers(0, 3, 403)]
    c1, l1, it1, s1 = run(X, 6, seed=3, max_iter=12, tol=0.0)
    assert it1 == 12
    for mesh in MESHES:
        c, lab, it, s = run(X, 6, seed=3, max_iter=12, tol=0.0, mesh_shape=mesh)
        assert it == 12 and torch.equal(c, c1) and torch.equal(lab, l1) and s == s1, mesh


def test_tiny_shard_rules_follow_the_reference():
    """k-means|| needs ``per_round`` rows a shard: "auto" falls back to D²
    on a mesh whose shards are too small, an explicit "kmeans||" raises
    naming the shard rows (the reference's message)."""
    X = blobs(5, n=600)
    k = 256   # auto -> kmeans||, per-round ceil(2 * 256 / 5) = 103 > 600 / 8 = 75
    with pytest.raises(ValueError) as ref_err:
        kmeans_jax_full(X, k, seed=0, max_iter=0, init_method="kmeans||",
                        mesh_shape={"data": 8}, dtype=np.float32)
    with pytest.raises(ValueError) as got_err:
        run(X, k, seed=0, max_iter=0, init_method="kmeans||", mesh_shape={"data": 8})
    assert str(got_err.value) == str(ref_err.value)
    auto = run(X, k, seed=0, max_iter=0, tol=0.0, init_method="auto",
               mesh_shape={"data": 8})[0]
    d2 = run(X, k, seed=0, max_iter=0, tol=0.0, init_method="d2")[0]
    assert torch.equal(auto, d2)
    # One device has the rows: auto stays k-means|| there.
    par = run(X, k, seed=0, max_iter=0, tol=0.0, init_method="auto")[0]
    assert not torch.equal(par, d2)


def test_model_axis_must_divide_k():
    with pytest.raises(ValueError, match="divisible by the model axis size 3"):
        run(blobs(0, n=100), 8, mesh_shape={"data": 1, "model": 3})


def test_model_axis_does_not_launch_the_lloyd_step(monkeypatch):
    """On a model axis the distances are a matmul a model shard; the fused
    Lloyd step (``lloyd_assign_reduce``) is not called, as the reference
    refuses its fused kernel on a model-sharded mesh."""
    calls = []
    real = port_kmeans.lloyd_assign_reduce

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    # The one-device loop calls it from ops/kmeans, the shards through
    # ops/lloyd's sharded_assign_reduce.
    monkeypatch.setattr(port_kmeans, "lloyd_assign_reduce", counted)
    monkeypatch.setattr(port_lloyd, "lloyd_assign_reduce", counted)
    X = blobs(6, n=500)
    init = torch.from_numpy(X[:8].astype(np.float64))
    run(X, 8, init_centroids=init, mesh_shape={"data": 2, "model": 2})
    assert calls == []
    _, _, it, _ = run(X, 8, init_centroids=init, mesh_shape={"data": 2})
    assert len(calls) == 2 * (it + 1)


def test_checkpointed_resume_on_a_smaller_mesh(tmp_path):
    """The reference's elastic resume (tests/test_checkpoint.py): a run
    checkpointed at data = 8 resumes at data = 2 and continues the
    trajectory of an uninterrupted data = 2 run."""
    X = blobs(7, n=800)
    init = X[:4].astype(np.float64)
    p = str(tmp_path / "elastic.npz")
    kmeans_checkpointed(X, 4, p, seed=0, max_iter=4, block_iters=4, init_centroids=init,
                        tol=0.0, mesh_shape={"data": 8}, device="cpu")
    assert load_state(p)[1]["iters_done"] == 4
    c2, l2, it2 = kmeans_checkpointed(X, 4, p, seed=0, max_iter=30, block_iters=30,
                                      init_centroids=init, mesh_shape={"data": 2},
                                      device="cpu")
    pref = str(tmp_path / "ref.npz")
    c3, l3, it3 = kmeans_checkpointed(X, 4, pref, seed=0, max_iter=30, block_iters=4,
                                      init_centroids=init, mesh_shape={"data": 2},
                                      device="cpu")
    assert it2 == it3 >= 4
    assert float((c2 - c3).abs().max()) <= 1e-5
    assert float((l2 == l3).float().mean()) > 0.999
