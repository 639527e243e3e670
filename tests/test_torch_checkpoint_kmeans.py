"""The Lloyd loop in durable blocks: ``cdrs_tpu_torch.utils.checkpoint.
kmeans_checkpointed``, the counterpart of ``kmeans_jax_checkpointed``.

The counterparts of ``tests/test_checkpoint.py``'s blocked-Lloyd tests, on
the CPU: blocked, killed-and-resumed and uninterrupted runs give the same
bits (centroids, labels, iterations), reseeds included; a complete
checkpoint returns without running; a ``k`` mismatch and an old
checkpoint under ``labels="parity"`` raise.  Then the port against
``kmeans_jax_checkpointed`` from the same init: centroids within 1e-5,
labels and iterations exact.  The reference's two mesh cases (an elastic
resume on a smaller mesh, and a stream fold resumed across meshes) wait for
the port's multi-GPU mesh, ROADMAP A9; ``mesh_shape`` is refused by name.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.ops.kmeans_np import kmeans_plusplus_init  # noqa: E402
from cdrs_tpu.utils.checkpoint import kmeans_jax_checkpointed  # noqa: E402

import cdrs_tpu_torch.utils.checkpoint as ckpt  # noqa: E402
from cdrs_tpu_torch.ops.kmeans import kmeans_full  # noqa: E402
from cdrs_tpu_torch.utils.checkpoint import kmeans_checkpointed, load_state  # noqa: E402


@pytest.fixture()
def blobs():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(4, 6)) * 4.0
    return np.concatenate([rng.normal(size=(200, 6)) * 0.5 + c for c in centers])


def _equal(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    assert a[2] == b[2]


class Killed(RuntimeError):
    pass


def _kill_after(monkeypatch, blocks: int):
    """``save_state`` raises once it has written ``blocks`` snapshots, as a
    process killed right after a block's snapshot would stop."""
    save, written = ckpt.save_state, []

    def dying(path, arrays, meta=None):
        out = save(path, arrays, meta)
        written.append(meta["iters_done"])
        if len(written) == blocks:
            raise Killed(f"killed after block {blocks}")
        return out

    monkeypatch.setattr(ckpt, "save_state", dying)
    return lambda: monkeypatch.setattr(ckpt, "save_state", save)


def test_checkpointed_matches_uninterrupted(blobs, tmp_path):
    init = kmeans_plusplus_init(blobs, 4, random_state=0)
    one = kmeans_checkpointed(blobs, 4, str(tmp_path / "a.npz"), seed=0, max_iter=100,
                              block_iters=100, init_centroids=init, device="cpu")
    blocked = kmeans_checkpointed(blobs, 4, str(tmp_path / "b.npz"), seed=0, max_iter=100,
                                  block_iters=3, init_centroids=init, device="cpu")
    _equal(one, blocked)
    c, _, it, _ = kmeans_full(blobs, 4, seed=0, max_iter=100, init_centroids=init,
                              device="cpu")
    assert torch.equal(blocked[0], c) and blocked[2] == it
    assert blocked[0].dtype == torch.float64 and blocked[1].dtype == torch.int32


@pytest.mark.parametrize("labels", ["final", "parity"])
def test_resume_after_kill(blobs, tmp_path, monkeypatch, labels):
    """A run killed after its second block's snapshot resumes to the
    uninterrupted run's bits."""
    init = kmeans_plusplus_init(blobs, 4, random_state=0)
    kw = dict(seed=0, max_iter=30, block_iters=2, init_centroids=init, tol=0.0,
              labels=labels, device="cpu")
    p = str(tmp_path / "c.npz")
    restore = _kill_after(monkeypatch, 2)
    with pytest.raises(Killed):
        kmeans_checkpointed(blobs, 4, p, **kw)
    restore()
    assert load_state(p)[1]["iters_done"] == 4
    resumed = kmeans_checkpointed(blobs, 4, p, **kw)
    want = kmeans_checkpointed(blobs, 4, str(tmp_path / "d.npz"), **{**kw, "block_iters": 30})
    _equal(resumed, want)
    assert resumed[2] == 30
    if labels == "parity":
        c, lab, it, _ = kmeans_full(blobs, 4, seed=0, max_iter=30, init_centroids=init,
                                    tol=0.0, device="cpu")
        _equal(resumed, (c, lab, it))


def test_resume_from_complete_checkpoint(blobs, tmp_path):
    p = str(tmp_path / "e.npz")
    first = kmeans_checkpointed(blobs, 4, p, seed=0, max_iter=50, device="cpu")
    again = kmeans_checkpointed(blobs, 4, p, seed=0, max_iter=first[2], device="cpu")
    _equal(first, again)
    assert load_state(p)[1]["converged"]


def test_k_mismatch_rejected(blobs, tmp_path):
    p = str(tmp_path / "f.npz")
    kmeans_checkpointed(blobs, 4, p, seed=0, max_iter=2, block_iters=2, tol=0.0,
                        device="cpu")
    with pytest.raises(ValueError, match="checkpoint k="):
        kmeans_checkpointed(blobs, 8, p, seed=0, max_iter=4, device="cpu")


def test_blocked_equivalence_with_reseeds(tmp_path):
    """Reseed rows are keyed by the global iteration, so blocked and
    uninterrupted runs match even when empty-cluster reseeds fire."""
    X = np.array([[0.0, 0], [10, 0], [0, 10], [10, 10], [5, 5]])
    init = np.full((4, 2), 100.0) + np.arange(4)[:, None]   # forces reseeds
    kw = dict(seed=9, max_iter=40, init_centroids=init, tol=1e-4, device="cpu")
    one = kmeans_checkpointed(X, 4, str(tmp_path / "r1.npz"), block_iters=40, **kw)
    blocked = kmeans_checkpointed(X, 4, str(tmp_path / "r2.npz"), block_iters=1, **kw)
    _equal(one, blocked)
    # The first iteration empties every cluster but one: the init is gone.
    assert not torch.equal(blocked[0], torch.as_tensor(init))


def test_parity_labels_match_uninterrupted(tmp_path):
    rng = np.random.default_rng(19)
    X = rng.normal(size=(640, 6)).astype(np.float32)
    ck = str(tmp_path / "parity.npz")
    want_c, want_l, want_it, _ = kmeans_full(X, 5, tol=1e-4, seed=3, max_iter=40,
                                             device="cpu")
    got = kmeans_checkpointed(X, 5, ck, tol=1e-4, seed=3, max_iter=40, block_iters=7,
                              labels="parity", device="cpu")
    _equal(got, (want_c, want_l, want_it))
    again = kmeans_checkpointed(X, 5, ck, tol=1e-4, seed=3, max_iter=40, block_iters=7,
                                labels="parity", device="cpu")
    _equal(again, got)


def test_parity_labels_old_checkpoint_raises(tmp_path):
    X = np.random.default_rng(20).normal(size=(128, 4)).astype(np.float32)
    ck = str(tmp_path / "old.npz")
    kmeans_checkpointed(X, 3, ck, tol=1e-4, seed=0, max_iter=10, block_iters=5, device="cpu")
    with pytest.raises(ValueError, match="parity"):
        kmeans_checkpointed(X, 3, ck, tol=1e-4, seed=0, max_iter=10, block_iters=5,
                            labels="parity", device="cpu")


def test_mesh_shape_is_refused_naming_a9(blobs, tmp_path):
    """Named for the refusal it held until the mesh (ROADMAP A9) landed:
    ``mesh_shape`` now runs every block on a mesh, snapshots as before, and
    gives the one-device run's iterations and labels (centroids within
    1e-5: float32 sums added in another order)."""
    path = str(tmp_path / "m.npz")
    c, lab, it = kmeans_checkpointed(blobs, 4, path, mesh_shape={"data": 2}, seed=0,
                                     max_iter=20, block_iters=5, device="cpu")
    assert (tmp_path / "m.npz").exists()
    c1, l1, it1 = kmeans_checkpointed(blobs, 4, str(tmp_path / "one.npz"), seed=0,
                                      max_iter=20, block_iters=5, device="cpu")
    assert it == it1 and torch.equal(lab, l1)
    assert float((c - c1).abs().max()) <= 1e-5


@pytest.mark.parametrize("labels", ["final", "parity"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matches_the_reference_from_one_init(blobs, tmp_path, labels, dtype):
    X = blobs.astype(dtype)
    init = kmeans_plusplus_init(blobs, 4, random_state=1).astype(dtype)
    kw = dict(seed=1, max_iter=40, block_iters=3, init_centroids=init, labels=labels)
    got = kmeans_checkpointed(X, 4, str(tmp_path / "port.npz"), device="cpu", **kw)
    want = kmeans_jax_checkpointed(X, 4, str(tmp_path / "ref.npz"), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == want[2]
    # The snapshots carry the same state: either package reads the other's.
    _, meta = load_state(str(tmp_path / "ref.npz"))
    assert {k: v for k, v in load_state(str(tmp_path / "port.npz"))[1].items()
            if k != "shift"} == {k: v for k, v in meta.items() if k != "shift"}
