"""The plain version of the port's fused Lloyd step against both TPU
kernels it replaces, run in interpret mode: the feature-major
``lloyd_assign_reduce_pallas_t`` (B1) and the row-major
``lloyd_assign_reduce_pallas`` (B3).

Labels are identical on the valid rows, and for B3 on every row (a label
that differs must sit on
a distance tie within 1e-6 relative, where XLA's and torch's dot products
may round apart); sums within atol 1e-3, the tolerance ``test_pallas.py``
uses for f32 sums taken in another order; counts exact.  The CUDA kernel
itself is held against this plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from cdrs_tpu.ops.pallas_kernels import (lloyd_assign_reduce_pallas,  # noqa: E402
                                         lloyd_assign_reduce_pallas_t)

from cdrs_tpu_torch.ops.lloyd import (centroid_operands, lloyd_assign_reduce,  # noqa: E402
                                      lloyd_assign_reduce_plain)


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def assert_labels_match(x, c_used, got, want, rtol=1e-6):
    """Identical labels, except where both picks are equally near."""
    diff = np.nonzero(got != want)[0]
    if diff.size:
        xd = x[diff].astype(np.float64)
        dg = ((xd - c_used[got[diff]]) ** 2).sum(1)
        dw = ((xd - c_used[want[diff]]) ** 2).sum(1)
        np.testing.assert_allclose(dg, dw, rtol=rtol)
    assert diff.size <= max(1, got.size // 1000)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k,n_valid", [
    (2048, 5, 7, 2048),      # pipeline width, k not lane-aligned
    (2048, 32, 128, 1999),   # rows past n_valid carry no weight
    (2048, 5, 64, 2001),     # entry()'s k at the pipeline's width
    (1024, 128, 1024, 1000),  # reference config 3's width
])
def test_plain_lloyd_matches_pallas_kernel(n, d, k, n_valid, dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[n_valid:] = 0.0                      # the TPU kernel's zero-pad contract
    c = x[:k].copy()
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    lab_j, sums_j, cnt_j = lloyd_assign_reduce_pallas_t(
        xj.T, jnp.asarray(c), n_valid=n_valid, interpret=True, tile_cols=1024)

    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    lab, sums, cnt = lloyd_assign_reduce_plain(xt, torch.from_numpy(c), n_valid)
    assert lab.dtype == torch.int32 and sums.dtype == torch.float32
    c_used = centroid_operands(torch.from_numpy(c), xt.dtype)[0].double().numpy()
    assert_labels_match(xt.float().numpy()[:n_valid], c_used,
                        lab.numpy()[:n_valid], np.asarray(lab_j)[:n_valid])
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), atol=1e-3)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k,n_valid", [
    (2048, 5, 8, 1999),      # the mini-batch and drift width
    (3072, 32, 128, 2051),   # a wider model, three row tiles
    (2048, 5, 64, 2001),     # entry()'s k at the pipeline's width
    (1024, 128, 1024, 1000),  # reference config 3's width
])
def test_plain_lloyd_matches_row_major_pallas_kernel(n, d, k, n_valid, dtype):
    """B3's contract: rows padded to the 1024-row tile, garbage (not zeros)
    past ``n_valid`` adding nothing, and a label for every row."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[n_valid:] = rng.uniform(5.0, 50.0, size=(n - n_valid, d))
    c = x[:k].copy()
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    lab_j, sums_j, cnt_j = lloyd_assign_reduce_pallas(
        xj, jnp.asarray(c), n_valid=n_valid, interpret=True, tile_rows=1024)

    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    lab, sums, cnt = lloyd_assign_reduce(xt, torch.from_numpy(c), n_valid, with_labels=True)
    assert lab.shape == (n,) and lab.dtype == torch.int32
    c_used = centroid_operands(torch.from_numpy(c), xt.dtype)[0].double().numpy()
    assert_labels_match(xt.float().numpy(), c_used, lab.numpy(), np.asarray(lab_j))
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), atol=1e-3)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    assert int(cnt.sum()) == n_valid


def test_rows_past_n_valid_never_count():
    """The port masks the tail itself: any values there leave sums and
    counts untouched (no zero-pad contract), and still get labels."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(600, 6)).astype(np.float32))
    c = x[:9].clone()
    dirty = x.clone()
    dirty[500:] = 99.0
    lab_a, sums_a, cnt_a = lloyd_assign_reduce_plain(x, c, 500)
    lab_b, sums_b, cnt_b = lloyd_assign_reduce_plain(dirty, c, 500)
    assert torch.equal(sums_a, sums_b) and torch.equal(cnt_a, cnt_b)
    assert torch.equal(lab_a[:500], lab_b[:500])
    assert int(cnt_a.sum()) == 500 and lab_b.shape == (600,)


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32))
    c = x[:4].clone()
    before = lloyd_assign_reduce.launches
    lab, sums, cnt = lloyd_assign_reduce(x, c, 290)
    lab_p, sums_p, cnt_p = lloyd_assign_reduce_plain(x, c, 290)
    assert lloyd_assign_reduce.launches == before
    assert torch.equal(lab, lab_p) and torch.equal(sums, sums_p) and torch.equal(cnt, cnt_p)
    none, sums_n, _ = lloyd_assign_reduce(x, c, 290, with_labels=False)
    assert none is None and torch.equal(sums_n, sums)


def test_first_minimum_wins_ties():
    x = torch.tensor([[0.5, 0.0], [2.0, 0.0]])
    c = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 0.0]])   # rows 1 and 2 tie
    lab, _, cnt = lloyd_assign_reduce_plain(x, c, 2)
    assert lab.tolist() == [0, 1] and cnt.tolist() == [1.0, 1.0, 0.0]


def test_bf16_points_round_the_centroids_and_keep_f32_stats():
    c = torch.tensor([[1.0 + 2 ** -10, 0.3]])
    used, csq = centroid_operands(c, torch.bfloat16)
    assert used.dtype == torch.float32
    assert torch.equal(used, c.to(torch.bfloat16).float())
    assert torch.equal(csq, (used * used).sum(1))


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros(10, 3)
    with pytest.raises(ValueError, match="n_valid"):
        lloyd_assign_reduce(x, torch.zeros(2, 3), 11)
    with pytest.raises(ValueError, match=r"\(k, d\)"):
        lloyd_assign_reduce(x, torch.zeros(2, 4), 10)
