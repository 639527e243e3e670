"""B2's general path (``ops/seg_count``: every call with d > 8 or k > 32)
against the JAX package on the CPU, and the plan that picks the kernel's
path and feature slices.

* At general-path shapes (d, k) = (5, 64), (37, 150), (128, 1024) and
  (300, 33), with labels uniform in [-1, k), skewed to one cluster, and
  reaching past k: the per-cluster table of the plain version equals
  ``label_segment_matmul`` in interpret mode on the 0/1 matrix
  ``_bisect_core`` builds, and the global table a numpy count over the
  rows with a label in [0, k).  Counts are integers: exact.
* ``bisect_medians`` at (128, 1024) equals the reference's
  ``_bisect_medians`` bit for bit.
* ``plan``: the small path exactly where d <= 8 and k <= 32; its slices
  cover [0, d) once; every block's shared memory fits ``SMEM_MAX``; every
  (d, k) inside the wrapper's limit gets a path; config 3's, the
  rehearsal's and ``entry()``'s shapes take the path they were designed
  for; the scratch a plan needs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from cdrs_tpu.ops.pallas_kernels import label_segment_matmul, seg_tile  # noqa: E402
from cdrs_tpu.ops.scoring_jax import _bisect_medians  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from cdrs_tpu_torch.ops.scoring import bisect_medians  # noqa: E402
from cdrs_tpu_torch.ops.seg_count import (  # noqa: E402
    SLICE_WIDTHS, SMEM_MAX, label_threshold_count, label_threshold_count_plain, plan,
    scratch_lengths, slices)

N = 4096
SHAPES = [(5, 64), (37, 150), (128, 1024), (300, 33)]
LABELS = ["uniform", "skewed", "past_k"]


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def inputs(d, k, kind, seed=0, n=N):
    """x in [0, 1); thresholds spread over the same range; labels uniform
    in [-1, k), or with 3/4 of the rows in cluster 2 (``skewed``), or
    uniform in [-1, k + 5) (``past_k``: no cluster for labels >= k)."""
    rng = np.random.default_rng(seed + 17 * d + k)
    x = rng.random((n, d)).astype(np.float32)
    if kind == "past_k":
        lab = rng.integers(-1, k + 5, n)
    else:
        lab = rng.integers(-1, k, n)
        if kind == "skewed":
            lab[rng.random(n) < 0.75] = min(2, k - 1)
    thr = rng.random((2, k, d)).astype(np.float32)
    gthr = rng.random((2, d)).astype(np.float32)
    return x, lab.astype(np.int32), thr, gthr


def plain(x, lab, thr, gthr):
    return label_threshold_count_plain(torch.from_numpy(x), torch.from_numpy(lab),
                                       torch.from_numpy(thr), torch.from_numpy(gthr))


@pytest.mark.parametrize("kind", LABELS)
@pytest.mark.parametrize("d, k", SHAPES)
def test_per_cluster_table_matches_label_segment_matmul(d, k, kind):
    x, lab, thr, gthr = inputs(d, k, kind)
    thr_cat = np.concatenate([thr[0], thr[1]], axis=1)
    y = np.concatenate([x, x], axis=1) <= thr_cat[np.clip(lab, 0, k - 1)]
    pad = (-N) % seg_tile(k)
    lab_p = np.concatenate([lab, np.full(pad, -1, np.int32)])
    y_p = np.concatenate([y, np.zeros((pad, 2 * d), bool)])
    want = label_segment_matmul(jnp.asarray(lab_p), jnp.asarray(y_p).astype(jnp.bfloat16),
                                k, interpret=True)
    counts, _ = plain(x, lab, thr, gthr)
    assert counts.dtype == torch.int32 and counts.shape == (k, 2 * d)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want).astype(np.int64))
    if kind == "skewed":
        assert counts[min(2, k - 1)].sum() > counts.sum() // 2


@pytest.mark.parametrize("kind", LABELS)
@pytest.mark.parametrize("d, k", SHAPES)
def test_global_table_matches_numpy(d, k, kind):
    x, lab, thr, gthr = inputs(d, k, kind, seed=1)
    ok = (lab >= 0) & (lab < k)
    want = np.stack([(x[ok] <= gthr[r]).sum(axis=0) for r in range(2)])
    counts, gcounts = plain(x, lab, thr, gthr)
    assert gcounts.dtype == torch.int32 and gcounts.shape == (2, d)
    np.testing.assert_array_equal(gcounts.numpy(), want)
    # The wrapper on the CPU is the plain version and launches nothing.
    before = label_threshold_count.launches
    c2, g2 = label_threshold_count(*(torch.from_numpy(a) for a in (x, lab, thr, gthr)))
    assert label_threshold_count.launches == before
    assert torch.equal(c2, counts) and torch.equal(g2, gcounts)


@pytest.mark.parametrize("with_global", [True, False])
def test_bisect_medians_equal_the_reference_at_config3_width(with_global):
    rng = np.random.default_rng(5)
    n, d, k = N, 128, 1024
    mu = rng.random((k, d))
    lab = rng.integers(0, k - 3, n).astype(np.int32)      # the last 3 clusters empty
    x = np.clip(mu[lab] + 0.1 * rng.normal(size=(n, d)), 0.0, 1.0).astype(np.float32)
    x[:, 7] = 0.25                                         # a constant column
    m_j, g_j = _bisect_medians(jnp.asarray(x), jnp.asarray(lab), k, 2048, with_global)
    m, g = bisect_medians(torch.from_numpy(x), torch.from_numpy(lab), k, 2048, with_global)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    held = torch.from_numpy(np.bincount(lab, minlength=k) > 0)
    assert not bool(held[k - 3:].any()) and bool(torch.isnan(m[~held]).all())
    assert bool((m[held, 7] == 0.25).all())
    if with_global:
        np.testing.assert_array_equal(g.numpy(), np.asarray(g_j))
    else:
        assert g is None


def check_plan(d, k, itemsize):
    p = plan(d, k, itemsize)
    assert p.path in ("small", "rows", "pairs", "global")
    assert (p.path == "small") == (d <= 8 and k <= 32)
    cover = slices(d, p)
    assert len(cover) == p.nslices
    assert cover[0][0] == 0 and cover[-1][1] == d
    assert all(a < b <= a + p.slice for a, b in cover)
    assert all(b == a2 for (_, b), (a2, _) in zip(cover, cover[1:]))
    assert p.smem <= SMEM_MAX
    if p.path == "rows":
        assert d <= 8 and p.slice == d and p.nslices == 1
    if p.path == "pairs":
        assert p.slice in SLICE_WIDTHS and p.slice <= d
    return p


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d", [1, 2, 5, 8, 9, 16, 37, 128, 300, 1000])
def test_plan_slices_cover_the_features_once_and_fit(d, itemsize):
    for k in (1, 8, 32, 33, 64, 150, 1024, 1100, 3000, 9000, 12_000, 100_000):
        if 2 * (k + 1) * d < 2**31:
            check_plan(d, k, itemsize)


@settings(max_examples=300, deadline=None)
@given(d=st.integers(1, 1 << 16), k=st.integers(1, 1 << 22), itemsize=st.sampled_from([4, 2]))
def test_plan_gives_every_shape_inside_the_wrappers_limit_a_path(d, k, itemsize):
    hypothesis.assume(2 * (k + 1) * d < 2**31)
    p = check_plan(d, k, itemsize)
    # The widest slice that fits is taken: one width up would not fit.
    if p.path == "pairs" and p.slice < min(8, d):
        wider = plan.__globals__["_smem"]("pairs", 2 * p.slice, k, itemsize)
        assert wider > SMEM_MAX


@pytest.mark.parametrize("d, k, itemsize, want", [
    (5, 8, 4, ("small", 5, 1)),          # the main path
    (5, 1, 4, ("small", 5, 1)),
    (5, 64, 4, ("rows", 5, 1)),          # entry()'s k at the main path's width
    (128, 1024, 4, ("pairs", 8, 16)),    # config 3 (and its 1M-row cut)
    (128, 1024, 2, ("pairs", 8, 16)),    # the config-4 rehearsal's bf16 rows
    (37, 150, 2, ("pairs", 8, 5)),
    (300, 33, 4, ("pairs", 8, 38)),
    (5, 3000, 4, ("pairs", 2, 3)),
    (16, 20_000, 4, ("global", 8, 2)),
])
def test_plan_takes_the_designed_path(d, k, itemsize, want):
    p = check_plan(d, k, itemsize)
    assert (p.path, p.slice, p.nslices) == want


def test_scratch_lengths_per_path():
    small = plan(5, 8)
    assert scratch_lengths(small, 264, 5, 8) == (264 * (2 * 8 * 5 + 10), 1)
    wide = plan(128, 1024)
    assert scratch_lengths(wide, wide.nslices, 128, 1024) == (2 * 1024 * 128 + 256, 16)
