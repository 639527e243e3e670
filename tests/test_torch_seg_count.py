"""The fused threshold count (``ops/seg_count.label_threshold_count`` with
both tables) and the one-pass bisection built on it, against the JAX
package on the CPU.

* The per-cluster table equals ``label_segment_matmul`` in interpret mode
  on the 0/1 matrix ``_bisect_core`` builds; the global table equals a
  numpy count over the rows with a label in [0, k).  Counts are integers,
  so both are exact.
* ``bisect_medians`` makes one counting call per iteration, with or
  without the global medians, and its medians equal the reference's
  ``_bisect_medians`` bit for bit (the same f32 thresholds, exact counts).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from cdrs_tpu.ops.pallas_kernels import label_segment_matmul, seg_tile  # noqa: E402
from cdrs_tpu.ops.scoring_jax import _bisect_medians  # noqa: E402

from cdrs_tpu_torch.ops import seg_count  # noqa: E402
from cdrs_tpu_torch.ops.scoring import bisect_medians  # noqa: E402
from cdrs_tpu_torch.ops.seg_count import (label_threshold_count,  # noqa: E402
                                          label_threshold_count_plain)


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def inputs(seed, n=2500, d=5, k=8, lab_hi=None):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    lab = rng.integers(-1, k if lab_hi is None else lab_hi, n).astype(np.int32)
    thr = rng.random((2, k, d)).astype(np.float32)
    gthr = rng.random((2, d)).astype(np.float32)
    return x, lab, thr, gthr


def fused(x, lab, thr, gthr):
    return label_threshold_count_plain(torch.from_numpy(x), torch.from_numpy(lab),
                                       torch.from_numpy(thr), torch.from_numpy(gthr))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_per_cluster_table_matches_label_segment_matmul(seed):
    x, lab, thr, gthr = inputs(seed)
    n, d = x.shape
    k = thr.shape[1]
    thr_cat = np.concatenate([thr[0], thr[1]], axis=1)
    y = np.concatenate([x, x], axis=1) <= thr_cat[np.clip(lab, 0, k - 1)]
    pad = (-n) % seg_tile(k)
    lab_p = np.concatenate([lab, np.full(pad, -1, np.int32)])
    y_p = np.concatenate([y, np.zeros((pad, 2 * d), bool)])
    want = label_segment_matmul(jnp.asarray(lab_p), jnp.asarray(y_p).astype(jnp.bfloat16),
                                k, interpret=True)
    counts, _ = fused(x, lab, thr, gthr)
    assert counts.dtype == torch.int32 and counts.shape == (k, 2 * d)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("lab_hi", [None, 11])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_global_table_matches_numpy(seed, lab_hi):
    """Labels in [-1, k), and also past k: only [0, k) count globally."""
    x, lab, thr, gthr = inputs(seed, lab_hi=lab_hi)
    k = thr.shape[1]
    ok = (lab >= 0) & (lab < k)
    want = np.stack([(x[ok] <= gthr[r]).sum(axis=0) for r in range(2)])
    _, gcounts = fused(x, lab, thr, gthr)
    assert gcounts.dtype == torch.int32 and gcounts.shape == (2, x.shape[1])
    np.testing.assert_array_equal(gcounts.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wrapper_on_cpu_is_the_plain_version_in_both_forms(seed):
    x, lab, thr, gthr = inputs(seed, n=700, d=3, k=4)
    args = (torch.from_numpy(x), torch.from_numpy(lab), torch.from_numpy(thr))
    before = label_threshold_count.launches
    c1, g1 = label_threshold_count(*args, torch.from_numpy(gthr))
    c2, g2 = label_threshold_count_plain(*args, torch.from_numpy(gthr))
    alone = label_threshold_count(*args)
    assert label_threshold_count.launches == before
    assert torch.equal(c1, c2) and torch.equal(g1, g2) and torch.equal(alone, c1)
    # The k = 1 form the earlier global count used still works.
    one = label_threshold_count(args[0], torch.where(args[1] >= 0, 0, -1).to(torch.int32),
                                torch.from_numpy(gthr)[:, None, :].contiguous())
    ok = lab >= 0
    np.testing.assert_array_equal(one.numpy().reshape(2, -1),
                                  np.stack([(x[ok] <= gthr[r]).sum(0) for r in range(2)]))


def test_fused_count_rejects_a_global_table_of_the_wrong_shape():
    x, lab, thr, gthr = inputs(0, n=50)
    with pytest.raises(ValueError, match="gthr"):
        label_threshold_count(torch.from_numpy(x), torch.from_numpy(lab),
                              torch.from_numpy(thr), torch.from_numpy(gthr[:, :2]))


@pytest.mark.parametrize("with_global", [True, False])
@pytest.mark.parametrize("bins", [64, 2048])
def test_bisect_makes_one_counting_call_per_iteration(monkeypatch, bins, with_global):
    calls = []
    plain = seg_count.label_threshold_count_plain

    def counted(x, labels, thr, gthr=None):
        calls.append(gthr is not None)
        return plain(x, labels, thr, gthr)

    monkeypatch.setattr(seg_count, "label_threshold_count_plain", counted)
    x, lab, _, _ = inputs(3, n=900)
    bisect_medians(torch.from_numpy(x), torch.from_numpy(np.maximum(lab, 0)), 8, bins,
                   with_global)
    iters = max(8, int(np.ceil(np.log2(bins))) + 1)
    assert len(calls) == iters
    assert set(calls) == {with_global}


@pytest.mark.parametrize("with_global", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bisect_medians_equal_the_reference(seed, with_global):
    rng = np.random.default_rng(seed)
    n, d, k = 3000, 5, 8
    mu = rng.random((k, d))
    lab = rng.integers(0, k - 1, n).astype(np.int32)   # cluster k-1 empty
    x = np.clip(mu[lab] + 0.1 * rng.normal(size=(n, d)), 0.0, 1.0).astype(np.float32)
    x[:, 2] = 0.5                                         # a constant column
    m_j, g_j = _bisect_medians(jnp.asarray(x), jnp.asarray(lab), k, 2048, with_global)
    m, g = bisect_medians(torch.from_numpy(x), torch.from_numpy(lab), k, 2048, with_global)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    if with_global:
        np.testing.assert_array_equal(g.numpy(), np.asarray(g_j))
    else:
        assert g is None
