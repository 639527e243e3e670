"""The port's classification (``ops/scoring.classify``) against
``classify_jax``, and the plain threshold-count version against the TPU
kernel ``label_segment_matmul`` (interpret mode) on the 0/1 matrix its
caller builds.

Winners identical; sort medians exact; hist and bisect medians and the
scores within 1e-6 (the same f32 arithmetic, reductions in another order).
Counts are integers, so the counting step is exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.ops.pallas_kernels import label_segment_matmul, seg_tile  # noqa: E402
from cdrs_tpu.ops.scoring_jax import classify_jax  # noqa: E402

from cdrs_tpu_torch.config import scoring_config_from_dict  # noqa: E402
from cdrs_tpu_torch.ops.scoring import (classify, cluster_medians_sort,  # noqa: E402
                                        global_medians_sort, pick_winner,
                                        resolve_median_method)
from cdrs_tpu_torch.ops.seg_count import (label_threshold_count,  # noqa: E402
                                          label_threshold_count_plain)


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def clustered(seed, n=3000, d=5, k=8):
    """Features in [0, 1] grouped around k centres; cluster k-1 is empty and
    column 1 is constant (both take their special paths)."""
    rng = np.random.default_rng(seed)
    mu = rng.random((k, d))
    lab = rng.integers(0, k - 1, n).astype(np.int32)
    x = np.clip(mu[lab] + 0.12 * rng.normal(size=(n, d)), 0.0, 1.0).astype(np.float32)
    x[:, 1] = 0.25
    return x, lab


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_threshold_count_matches_label_segment_matmul(seed):
    rng = np.random.default_rng(seed)
    n, d, k = 3000, 5, 8
    x = rng.random((n, d)).astype(np.float32)
    lab = rng.integers(-1, k, n).astype(np.int32)
    thr = rng.random((2, k, d)).astype(np.float32)
    # y as _bisect_core builds it: per-row thresholds of both ranks, bf16 0/1.
    thr_cat = np.concatenate([thr[0], thr[1]], axis=1)
    y = (np.concatenate([x, x], axis=1) <= thr_cat[np.clip(lab, 0, k - 1)])
    tile = seg_tile(k)
    pad = (-n) % tile
    lab_p = np.concatenate([lab, np.full(pad, -1, np.int32)])
    y_p = np.concatenate([y, np.zeros((pad, 2 * d), bool)])
    want = label_segment_matmul(jnp.asarray(lab_p), jnp.asarray(y_p).astype(jnp.bfloat16),
                                k, interpret=True)
    got = label_threshold_count_plain(torch.from_numpy(x), torch.from_numpy(lab),
                                      torch.from_numpy(thr))
    assert got.dtype == torch.int32 and got.shape == (k, 2 * d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    before = label_threshold_count.launches
    same = label_threshold_count(torch.from_numpy(x), torch.from_numpy(lab),
                                 torch.from_numpy(thr))
    assert torch.equal(same, got) and label_threshold_count.launches == before


@pytest.mark.parametrize("from_data", [False, True])
@pytest.mark.parametrize("tables", ["default", "validated"])
@pytest.mark.parametrize("method", ["sort", "hist", "bisect"])
def test_classify_matches_reference(method, tables, from_data):
    x, lab = clustered(["sort", "hist", "bisect"].index(method) + 3 * from_data)
    k = 8
    base = jcfg.ScoringConfig() if tables == "default" else jcfg.validated_scoring_config()
    ref_cfg = dataclasses.replace(base, median_method=method,
                                  compute_global_medians_from_data=from_data)
    cfg = scoring_config_from_dict(dataclasses.asdict(ref_cfg))
    w_j, s_j, m_j = classify_jax(jnp.asarray(x), jnp.asarray(lab), k, ref_cfg)
    w, s, m = classify(torch.from_numpy(x), torch.from_numpy(lab), k, cfg)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    m_j = np.asarray(m_j)
    # The empty cluster's medians are NaN (the hist path keeps a constant
    # column's value there, as the reference does).
    np.testing.assert_array_equal(np.isnan(m.numpy()), np.isnan(m_j))
    assert np.isnan(m.numpy()[k - 1, 0])
    if method == "sort":
        np.testing.assert_array_equal(m.numpy(), m_j)
    else:
        np.testing.assert_allclose(m.numpy(), m_j, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-6)


def test_sort_medians_average_the_middle_pair():
    """jnp.median's midpoint rule, not torch.median's lower middle."""
    x = torch.tensor([[0.0, 5.0], [1.0, 4.0], [2.0, 3.0], [10.0, 7.0], [3.0, 3.0]])
    lab = torch.tensor([0, 0, 0, 0, 1], dtype=torch.int32)
    assert global_medians_sort(x).tolist() == [2.0, 4.0]
    assert cluster_medians_sort(x, lab, 2).tolist() == [[1.5, 4.5], [3.0, 3.0]]


def test_ties_go_to_the_largest_replication_factor():
    scores = torch.zeros(2, 4)
    scores[1, 0] = scores[1, 1] = 1.0
    rf = torch.tensor([3.0, 2.0, 1.0, 4.0])
    assert pick_winner(scores, rf).tolist() == [3, 0]


def test_median_method_resolution():
    assert resolve_median_method("auto", 2_000_000, "cpu") == "sort"
    assert resolve_median_method("auto", 2_000_001, "cpu") == "hist"
    assert resolve_median_method("auto", 2_000_001, "cuda") == "bisect"
    assert resolve_median_method("hist", 10, "cuda") == "hist"
    with pytest.raises(ValueError):
        resolve_median_method("mean", 10, "cpu")
