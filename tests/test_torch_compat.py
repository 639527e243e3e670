"""The reference user's API on the port (``cdrs_tpu_torch.compat.
reference_api``) against ``cdrs_tpu.compat.reference_api``, on the CPU.

``ClusterClassifier`` on the reference's inline example (its only
executable check of the scoring math) gives the same categories and
per-category scores; ``kmeans`` with the reference's signature, from a
carried init, gives centroids within 1e-5 and the same labels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.compat import reference_api as ref  # noqa: E402
from test_scoring import (INLINE_CLUSTERS, INLINE_DIRECTIONS,  # noqa: E402
                          INLINE_GLOBAL_MEDIANS, INLINE_RF, INLINE_WEIGHTS)

from cdrs_tpu_torch.compat import reference_api as port  # noqa: E402

INLINE = (INLINE_GLOBAL_MEDIANS, INLINE_WEIGHTS, INLINE_DIRECTIONS, INLINE_RF)


def test_classifier_on_the_reference_inline_example():
    got = port.ClusterClassifier(*INLINE, device="cpu").classify(INLINE_CLUSTERS)
    want = ref.ClusterClassifier(*INLINE).classify(INLINE_CLUSTERS)
    assert got == want == {"C1": "Hot", "C2": "Archival", "C3": "Archival", "C4": "Hot"}


def test_classifier_methods_match_the_reference():
    got, want = port.ClusterClassifier(*INLINE, device="cpu"), ref.ClusterClassifier(*INLINE)
    medians = got.compute_cluster_medians(INLINE_CLUSTERS)
    assert medians == want.compute_cluster_medians(INLINE_CLUSTERS)
    for m in medians.values():
        for cat in INLINE_WEIGHTS:
            assert got.score_category(m, cat) == want.score_category(m, cat)
        assert got.classify_cluster(m) == want.classify_cluster(m)
    assert got.f(3.0) == want.f(3.0)


def test_classifier_ties_go_to_the_largest_rf():
    """Medians equal to the global ones: no directional evidence, so
    Moderate's in-band reward wins; NaN medians score 0 everywhere and the
    tie goes to Archival's rf 4, as in the reference."""
    for m in ({"IOPS": 60.0, "Latency": 4.0}, {"IOPS": float("nan"), "Latency": float("nan")}):
        got = port.ClusterClassifier(*INLINE, device="cpu").classify_cluster(m)
        assert got == ref.ClusterClassifier(*INLINE).classify_cluster(m)


def test_classifier_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.ClusterClassifier(*INLINE)


@pytest.mark.parametrize("k,seed", [(3, 0), (5, 1)])
def test_kmeans_with_the_reference_signature(k, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, 4)) * 3.0
    X = np.concatenate([rng.normal(size=(150, 4)) * 0.4 + c for c in centers])
    init = ref.kmeans(X, k, random_state=seed, max_iter=0)[0]   # the reference's D² init
    want_c, want_l = ref.kmeans(X, k, number_of_files=len(X), random_state=seed,
                                init_centroids=init)
    got_c, got_l = port.kmeans(X, k, number_of_files=len(X), random_state=seed,
                               init_centroids=init, device="cpu")
    assert isinstance(got_c, np.ndarray) and got_c.shape == (k, 4)
    np.testing.assert_allclose(got_c, want_c, atol=1e-5)
    np.testing.assert_array_equal(got_l, want_l)
