"""The port's sharded medians (``classify(mesh_shape=)``, ``hist_medians`` and
``bisect_medians`` with a mesh) against one device and against
``classify_jax(mesh_shape=)`` on the reference's 8 virtual CPU devices.

Both sharded methods add integer histograms or counts, so they equal the
one-device result bit for bit (atol = 0, as the reference holds its own
sharded bisection, ``tests/test_scoring_bisect.py``).  The exact sort is
one-device only and is refused on a mesh with the reference's message.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.ops.scoring_jax import classify_jax  # noqa: E402

from cdrs_tpu_torch.config import ScoringConfig, validated_scoring_config  # noqa: E402
from cdrs_tpu_torch.ops.scoring import bisect_medians, classify, hist_medians  # noqa: E402
from cdrs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


def table(seed, n=1001, d=5, k=8, empty=None):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    x[:, 2] = 0.25                                  # a constant column
    lab = rng.integers(0, k, n).astype(np.int32)
    if empty is not None:
        lab[lab == empty] = (empty + 1) % k          # an empty cluster
    return torch.from_numpy(x), torch.from_numpy(lab)


def same(a, b):
    return torch.equal(torch.nan_to_num(a, nan=-7.0), torch.nan_to_num(b, nan=-7.0))


@pytest.mark.parametrize("fn", [hist_medians, bisect_medians], ids=["hist", "bisect"])
@pytest.mark.parametrize("ndata", [2, 4, 8])
@pytest.mark.parametrize("seed,n", [(0, 1001), (1, 64), (2, 7)])
def test_sharded_medians_are_bit_identical(fn, ndata, seed, n):
    x, lab = table(seed, n=n, empty=3)
    want = fn(x, lab, 8, 2048, True)
    got = fn(x, lab, 8, 2048, True, make_mesh(ndata, device="cpu"))
    assert same(got[0], want[0]) and same(got[1], want[1])
    got_ng = fn(x, lab, 8, 2048, False, make_mesh(ndata, device="cpu"))
    assert same(got_ng[0], want[0]) and got_ng[1] is None


@pytest.mark.parametrize("method", ["hist", "bisect", "auto"])
@pytest.mark.parametrize("mesh", [{"data": 2}, {"data": 8}, {"data": 4, "model": 2}], ids=str)
def test_classify_on_a_mesh_equals_one_device(method, mesh):
    x, lab = table(4)
    cfg = dataclasses.replace(validated_scoring_config(), median_method=method,
                              compute_global_medians_from_data=True)
    one = dataclasses.replace(cfg, median_method="hist" if method == "auto" else method)
    want = classify(x, lab, 8, one)
    got = classify(x, lab, 8, cfg, mesh_shape=mesh)
    for g, w in zip(got, want):
        assert same(g, w)


@pytest.mark.parametrize("method", ["hist", "bisect"])
def test_classify_matches_reference_mesh(method):
    """Against ``classify_jax`` on a data = 8 mesh, float64 as the
    reference runs with x64: categories exact, medians within the
    method's resolution."""
    x, lab = table(5, n=803)
    x = x.double()
    cfg = dataclasses.replace(ScoringConfig(), median_method=method,
                              compute_global_medians_from_data=True)
    jc = dataclasses.replace(jcfg.ScoringConfig(), median_method=method,
                             compute_global_medians_from_data=True)
    want = classify_jax(x.numpy(), lab.numpy(), 8, jc, mesh_shape={"data": 8})
    got = classify(x, lab, 8, cfg, mesh_shape={"data": 8})
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-9)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-9)


def test_sort_is_refused_on_a_mesh_with_the_reference_message():
    x, lab = table(6)
    cfg = dataclasses.replace(ScoringConfig(), median_method="sort")
    jc = dataclasses.replace(jcfg.ScoringConfig(), median_method="sort")
    with pytest.raises(ValueError) as ref_err:
        classify_jax(x.numpy(), lab.numpy(), 8, jc, mesh_shape={"data": 2})
    with pytest.raises(ValueError) as got_err:
        classify(x, lab, 8, cfg, mesh_shape={"data": 2})
    assert str(got_err.value) == str(ref_err.value)
    # data = 1 (a model axis alone) keeps the exact sort.
    classify(x, lab, 8, cfg, mesh_shape={"data": 1, "model": 2})


def test_bisect_launches_once_a_shard_an_iteration(monkeypatch):
    import cdrs_tpu_torch.ops.scoring as scoring

    calls = []
    real = scoring.label_threshold_count

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(scoring, "label_threshold_count", counted)
    x, lab = table(7, n=1000)
    bisect_medians(x, lab, 8, 2048, True, make_mesh(4, device="cpu"))
    assert len(calls) == 4 * 12 and set(calls) == {250}
