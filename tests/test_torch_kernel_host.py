"""Host side of the port's kernels, which runs without a card: the
up-front reseed draws of the Lloyd loop, the loop against
``kmeans_jax_full`` from a carried init, the kernels' scratch cache, the
allocation without deterministic mode's NaN fill, and the build hash that
covers the shared CUDA headers.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.config import ScoringConfig as JScoringConfig  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402

from cdrs_tpu_torch.convert import params_from_reference  # noqa: E402
from cdrs_tpu_torch.device import deterministic, unfilled  # noqa: E402
from cdrs_tpu_torch.ops import _build  # noqa: E402
from cdrs_tpu_torch.ops.kmeans import (_reseed_rows, _reseed_table,  # noqa: E402
                                       kmeans_full)


@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_upfront_reseed_draws_equal_the_per_iteration_draws(seed, offset):
    table = _reseed_table(seed, offset, 12, 6, 1000)
    assert table.shape == (12, 6)
    for it in range(12):
        assert torch.equal(table[it], _reseed_rows(seed, offset + it, 6, 1000))
    assert _reseed_table(seed, offset, 0, 6, 1000).shape == (0, 6)


def test_reseed_blocks_continue_across_the_block_edge():
    """An empty cluster late in a long run takes its own iteration's draw,
    whichever block of draws that iteration falls in."""
    from cdrs_tpu_torch.ops import kmeans as km

    rng = np.random.default_rng(6)
    X = rng.random((300, 2)).astype(np.float32)
    init = X[:3].copy()
    init[1] = 1e3
    got = kmeans_full(torch.from_numpy(X), 3, seed=2, tol=0.0, max_iter=1,
                      init_centroids=init, iter_offset=km._RESEED_BLOCK + 5)[0]
    row = int(_reseed_rows(2, km._RESEED_BLOCK + 5, 3, 300)[1])
    np.testing.assert_array_equal(got[1].numpy(), X[row])


def test_an_empty_cluster_takes_its_iterations_upfront_row():
    rng = np.random.default_rng(4)
    X = rng.random((600, 3)).astype(np.float32)
    init = X[:4].copy()
    init[2] = 1e3                               # owns no point at iteration 0
    c, _, it, _ = kmeans_full(torch.from_numpy(X), 4, seed=5, tol=0.0, max_iter=1,
                              init_centroids=init, iter_offset=3, device="cpu")
    row = int(_reseed_table(5, 3, 1, 4, 600)[0, 2])
    assert it == 1
    np.testing.assert_array_equal(c[2].numpy(), X[row])


@pytest.mark.parametrize("n_valid_cut", [0, 37])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loop_labels_and_iterations_equal_the_reference(seed, n_valid_cut):
    rng = np.random.default_rng(seed + 20)
    mu = rng.random((6, 4))
    X = (mu[rng.integers(0, 6, 1500)] + 0.07 * rng.normal(size=(1500, 4))).astype(np.float32)
    n_valid = len(X) - n_valid_cut
    k = 6
    init = np.asarray(kmeans_jax_full(X[:n_valid], k, seed=seed, max_iter=0, tol=0.0,
                                      dtype=np.float32)[0])
    state = params_from_reference(init, dataclasses.asdict(JScoringConfig()))
    _, lab_j, it_j, _ = kmeans_jax_full(X[:n_valid], k, seed=seed, tol=1e-4, max_iter=60,
                                        init_centroids=init, dtype=np.float32)
    _, lab, it, _ = kmeans_full(torch.from_numpy(X), k, seed=seed, tol=1e-4, max_iter=60,
                                init_centroids=state["centroids"], n_valid=n_valid)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
    assert it == it_j


def test_scratch_is_kept_per_key_and_the_oldest_goes_first(monkeypatch):
    monkeypatch.setattr(_build, "_scratch", {})
    made = []

    def make(tag):
        made.append(tag)
        return (tag,)

    first = _build.scratch(("t", 0), lambda: make(0))
    assert _build.scratch(("t", 0), lambda: make(99)) is first
    for i in range(1, _build._SCRATCH_ENTRIES + 1):
        _build.scratch(("t", i), lambda i=i: make(i))
    assert ("t", 0) not in _build._scratch
    assert len(_build._scratch) == _build._SCRATCH_ENTRIES
    assert made == list(range(_build._SCRATCH_ENTRIES + 1))


def _fills(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages() if e.key == "aten::fill_")


def test_unfilled_allocation_skips_the_fill_and_restores_the_flag():
    import torch.utils.deterministic as tud

    with deterministic():
        assert tud.fill_uninitialized_memory
        assert _fills(lambda: torch.empty(4)) == 1      # deterministic mode fills
        with unfilled():
            assert not tud.fill_uninitialized_memory
            assert _fills(lambda: torch.empty(4)) == 0
        assert tud.fill_uninitialized_memory
    with unfilled():                                    # outside: nothing to undo
        assert tud.fill_uninitialized_memory


def test_library_name_hashes_the_shared_headers(monkeypatch, tmp_path):
    (tmp_path / "lloyd.cu").write_text("// kernel\n")
    (tmp_path / "tile.cuh").write_text("// header v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("lloyd")
    (tmp_path / "tile.cuh").write_text("// header v2\n")
    assert _build._target("lloyd") != before
    assert _build._target("lloyd").name.startswith("liblloyd-")
