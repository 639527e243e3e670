"""The copied work counts give the bounds PERF.md's kernel table states."""

from __future__ import annotations

import pytest

from portbench import cost

H100 = cost.peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("n, d, k, bound_ms", [
    (10_485_760, 128, 1024, 16.6674),     # config 3: operations
    (1_048_576, 32, 128, 0.0523),         # config 2: operations
])
def test_b1_bound(n, d, k, bound_ms):
    ops, n_bytes = cost.lloyd_cost(n, d, k)
    assert cost.bound_seconds(ops, n_bytes, H100) * 1e3 == pytest.approx(bound_ms, abs=1e-4)


def test_b2_bound_at_config_3():
    ops, n_bytes = cost.seg_count_cost(10_485_760, 128, 1024)
    assert cost.bound_seconds(ops, n_bytes, H100) * 1e3 == pytest.approx(1.6157, abs=1e-4)


def test_labels_add_their_bytes_and_an_unknown_card_has_no_peaks():
    assert cost.lloyd_cost(10, 4, 2, with_labels=True)[1] - cost.lloyd_cost(10, 4, 2)[1] == 40
    assert cost.peaks("cpu") is None
