"""The port's decision quality at 100,000 files on the CPU, held to the
bound the reference's ``tests/test_cluster.py`` asserts
(``test_decision_quality_holds_at_100k_files``)."""

import pytest

pytest.importorskip("torch")

from cdrs_tpu_torch.benchmarks.harness import _quality_one  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def test_decision_quality_holds_at_100k_files():
    q = _quality_one(100_000, 600.0, 21, device="cpu")
    assert q["n_files"] == 100_000
    assert q["planted_accuracy"] >= 0.78
    assert q["read_locality_gain"] >= 0.08
