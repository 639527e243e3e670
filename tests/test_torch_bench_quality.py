"""Decision quality as the port's bench records it
(``benchmarks/harness.decision_quality_metrics``) on the CPU, held to the
bounds the reference's ``tests/test_cluster.py`` asserts on its own
(planted recovery and the read-locality gain over uniform rf 1).  The
100,000-file workload is in ``test_torch_bench_quality_100k.py``."""

import pytest

pytest.importorskip("torch")

from cdrs_tpu_torch.benchmarks.harness import _quality_one  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def test_decision_quality_holds_at_2000_files():
    q = _quality_one(2000, 600.0, 121, device="cpu")
    assert q["n_files"] == 2000
    assert q["planted_accuracy"] >= 0.75
    assert q["read_locality_gain"] >= 0.05


def test_decision_quality_small_workload_fields():
    q = _quality_one(300, 300.0, 21, device="cpu")
    assert set(q) == {"n_files", "planted_accuracy", "read_locality_policy",
                      "read_locality_uniform1", "read_locality_gain", "storage_vs_uniform1"}
    assert q["planted_accuracy"] > 0.5 and q["storage_vs_uniform1"] > 1.0
    assert q["read_locality_gain"] == pytest.approx(
        q["read_locality_policy"] - q["read_locality_uniform1"])


@pytest.mark.parametrize("init_method", ["d2", "kmeans||"])
def test_init_quality_pipeline_accuracy_per_init(init_method):
    """``init_quality``'s pipeline rows: both inits recover the planted
    categories at 300 files."""
    q = _quality_one(300, 300.0, 21, init_method=init_method, device="cpu")
    assert q["planted_accuracy"] > 0.5


def test_carry_witness_on_one_device_reads_one_number():
    """On the CPU both sides draw the same init, so every column is the
    CPU's run and the carried init reproduces it."""
    from cdrs_tpu_torch.benchmarks.init_quality import carry_witness

    out = carry_witness(seeds=(21,), n_files=300, duration=300.0, device="cpu")
    (row,) = out["seeds"]
    assert out["device_name"] == "torch-cpu" and row["seed"] == 21
    assert row["cpu"] == row["device"] == row["device_from_cpu_init"] \
        == row["cpu_from_cpu_init"] > 0.5
    assert row["features_max_abs_diff"] == row["init_max_abs_diff"] == 0.0
