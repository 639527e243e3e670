"""The port's bench entry points at toy configs on the CPU: the device
path's result keys against the reference's ``run_bench`` under the renames
(``numpy_*`` -> ``baseline_*``, ``jax_*`` -> ``device_*``), float64's
refusal on CUDA, ``python -m cdrs_tpu_torch.benchmarks`` (one contract line,
the k = 1024 captures skipped off CUDA) and ``cdrs_tpu_torch bench``."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.benchmarks import harness as ref_harness  # noqa: E402

from cdrs_tpu_torch import cli as port_cli  # noqa: E402
from cdrs_tpu_torch.benchmarks import __main__ as bench_main  # noqa: E402
from cdrs_tpu_torch.benchmarks import harness  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


@pytest.fixture
def toy_configs(monkeypatch):
    """Configs 2-5 cut to toy sizes (their shapes' roles kept: 3 past the
    direct-baseline limit, 4 on a mesh of 8)."""
    c = harness.CONFIGS
    monkeypatch.setitem(c, 2, dataclasses.replace(c[2], n=4096, d=8, k=16, iters=4,
                                                  e2e_iters=3))
    monkeypatch.setitem(c, 3, dataclasses.replace(c[3], n=6000, d=8, k=16, iters=3,
                                                  e2e_iters=2, direct_baseline_limit=4000))
    monkeypatch.setitem(c, 4, dataclasses.replace(c[4], n=8192, d=8, k=16, iters=3,
                                                  e2e_iters=2, direct_baseline_limit=4000))
    monkeypatch.setitem(c, 5, dataclasses.replace(c[5], n=3000, iters=3))
    return c


def test_device_path_keys_at_toy_configs(toy_configs, monkeypatch):
    monkeypatch.setitem(ref_harness.CONFIGS, 2, dataclasses.replace(
        ref_harness.CONFIGS[2], n=4096, d=8, k=16, iters=4))
    want = ref_harness.run_bench(config=2, quality=False, backend="jax")
    got = harness.run_bench(config=2, device="cpu", quality=False)
    renames = {"numpy_iters_per_sec": "baseline_iters_per_sec",
               "numpy_estimated": "baseline_estimated", "jax_platform": "device_platform",
               "jax_devices": "device_count"}
    added = {"baseline", "device_name", "chunk_rows", "launches", "shift_readback"}
    assert set(got) == {renames.get(k, k) for k in want} | added
    assert got["metric"] == "lloyd_iters_per_sec_n4096_d8_k16"
    assert got["update"] == "matmul" and got["chunk_rows"] is None
    assert (got["device_platform"], got["device_name"], got["device_count"]) == \
        ("cpu", "torch-cpu", 1)
    assert got["launches"] == {"lloyd_assign_reduce": 0, "label_threshold_count": 0,
                               "lloyd_assign_reduce_rowmajor": 0}
    assert len(got["window_iters_per_sec"]) == 5
    assert got["shift_readback"]["iters"] == 1
    # Past the direct limit the baseline runs on a subsample and is scaled.
    c3 = harness.run_bench(config=3, device="cpu", quality=False)
    assert c3["baseline_estimated"] and c3["n"] == 6000 and "n_downscaled_from" not in c3


def test_float64_is_refused_on_cuda_only(monkeypatch, toy_configs):
    import cdrs_tpu_torch.device as device_mod

    with monkeypatch.context() as m:
        m.setattr(device_mod, "resolve_device", lambda d=None: torch.device("cuda", 0))
        with pytest.raises(ValueError, match="float64 runs on the CPU only"):
            harness.run_bench(config=2, dtype="float64", quality=False)
    out = harness.run_bench(config=2, dtype="float64", device="cpu", quality=False)
    assert out["dtype"] == "float64" and out["value"] > 0


def test_bench_entry_prints_one_contract_line(toy_configs, capsys, monkeypatch):
    # The quality workloads have tests of their own (test_torch_bench_quality*).
    monkeypatch.setattr(harness, "decision_quality_metrics",
                        lambda seed=21, device=None: {"planted_accuracy": 1.0})
    assert bench_main.main(["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert len(lines) == 1
    head = json.loads(lines[0])
    assert list(head) == ["metric", "value", "unit", "vs_baseline"]
    assert head["metric"] == "lloyd_iters_per_sec_n4096_d8_k16" and head["unit"] == "iter/s"
    detail = json.loads(captured.err.strip().splitlines()[-1])
    assert detail["value"] == head["value"] and "decision_quality" in detail
    for key in ("config3", "config4_rehearsal"):
        assert detail[key]["skipped"].startswith("skipped: the k = 1024 captures run on CUDA")
    assert {"python", "torch", "torch_cuda"} <= set(detail["run_meta"])
    assert bench_main.main(["--config", "2", "--update", "pallas", "--device", "cpu"]) == 2
    assert "only 'auto' is taken" in capsys.readouterr().err


def test_cli_bench_runs_one_config(toy_configs, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(harness, "decision_quality_metrics",
                        lambda seed=21, device=None: {"planted_accuracy": 1.0})
    metrics = tmp_path / "bench.jsonl"
    assert port_cli.main(["bench", "--config", "4", "--e2e", "--dtype", "bfloat16",
                          "--device", "cpu", "--metrics", str(metrics)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["e2e"] and out["dtype"] == "bfloat16" and out["init_method"] == "kmeans||"
    assert out["decision_quality"] == {"planted_accuracy": 1.0}
    assert out["median_method"] == "auto" and out["mesh_downscaled_to"] == {"data": 1}
    spans = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert any(e.get("name") == "bench.config4" for e in spans)
    assert port_cli.main(["bench", "--config", "5", "--update", "kernel", "--device",
                          "cpu"]) == 2
