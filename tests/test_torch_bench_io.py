"""The port's ingest, stream1b and init_quality benches at toy sizes on the
CPU: ingest reads every row through both parsers; stream1b's written log
gives, folded by the port, the reference's batch features; init_quality's
inertia equals the reference's on the same inputs."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.benchmarks.init_quality import _inertia as ref_inertia  # noqa: E402
from cdrs_tpu.features.numpy_backend import compute_features  # noqa: E402
from cdrs_tpu.io.events import EventLog as RefEventLog  # noqa: E402
from cdrs_tpu.config import GeneratorConfig as RefGeneratorConfig  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch.benchmarks import init_quality, stream1b  # noqa: E402
from cdrs_tpu_torch.benchmarks.ingest import bench_ingest  # noqa: E402
from cdrs_tpu_torch.config import GeneratorConfig  # noqa: E402
from cdrs_tpu_torch.features.streaming import fold_stream, stream_finalize  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402


def test_ingest_reads_every_row_through_both_parsers():
    out = bench_ingest(rows=30_000, files=2_000, batch_size=7_000, py_rows_cap=10_000)
    assert out["rows"] == 30_000 and out["unit"] == "row/s"
    assert out["metric"] == "log_ingest_rows_per_sec_rows30000_files2000"
    assert out["value"] == out["native_rows_per_sec"] > 0 and out["python_rows_per_sec"] > 0
    assert out["vs_python"] == out["native_rows_per_sec"] / out["python_rows_per_sec"]


@pytest.mark.parametrize("log_format", ["csv", "binary"])
def test_stream1b_path_small_scale_matches_the_reference_batch_features(tmp_path,
                                                                         log_format):
    out = stream1b.run_stream1b(events=50_000, n_files=500, batch_size=7_000, seed=11,
                                workdir=str(tmp_path), keep_log=True, log_format=log_format,
                                device="cpu")
    assert out["feature_rows"] == 500 and out["events_simulated"] > 10_000
    assert out["device_name"] == "torch-cpu" and out["log_path"].startswith(str(tmp_path))
    assert out["ingest_parse_prep_seconds"] == pytest.approx(
        out["ingest_parse_seconds"] + out["ingest_prep_seconds"])
    # The reference reads the written log and computes the batch features;
    # the port folds the same log in batches.
    rm = ref_generate(RefGeneratorConfig(n_files=500, seed=11))
    golden = compute_features(rm, RefEventLog.read_csv(out["log_path"], rm))
    manifest = generate_population(GeneratorConfig(n_files=500, seed=11))
    state = fold_stream(out["log_path"], manifest, device="cpu", batch_size=7_000)
    table = stream_finalize(state, manifest, dtype="float64")
    np.testing.assert_allclose(table.raw.numpy(), golden.raw, atol=1e-9)


def test_stream1b_refuses_an_unknown_format():
    with pytest.raises(ValueError, match="log_format"):
        stream1b.run_stream1b(events=1000, n_files=10, log_format="parquet", device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_inertia_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(10_000, 6)).astype(np.float32)
    c = rng.normal(size=(9, 6)).astype(np.float32)
    labels = rng.integers(-1, 9, size=10_000).astype(np.int32)
    got = init_quality._inertia(torch.from_numpy(x), c, torch.from_numpy(labels), chunk=4096)
    want = ref_inertia(x, c, labels, chunk=4096)
    assert got == pytest.approx(want, rel=1e-5)


def test_sweep_shape_reports_both_inits(tmp_path):
    out = init_quality._sweep_shape(4096, 8, 16, [0, 1], 10, device="cpu")
    assert out["seeds"] == [0, 1] and out["max_iter"] == 10
    for method in ("d2", "kmeans||"):
        assert len(out[method]["inertia_per_seed"]) == 2
        assert all(v > 0 for v in out[method]["inertia_per_seed"])
        assert all(1 <= it <= 10 for it in out[method]["n_iter_per_seed"])
    assert out["inertia_ratio_kmeans_par_over_d2"] == pytest.approx(
        out["kmeans||"]["inertia_mean"] / out["d2"]["inertia_mean"])


def test_init_quality_main_writes_its_own_file(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(init_quality, "run_init_quality",
                        lambda small, n_seeds, device: {"small": small, "shapes": [],
                                                        "n_seeds": n_seeds})
    out = tmp_path / "iq.json"
    assert init_quality.main(["--small", "--seeds", "2", "--out", str(out)]) == 0
    assert json.loads(out.read_text()) == {"small": True, "shapes": [], "n_seeds": 2}
    assert init_quality.DEFAULT_OUT != "data/init_quality_r5.json"


def test_init_quality_carry_witness_writes_its_own_file(tmp_path, monkeypatch, capsys):
    seen = {}

    def fake(seeds, device=None):
        seen["seeds"] = list(seeds)
        return {"device_name": "torch-cpu", "seeds": []}

    monkeypatch.setattr(init_quality, "carry_witness", fake)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data").mkdir()
    assert init_quality.main(["--carry_witness", "--seeds", "2", "--device", "cpu"]) == 0
    assert seen["seeds"] == [21, 22]
    assert json.loads((tmp_path / init_quality.WITNESS_OUT).read_text())["seeds"] == []
    assert json.loads(capsys.readouterr().out)["device_name"] == "torch-cpu"
