"""The port's ``benchmarks/mesh_bench`` against the reference's on the CPU
(part 2 of ``test_torch_bench_mesh.py``): the throughput and data = 1
overhead blocks have the reference's keys and its collective-bytes
estimate, the artifact records ``cards`` (0 on the CPU), and ``main
--quick`` writes ``run_meta`` and ``cold_init`` and no history row.  The
times are wall clock and are not compared."""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.mesh_bench as ref  # noqa: E402
from torch_bench_parity import one_torch_thread  # noqa: E402

from cdrs_tpu_torch.benchmarks import mesh_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("shape", ["config2", "config3"])
def test_throughput_block_has_the_references_keys(shape):
    n = 2_048
    got = mesh_bench._throughput(shape, n, 2, 1, [1, 2, 8], 0, mesh_bench.resolve_device("cpu"))
    want = ref._throughput(shape, n, 2, 1, [1, 2, 8], 0)
    assert set(got) == set(want)
    for key in ("shape", "n", "d", "k", "iters", "collective_bytes_per_iter_at_max"):
        assert got[key] == want[key], key
    assert got["collective_bytes_per_iter_at_max"] > 0
    assert [r["devices"] for r in got["per_device_count"]] == [1, 2, 8]
    for g, w in zip(got["per_device_count"], want["per_device_count"]):
        assert set(g) == set(w) and g["iters_per_sec"] > 0


def test_overhead_block_has_the_references_keys():
    got = mesh_bench._overhead(4_096, 2, 2, 0, device="cpu")
    want = ref._overhead(4_096, 2, 2, 0)
    assert set(got) == set(want)
    for key in ("n", "d", "k", "iters", "rounds", "methodology"):
        assert got[key] == want[key], key
    assert len(got["rounds_single_seconds"]) == len(got["rounds_mesh_seconds"]) == 2
    assert got["overhead_ratio"] > 0


def test_mesh_bench_records_no_cards_on_the_cpu():
    out = mesh_bench.run_mesh_bench(n2=1_024, n3=1_024, iters2=1, iters3=1, rounds=1,
                                    device_counts=[1, 2], seeds=[1], overhead_rounds=1,
                                    device="cpu")
    assert out["cards"] == 0 and out["torch_device"] == "cpu"
    assert out["device_counts"] == [1, 2] and "harness, not scaling" in out["note"]
    assert out["criteria"]["decision_identity_all_seeds"]
    (rec,) = out["bench_records"]
    assert rec["metric"] == "mesh_config2_iters_per_sec_d2" and rec["device_count"] == 0


def test_shard_counts_are_not_clipped_to_the_cards(monkeypatch):
    """The reference clips the counts to ``jax.device_count()``; the port's
    mesh places shard s on card s mod the card count, so it keeps them."""
    seen = []
    monkeypatch.setattr(mesh_bench, "_throughput",
                        lambda name, n, it, r, counts, seed, dev: seen.append(counts) or {
                            "shape": name, "per_device_count": [{"devices": counts[-1],
                                                                 "iters_per_sec": 1.0}]})
    monkeypatch.setattr(mesh_bench, "_decision_identity", lambda seeds, ndev, dev: {"ok": True})
    monkeypatch.setattr(mesh_bench, "_overhead", lambda *a: {"overhead_ratio": 1.0})
    out = mesh_bench.run_mesh_bench(1, 1, 1, 1, 1, [1, 2, 4, 8, 16], [0], 1, device="cpu")
    assert seen == [[1, 2, 4, 8, 16]] * 2 and out["device_counts"] == [1, 2, 4, 8, 16]
    with pytest.raises(ValueError, match="shard counts"):
        mesh_bench.run_mesh_bench(1, 1, 1, 1, 1, [0, 2], [0], 1, device="cpu")


def test_mesh_bench_main_quick_writes_the_ports_artifact(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "m.json"
    assert mesh_bench.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert set(doc) == {"torch_device", "cards", "device_counts", "note", "throughput",
                        "decision_identity", "overhead", "criteria", "bench_records", "round",
                        "run_meta", "cold_init"}
    assert doc["cards"] == 0 and doc["device_counts"] == [1, 2, 4, 8]
    assert doc["criteria"]["decision_identity_all_seeds"]
    assert [t["n"] for t in doc["throughput"]] == [16_384, 4_096]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["history_appended"] == 0 and not (tmp_path / "data").exists()
