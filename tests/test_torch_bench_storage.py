"""The port's ``benchmarks/storage_bench`` against the reference's
``run_storage_bench`` and ``storage_overhead`` on the CPU, from the
reference's cold init (decay 1: the reference on ``backend="jax"``).

The frontier (Archival bytes under rf=4 and EC(6,3), their ratio, repair
amplification), every side's timeline, the degeneracy of the all-replicate
config and the EC kill/resume must be the reference's."""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.storage_bench as ref  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import assert_matches, reference_on_jax, round_trips  # noqa: E402

from cdrs_tpu_torch.benchmarks import storage_bench  # noqa: E402
from cdrs_tpu_torch.benchmarks.regress import extract_records  # noqa: E402

#: The reference's ``--quick`` scale.
QUICK = dict(n_files=160, seed=13, duration=720.0, n_windows=8, kill_window=4, k=8)


@pytest.mark.parametrize("kw", [QUICK, dict(resume_check=False)], ids=["quick", "default"])
def test_storage_bench_matches_the_reference(kw, tmp_path):
    with reference_on_jax(ref):
        want = ref.run_storage_bench(**kw)
    with carried_init():
        got = storage_bench.run_storage_bench(**kw, device="cpu")
    assert_matches(got, want)
    assert all(got["criteria"].values()), got["criteria"]
    assert got["frontier"]["archival_bytes_ratio"] >= 2.0
    assert got["frontier"]["ec_repair_amplification"] > 1.0
    round_trips(got, tmp_path)


def test_storage_criteria_hold_from_the_ports_own_init():
    out = storage_bench.run_storage_bench(**QUICK, device="cpu")
    assert all(out["criteria"].values()), out["criteria"]


def test_storage_overhead_has_the_references_keys():
    kw = dict(n_files=300, duration=240.0, repeats=1)
    got = storage_bench.storage_overhead(**kw, device="cpu")
    with reference_on_jax(ref):
        want = ref.storage_overhead(**kw)
    assert set(got) == set(want)
    assert (got["windows_per_run"], got["storage_config"]) == \
        (want["windows_per_run"], want["storage_config"]) == (4, "ec_archival")


def test_storage_bench_main_quick_records_for_the_ports_history(tmp_path, capsys):
    out, overhead = tmp_path / "s.json", tmp_path / "o.json"
    assert storage_bench.main(["--quick", "--no_overhead", "--device", "cpu", "--out",
                               str(out), "--overhead_out", str(overhead)]) == 0
    doc = json.loads(out.read_text())
    assert not overhead.exists()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["archival_bytes_ratio"] == doc["frontier"]["archival_bytes_ratio"]
    (rec,) = extract_records(doc, "storage_bench_torch.json")
    assert rec["metric"] == "storage_ec_archival_bytes_ratio" and rec["round"] == 7
    assert rec["platform"] == "torch-cpu" and rec["backend"] == "torch"
