"""The port's ``benchmarks/chaos_bench`` against the reference's
``run_chaos_bench``, ``run_rack_bench`` and ``chaos_overhead`` on the CPU.

Decay-1 controllers: the reference re-runs on ``backend="jax"`` and the
port's full re-clusters start from its D² init of the same snapshot
(``carried_init``); every field but wall clock must then be the
reference's.  The rack kill is ROADMAP C2's schedule, but C2 is the
scenario cell's ``alerts_expected`` rule, which the bench has not: from the
port's own CPU init every rack criterion holds too."""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.chaos_bench as ref  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import assert_matches, reference_on_jax, round_trips  # noqa: E402

from cdrs_tpu_torch.benchmarks import chaos_bench  # noqa: E402

#: The reference's toy scales (tests/test_faults.py, tests/test_partitions.py
#: at CDRS_CHAOS_SEED 0).
KILL_TOY = dict(n_files=120, seed=7, duration=720.0, n_windows=8, kill_window=3, k=8,
                overhead=False)
RACK_TOY = dict(n_files=120, seed=17, duration=720.0, n_windows=8, kill_window=3,
                partition_windows=(2, 4))


def run_pair(fn, kw):
    with reference_on_jax(ref):
        want = getattr(ref, fn)(**kw)
    with carried_init():
        got = getattr(chaos_bench, fn)(**kw, device="cpu")
    return got, want


@pytest.mark.parametrize("fn,kw", [
    ("run_chaos_bench", KILL_TOY),
    ("run_chaos_bench", dict(overhead=False, resume_check=False)),
    ("run_rack_bench", RACK_TOY),
    ("run_rack_bench", dict(resume_check=False)),
], ids=["kill-toy", "kill-default", "rack-toy", "rack-default"])
def test_chaos_bench_matches_the_reference(fn, kw, tmp_path):
    got, want = run_pair(fn, kw)
    assert_matches(got, want)
    assert all(got["criteria"].values()), got["criteria"]
    round_trips(got, tmp_path)


@pytest.mark.parametrize("kw", [RACK_TOY, dict(resume_check=False)], ids=["toy", "default"])
def test_rack_criteria_hold_from_the_ports_own_init(kw):
    out = chaos_bench.run_rack_bench(**kw, device="cpu")
    assert all(out["criteria"].values()), out["criteria"]
    assert out["rack_kill"]["flat"]["files_lost_max"] > 0


def test_chaos_overhead_has_the_references_keys():
    kw = dict(n_files=300, duration=240.0, repeats=1)
    got = chaos_bench.chaos_overhead(**kw, device="cpu")
    with reference_on_jax(ref):
        want = ref.chaos_overhead(**kw)
    assert set(got) == set(want)
    assert got["windows_per_run"] == want["windows_per_run"] == 4
    assert got["budget"] == want["budget"] == 1.05
    assert len(got["plain_windows"]) == len(got["paired_ratios"]) == 1


def test_chaos_bench_main_writes_both_artifacts(tmp_path, capsys):
    out, rack = tmp_path / "kill.json", tmp_path / "rack.json"
    argv = ["--n_files", "120", "--duration", "720", "--windows", "8", "--kill_window", "3",
            "--k", "8", "--no_overhead", "--device", "cpu", "--out", str(out),
            "--rack_out", str(rack)]
    assert chaos_bench.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    kill_doc, rack_doc = json.loads(out.read_text()), json.loads(rack.read_text())
    assert line["out"] == str(out) and line["rack_out"] == str(rack)
    assert line["zero_files_lost"] == kill_doc["criteria"]["zero_files_lost"]
    assert line["rack_budget_respected"] == rack_doc["criteria"]["budget_respected"]
    for doc in (kill_doc, rack_doc):
        assert "torch-cpu" in doc["cold_init"] and doc["run_meta"]["torch"]
