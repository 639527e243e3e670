"""The port's ``benchmarks/chaos_bench`` (part 2 of
``test_torch_bench_chaos.py``): the rack criteria from the port's own CPU
init, the overhead block's keys against the reference's
``chaos_overhead``, and ``main``'s two artifacts."""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.chaos_bench as ref  # noqa: E402
from test_torch_bench_chaos import RACK_TOY  # noqa: E402
from torch_bench_parity import one_torch_thread, reference_on_jax  # noqa: E402

from cdrs_tpu_torch.benchmarks import chaos_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


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
