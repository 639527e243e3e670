"""The port's ``benchmarks/control_bench`` against the reference's
``run_control_bench`` on the CPU.

Decay 0.7 runs on the reference's ``backend="numpy"`` (float64 decayed
counters), and its batch baseline re-featurizes the whole log in float64;
the port runs both in float32.  From the reference's k-means++ inits and
reseed rows, carried in call order (``torch_bench_parity.OrderedDraws``),
every field but wall clock is the reference's: integers, hashes and
criteria exactly, floats within 1e-5."""

import json
import os

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.benchmarks.control_bench import run_control_bench as ref_run  # noqa: E402
from torch_bench_parity import (OrderedDraws, assert_matches, carried_in_order,  # noqa: E402
                                one_torch_thread, round_trips)

from cdrs_tpu_torch.benchmarks import control_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The reference's toy scale (tests/test_control.py) and its defaults.
SCALES = {"toy": dict(n_files=150, seed=7, duration=800.0, n_windows=8, k=8),
          "default": {}}


def run_pair(kw):
    draws = OrderedDraws()
    with draws.recording():
        want = ref_run(**kw)
    with carried_in_order(draws):
        got = control_bench.run_control_bench(**kw, device="cpu")
    return got, want


@pytest.mark.parametrize("scale", sorted(SCALES))
def test_control_bench_matches_the_reference(scale, tmp_path):
    got, want = run_pair(SCALES[scale])
    assert_matches(got, want)
    assert got["criteria"] == want["criteria"]
    assert got["controller"]["bytes_migrated_total"] == \
        sum(got["controller"]["bytes_migrated_per_window"])
    round_trips(got, tmp_path)


def test_control_bench_defaults_reproduce_the_pinned_reference_artifact():
    """At the reference's defaults, from its inits, both headlines are the
    ones pinned in ``data/control_bench.json``."""
    got, _ = run_pair({})
    with open(os.path.join(REPO, "data", "control_bench.json"), encoding="utf-8") as f:
        pinned = json.load(f)
    for side in ("controller", "baseline"):
        for key in ("bytes_migrated_total", "bytes_migrated_per_window", "windows_to_adapt"):
            assert got[side][key] == pinned[side][key], (side, key)
    assert got["criteria"] == pinned["criteria"]


def test_control_bench_main_writes_the_ports_artifact(tmp_path, capsys):
    out = tmp_path / "cb.json"
    assert control_bench.main(["--n_files", "150", "--duration", "800", "--windows", "8",
                               "--k", "8", "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["out"] == str(out) and line["controller_adapted"] == \
        doc["criteria"]["controller_adapted"]
    assert doc["run_meta"]["torch"] and "torch-cpu" in doc["cold_init"]
    assert set(doc) == {"scenario", "controller", "baseline", "criteria", "run_meta",
                        "cold_init"}
