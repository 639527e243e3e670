"""The port's ``benchmarks/serve_bench`` against the reference's
``run_throughput``, ``run_chaos_p99``, ``run_flash_crowd`` and
``serve_overhead`` on the CPU.

The router is host numpy: throughput's latencies and utilization and every
chaos p99 must be the reference's bit for bit (reads a second are wall
clock).  The flash crowd's controllers start from the reference's cold
init (decay 1: the reference on ``backend="jax"``).  Its burst drift sits
at the 0.10 threshold (ROADMAP C4): from the port's own CPU init it is
0.1011, so drift re-clusters and the criterion fails, a strict xfail.  The
flash crowd at the default scale and the overhead block:
``test_torch_bench_serve_2.py``."""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.serve_bench as ref  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import (assert_matches, one_torch_thread,  # noqa: E402
                                reference_on_jax, round_trips)

from cdrs_tpu_torch.benchmarks import serve_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WALL = {"seconds", "reads_per_sec", "best_reads_per_sec"}
#: The reference's ``--quick`` scales (the flash crowd's is tests/test_serve.py's).
FLASH_QUICK = dict(n_files=200, duration=900.0, n_windows=9, burst_windows=(6, 6), k=8)


@pytest.mark.parametrize("fn,kw", [
    ("run_throughput", dict(n_files=1 << 16, n_reads=200_000)),
    ("run_chaos_p99", dict(n_files=4000, reads_per_window=60_000, n_windows=6,
                           service_ms=4.0)),
    ("run_chaos_p99", {}),
], ids=["throughput-quick", "chaos-quick", "chaos-default"])
def test_router_benches_match_the_reference(fn, kw, tmp_path):
    got, want = getattr(serve_bench, fn)(**kw), getattr(ref, fn)(**kw)
    assert_matches(got, want, skip=WALL)
    round_trips(got, tmp_path)
    if fn == "run_chaos_p99":
        assert got["p2c_beats_random_p99"]


def check_flash_crowd(kw):
    """The flash crowd at ``kw`` from the reference's cold init."""
    with reference_on_jax(ref):
        want = ref.run_flash_crowd(**kw)
    with carried_init():
        got = serve_bench.run_flash_crowd(**kw, device="cpu")
    assert_matches(got, want)
    assert got["hotspot_catches_what_drift_misses"]
    assert got["drift_at_burst"] < got["drift_threshold"]


@pytest.mark.parametrize("kw", [FLASH_QUICK], ids=["quick"])
def test_flash_crowd_matches_the_reference_from_its_init(kw):
    check_flash_crowd(kw)


@pytest.mark.xfail(strict=True, reason="ROADMAP Queue C4: from the port's own CPU init the "
                                       "burst drift is 0.1011, over the 0.10 threshold")
def test_flash_crowd_from_the_ports_own_init():
    got = serve_bench.run_flash_crowd(**FLASH_QUICK, device="cpu")
    assert got["hotspot_catches_what_drift_misses"], got["drift_at_burst"]


def test_serve_bench_main_quick(tmp_path, capsys):
    out = tmp_path / "s.json"
    assert serve_bench.main(["--quick", "--no_overhead", "--device", "cpu", "--out",
                             str(out)]) == 0
    doc = json.loads(out.read_text())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["p99_p2c"] == doc["chaos_p99"]["policies"]["p2c"]["p99_ms"]
    assert doc["throughput"]["n_nodes"] == 16
    assert [r["metric"] for r in doc["bench_records"]] == [
        "serve_routed_reads_per_sec", "serve_chaos_p99_ms_p2c", "serve_chaos_p99_ms_random"]
    assert set(doc["criteria"]) == {"routed_1m_reads_per_sec", "p2c_beats_random_p99",
                                    "hotspot_catches_what_drift_misses"}
    assert "torch-cpu" in doc["cold_init"]
