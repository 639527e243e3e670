"""The port's ``benchmarks/telemetry_overhead`` against the reference's
``run_overhead`` on the CPU.

The ratios are wall clock, so only the structure is held: the daemon
block has the reference's keys, the same windows a run and traced
decisions a run, the reference's 1.05 budget, a scraper that reached the
live endpoint, and finite ratios from every round."""

import json
import math

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.telemetry_overhead as ref  # noqa: E402
from torch_bench_parity import one_torch_thread, round_trips  # noqa: E402

from cdrs_tpu_torch.benchmarks import telemetry_overhead  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: The ratio fields of the daemon block.
RATIOS = ("overhead_ratio", "scrape_overhead_ratio", "paired_ratio_median",
          "scraped_paired_ratio_median")


def test_overhead_block_has_the_references_structure(tmp_path):
    kw = dict(n_files=300, n_windows=3, rounds=1)
    got = telemetry_overhead.run_overhead(**kw, device="cpu")
    want = ref.run_overhead(**kw)
    assert set(got) == set(want)
    assert got["windows_per_run"] == want["windows_per_run"] == 3
    assert got["trace_events_per_run"] == want["trace_events_per_run"] == 3
    assert got["budget"] == want["budget"] == telemetry_overhead.BUDGET == 1.05
    assert got["scrapes_last_run"] > 0
    for key in ("plain_windows", "traced_windows", "scraped_windows", "paired_ratios",
                "scraped_paired_ratios"):
        assert len(got[key]) == len(want[key]) == 1, key
    ratios = [got[k] for k in RATIOS] + got["paired_ratios"] + got["scraped_paired_ratios"]
    assert all(math.isfinite(r) and r > 0 for r in ratios), ratios
    assert got["within_budget"] == (got["overhead_ratio"] <= 1.05)
    round_trips(got, tmp_path)


def test_telemetry_overhead_main_quick_keeps_the_references_keys(tmp_path, capsys):
    out = tmp_path / "t.json"
    assert telemetry_overhead.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert set(doc) == {"artifact", "note", "daemon", "run_meta", "cold_init"}
    assert "untimed" in doc["note"] and doc["run_meta"]
    block = doc["daemon"]
    assert (block["n_files"], block["windows_per_run"], len(block["plain_windows"])) == \
        (2_000, 6, 3)
    assert block["trace_events_per_run"] == 6 and block["scrapes_last_run"] > 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["overhead_ratio"] == block["overhead_ratio"]
    assert line["within_budget"] == block["within_budget"]
