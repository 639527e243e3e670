"""The port's one-command sweep (``cdrs_tpu_torch/benchmarks/summary.py``),
``tests/test_bench_summary.py``'s cases: ``run_bench`` and ``bench_ingest``
stubbed so no real benchmark runs (the real sweep runs on the card).  Every
config lands under its key, a failing step records its error, ``--out``
writes valid JSON; the overhead records' bookkeeping at toy scale."""

import json

import pytest

pytest.importorskip("torch")

import cdrs_tpu_torch.benchmarks.harness as harness  # noqa: E402
import cdrs_tpu_torch.benchmarks.ingest as ingest_mod  # noqa: E402
from cdrs_tpu_torch.benchmarks.summary import (_step, kprof_overhead, main,  # noqa: E402
                                               run_summary, telemetry_overhead,
                                               telemetry_overhead_control)


@pytest.fixture
def stubbed(monkeypatch):
    calls = []

    def fake_run_bench(config=2, **kw):
        calls.append((config, kw))
        if kw.get("dtype") == "bfloat16" and config == 4:
            raise RuntimeError("no bf16 today")
        return {"config": config, "value": float(config), **kw}

    monkeypatch.setattr(harness, "run_bench", fake_run_bench)
    monkeypatch.setattr(ingest_mod, "bench_ingest", lambda: {"value": 123.0, "unit": "row/s"})
    return calls


def test_run_summary_structure_and_fault_isolation(stubbed):
    out = run_summary(quality=False, device="cpu")
    assert set(out) >= {"hardware", "lloyd", "e2e", "streaming", "ingestion"}
    assert out["hardware"] == {"device_platform": "cpu", "device_name": "torch-cpu",
                               "device_count": 1}
    assert out["lloyd"]["config2"]["value"] == 2.0
    assert out["lloyd"]["config2_bf16"]["dtype"] == "bfloat16"
    assert "no bf16 today" in out["lloyd"]["config4_bf16"]["error"]
    assert out["streaming"]["config"] == 5
    assert {f"config{c}" for c in (2, 3, 4)} <= set(out["e2e"])
    assert all(v["e2e"] for v in out["e2e"].values())
    assert out["ingestion"]["value"] == 123.0
    assert all(kw["device"] == "cpu" for _, kw in stubbed)


def test_summary_cli_writes_json(stubbed, tmp_path, capsys):
    out_path = tmp_path / "sweep.json"
    assert main(["--out", str(out_path), "--no_quality", "--device", "cpu"]) == 0
    on_disk = json.loads(out_path.read_text())
    assert on_disk["lloyd"]["config1"]["value"] == 1.0
    assert json.loads(capsys.readouterr().out)["lloyd"]["config1"]["value"] == 1.0


def test_step_error_isolation_unit(capsys):
    out = {}
    _step(out, "ok", lambda: {"v": 1})
    _step(out, "boom", lambda: (_ for _ in ()).throw(KeyError("nope")))
    assert out["ok"] == {"v": 1}
    assert out["boom"]["error"].startswith("KeyError")
    assert "boom FAILED" in capsys.readouterr().err


def test_telemetry_overhead_structure():
    out = telemetry_overhead(n_files=300, duration=60.0, repeats=1, device="cpu")
    assert set(out) >= {"plain_seconds", "telemetry_seconds", "overhead_ratio",
                        "within_budget", "budget", "events_emitted"}
    assert out["plain_seconds"] > 0 and out["telemetry_seconds"] > 0
    assert out["overhead_ratio"] == pytest.approx(out["telemetry_seconds"]
                                                  / out["plain_seconds"])
    assert out["events_emitted"] > 0
    assert out["within_budget"] == (out["overhead_ratio"] <= out["budget"])


def test_control_and_kprof_overhead_structure():
    ctl = telemetry_overhead_control(n_files=300, duration=120.0, window_seconds=60.0,
                                     repeats=1, device="cpu")
    assert ctl["windows_per_run"] == 2 and ctl["audit_events_per_run"] >= 1
    assert ctl["overhead_ratio"] == pytest.approx(ctl["telemetry_audit_seconds"]
                                                  / ctl["plain_seconds"])
    kp = kprof_overhead(n=4000, d=4, k=8, calls=2, device="cpu")
    assert len(kp["plain_calls"]) == len(kp["kprof_calls"]) == 2
    assert kp["capture_seconds_one_time"] > 0
