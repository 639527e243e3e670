"""The port's trajectory gate (``cdrs_tpu_torch/benchmarks/regress.py``,
``metrics regress``): ``tests/test_regress.py``'s cases on the port's copy,
the reference's captures read as the reference reads them, the port's
records on their own platform, and the port's own history and ``--round``."""

import json
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.benchmarks import regress as ref_regress  # noqa: E402

from cdrs_tpu_torch.benchmarks.regress import (DEFAULT_HISTORY, append_history,  # noqa: E402
                                               check_run, extract_records, history_key,
                                               ingest_files, load_history,
                                               main as regress_main, write_history)
from cdrs_tpu_torch.obs.metrics_cli import main as metrics_main  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CAPTURES = [ROOT / f"BENCH_r0{i}.json" for i in range(1, 6)]
H100 = "NVIDIA H100 80GB HBM3"


def _hist(values, metric="lloyd_iters_per_sec_n1_d1_k1", unit="iter/s", platform="tpu"):
    return [{"round": i + 1, "metric": metric, "value": v, "unit": unit,
             "direction": "higher" if unit == "iter/s" else "lower",
             "platform": platform}
            for i, v in enumerate(values)]


def _run(value, metric="lloyd_iters_per_sec_n1_d1_k1", unit="iter/s", platform="tpu"):
    return [{"metric": metric, "value": value, "unit": unit,
             "direction": "higher" if unit == "iter/s" else "lower",
             "platform": platform}]


# -- banding (tests/test_regress.py's cases) ------------------------------------------

def test_improvement_passes():
    [v] = check_run(_run(200.0), _hist([100.0, 110.0, 120.0]))
    assert v["status"] == "improved" and v["baseline"] == 120.0


@pytest.mark.parametrize("value", [115.0, 108.0, 120.0, 103.0])
def test_within_band_noise_passes(value):
    [v] = check_run(_run(value), _hist([100.0, 110.0, 120.0]))
    assert v["status"] == "pass"


def test_injected_slowdown_fails():
    [v] = check_run(_run(120.0 * 0.8), _hist([100.0, 110.0, 120.0]))
    assert v["status"] == "regression" and v["band_low"] == 120.0 * 0.85


def test_steep_trajectory_catches_slowdown_from_latest():
    [v] = check_run(_run(1888.0 * 0.8), _hist([103.0, 288.0, 1773.0, 1888.0]))
    assert v["status"] == "regression"


@pytest.mark.parametrize("value,status", [(2.9 * 1.2, "regression"), (3.0, "pass"),
                                          (2.0, "improved")])
def test_lower_better_direction(value, status):
    hist = _hist([3.2, 3.0, 2.9], metric="e2e_seconds_to_categories_n1", unit="s")
    [v] = check_run(_run(value, metric="e2e_seconds_to_categories_n1", unit="s"), hist)
    assert v["status"] == status


def test_platform_mismatch_is_no_baseline():
    [v] = check_run(_run(1.0, platform="cpu"), _hist([100.0, 110.0]))
    assert v["status"] == "no_baseline"


def test_window_limits_history():
    [v] = check_run(_run(118.0), _hist([10000.0, 100.0, 110.0, 120.0]), window=3)
    assert v["status"] == "pass"


def test_explicit_direction_wins():
    doc = {"bench_records": [{"metric": "scenario_x_churn_bytes", "value": 100.0,
                              "unit": "bytes", "direction": "lower", "backend": "torch"}]}
    [rec] = extract_records(doc, "sweep.json")
    assert rec["direction"] == "lower"
    hist = [dict(rec, round=1)]
    assert check_run([rec | {"value": 130.0}], hist)[0]["status"] == "regression"
    assert check_run([rec | {"value": 80.0}], hist)[0]["status"] == "improved"


# -- the reference's captures, read as the reference reads them ---------------------

def test_extract_round_capture_with_nested_blocks():
    doc = {"n": 4, "cmd": "python bench.py", "rc": 0, "tail": "...",
           "parsed": {"metric": "m1", "value": 10.0, "unit": "iter/s",
                      "vs_baseline": 2.0, "backend": "jax", "jax_platform": "tpu",
                      "jax_devices": 1,
                      "config3": {"metric": "m3", "value": 5.0, "unit": "iter/s",
                                  "jax_platform": "tpu"},
                      "config4_rehearsal": {"skipped": "no TPU"}}}
    recs = extract_records(doc, "BENCH_r04.json")
    assert recs == ref_regress.extract_records(doc, "BENCH_r04.json")
    assert [(r["metric"], r["value"], r["round"], r["platform"]) for r in recs] == \
        [("m1", 10.0, 4, "tpu"), ("m3", 5.0, 4, "tpu")]


def test_extract_scrapes_truncated_tail():
    tail = ('... truncated ..., "metric": "m_head", "value": 42.5, '
            '"unit": "iter/s", "vs_baseline": 7.0, "backend": "jax", '
            '"jax_devices": 1, "jax_platform": "tpu", "config3": '
            '{"metric": "m_c3", "value": 3.25, "unit": "s", '
            '"jax_platform": "tpu"}, "metric": "m_head", "value": 42.5, '
            '"unit": "iter/s"')
    doc = {"n": 5, "cmd": "c", "rc": 0, "parsed": None, "tail": tail}
    recs = extract_records(doc, "BENCH_r05.json")
    assert recs == ref_regress.extract_records(doc, "BENCH_r05.json")
    assert {r["metric"] for r in recs} == {"m_head", "m_c3"}


@pytest.mark.parametrize("path", CAPTURES, ids=lambda p: p.name)
def test_each_capture_extracts_as_the_reference_extracts_it(path):
    doc = json.loads(path.read_text())
    assert extract_records(doc, path.name) == ref_regress.extract_records(doc, path.name)


def test_ingest_of_the_captures_and_verdicts_equal_the_references(tmp_path):
    paths = [str(p) for p in CAPTURES]
    records = ingest_files(paths)
    assert records == ref_regress.ingest_files(paths)
    assert {r["round"] for r in records} == {1, 2, 3, 4, 5}
    headline = [r for r in records if r["metric"] == "lloyd_iters_per_sec_n1048576_d32_k128"]
    assert len(headline) == 5 and {r["platform"] for r in headline} == {"tpu"}
    out = tmp_path / "h.jsonl"
    write_history(str(out), records)
    assert load_history(str(out)) == records
    # A TPU run against the TPU trajectory: the reference's verdicts.
    run = [dict(r, value=r["value"] * f) for r, f in zip(headline[-1:] * 3, (0.5, 1.0, 2.0))]
    assert check_run(run, records) == ref_regress.check_run(run, records)
    assert [v["status"] for v in check_run(run, records)] == ["regression", "pass",
                                                              "improved"]


def test_a_port_record_never_bands_against_a_tpu_row():
    history = ingest_files([str(p) for p in CAPTURES])
    detail = {"metric": "lloyd_iters_per_sec_n1048576_d32_k128", "value": 1.0,
              "unit": "iter/s", "vs_baseline": 3.0, "backend": "torch",
              "device_platform": "cuda", "device_name": H100, "device_count": 1,
              "config3": {"metric": "lloyd_iters_per_sec_n10485760_d128_k1024",
                          "value": 0.01, "unit": "iter/s", "device_name": H100,
                          "device_count": 1},
              "config4_rehearsal": {"metric": "e2e_seconds_to_categories_n52428800_d128_k1024",
                                    "value": 1e6, "unit": "s", "device_name": H100}}
    recs = extract_records(detail, "bench_detail.json")
    assert [r["platform"] for r in recs] == [H100] * 3
    assert recs[0]["devices"] == 1 and recs[0]["round"] is None
    verdicts = check_run(recs, history)
    assert [v["status"] for v in verdicts] == ["no_baseline"] * 3
    cpu = extract_records({"metric": "lloyd_iters_per_sec_n10000_d8_k10", "value": 5.0,
                           "unit": "iter/s", "backend": "torch-cpu"}, "c1.json")
    assert cpu[0]["platform"] == "torch-cpu"
    assert check_run(cpu, history)[0]["status"] == "no_baseline"


def test_scraped_port_tail_takes_the_cards_name():
    tail = ('"metric": "m_head", "value": 42.5, "unit": "iter/s", "vs_baseline": 7.0, '
            f'"backend": "torch", "device_platform": "cuda", "device_name": "{H100}"')
    [rec] = extract_records({"n": 6, "cmd": "c", "rc": 0, "parsed": None, "tail": tail},
                            "BENCH_r06.json")
    assert rec["platform"] == H100 and rec["round"] == 6 and rec["scraped"]


# -- append/dedup and the CLI -------------------------------------------------------

def test_append_history_dedups_and_keeps_order(tmp_path):
    path = str(tmp_path / "h.jsonl")
    first = _hist([100.0, 110.0])
    assert append_history(path, first) == 2
    newer = _hist([100.0, 110.0, 120.0])
    assert append_history(path, newer) == 1
    rows = load_history(path)
    assert rows == first + [newer[2]]
    assert append_history(path, newer) == 0 and load_history(path) == rows
    remeasured = dict(newer[2], value=999.0)
    assert append_history(path, [remeasured]) == 0
    assert history_key(remeasured) == history_key(newer[2])


def _capture(tmp_path, name, n, metric, value):
    p = tmp_path / name
    p.write_text(json.dumps({"n": n, "cmd": "c", "rc": 0, "tail": "",
                             "parsed": {"metric": metric, "value": value, "unit": "iter/s",
                                        "device_name": H100}}))
    return str(p)


def test_ingest_cli_is_idempotent(tmp_path):
    hist = str(tmp_path / "h.jsonl")
    b1 = _capture(tmp_path, "b1.json", 1, "m", 100.0)
    assert regress_main(["--ingest", b1, "--history", hist]) == 0
    rows = load_history(hist)
    assert len(rows) == 1 and rows[0]["platform"] == H100
    assert regress_main(["--ingest", b1, b1, "--history", hist]) == 0
    assert load_history(hist) == rows
    b2 = _capture(tmp_path, "b2.json", 2, "a_first", 1.0)
    assert regress_main(["--ingest", b2, "--history", hist]) == 0
    assert load_history(hist)[0] == rows[0] and len(load_history(hist)) == 2


def test_regress_cli_exit_codes(tmp_path, capsys):
    hist = str(tmp_path / "h.jsonl")
    write_history(hist, _hist([100.0, 110.0, 120.0], platform=H100))
    good, slow = tmp_path / "good.json", tmp_path / "slow.json"
    for path, value in ((good, 119.0), (slow, 96.0)):
        path.write_text(json.dumps({"metric": "lloyd_iters_per_sec_n1_d1_k1", "value": value,
                                    "unit": "iter/s", "device_name": H100}))
    assert regress_main([str(good), "--history", hist]) == 0
    assert regress_main([str(slow), "--history", hist]) == 1
    assert regress_main([str(slow), "--history", hist, "--report-only"]) == 0
    capsys.readouterr()
    assert regress_main([str(slow), "--history", hist, "--json", "--report-only"]) == 0
    assert json.loads(capsys.readouterr().out)[0]["status"] == "regression"
    assert regress_main([str(tmp_path / "nope.json"), "--history", hist]) == 2
    assert regress_main([str(good), "--history", str(tmp_path / "nope.jsonl")]) == 2


def test_round_appends_the_checked_run_and_a_second_check_finds_its_band(
        tmp_path, monkeypatch, capsys):
    """The port's ledger: absent until a ``--round`` append (the default
    path reads as empty), stamped with the round, deduped on re-runs; the
    reference's ``data/bench_history.jsonl`` is never written."""
    monkeypatch.chdir(tmp_path)
    ref_history = ROOT / "data" / "bench_history.jsonl"
    before = ref_history.read_bytes()
    detail = tmp_path / "detail.json"
    detail.write_text(json.dumps({
        "metric": "lloyd_iters_per_sec_n1048576_d32_k128", "value": 3000.0,
        "unit": "iter/s", "vs_baseline": 200.0, "backend": "torch", "device_name": H100,
        "config3": {"metric": "lloyd_iters_per_sec_n10485760_d128_k1024", "value": 14.0,
                    "unit": "iter/s", "device_name": H100}}))
    assert regress_main([str(detail), "--json"]) == 0
    assert {v["status"] for v in json.loads(capsys.readouterr().out)} == {"no_baseline"}
    assert not (tmp_path / DEFAULT_HISTORY).exists()
    assert regress_main([str(detail), "--round", "16"]) == 0
    rows = load_history(str(tmp_path / DEFAULT_HISTORY))
    assert [(r["round"], r["platform"]) for r in rows] == [(16, H100)] * 2
    assert regress_main([str(detail), "--round", "16"]) == 0
    assert load_history(str(tmp_path / DEFAULT_HISTORY)) == rows
    capsys.readouterr()
    assert regress_main([str(detail), "--json"]) == 0
    assert {v["status"] for v in json.loads(capsys.readouterr().out)} == {"pass"}
    assert ref_history.read_bytes() == before


def test_regress_via_the_metrics_subcommand(tmp_path):
    hist = str(tmp_path / "h.jsonl")
    b1 = _capture(tmp_path, "b1.json", 1, "m", 100.0)
    assert metrics_main(["regress", "--ingest", b1, "--history", hist]) == 0
    run = tmp_path / "run.json"
    run.write_text(json.dumps({"metric": "m", "value": 99.0, "unit": "iter/s",
                               "device_name": H100}))
    assert metrics_main(["regress", str(run), "--history", hist]) == 0
    run.write_text(json.dumps({"metric": "m", "value": 50.0, "unit": "iter/s",
                               "device_name": H100}))
    assert metrics_main(["regress", str(run), "--history", hist]) == 1
