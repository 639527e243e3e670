"""The port's scenario matrix (``cdrs_tpu_torch.scenarios``) on the CPU: the
cases of the reference's ``tests/test_scenarios.py`` that need no serving,
mesh or functional placement, plus the port's own contracts —
the suites equal the reference's spec for spec, every axis runs (the mesh
since ROADMAP A9), and the workload curves are bit-identical to the
reference's."""

import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.scenarios import presets as ref_presets  # noqa: E402
from cdrs_tpu.scenarios import sweep as ref_sweep  # noqa: E402
from cdrs_tpu.scenarios.spec import ScenarioSpec as RefSpec  # noqa: E402
from cdrs_tpu.sim import access as ref_access  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch import cli as port_cli  # noqa: E402
from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig  # noqa: E402
from cdrs_tpu_torch.faults import FaultSchedule  # noqa: E402
from cdrs_tpu_torch.scenarios import (PRESETS, ScenarioSpec, preset,  # noqa: E402
                                      random_cell, run_cell, suite_cells)
from cdrs_tpu_torch.scenarios.harness import (_controller, build_events,  # noqa: E402
                                              build_schedule, repro_line)
from cdrs_tpu_torch.scenarios.sweep import run_cells  # noqa: E402
from cdrs_tpu_torch.sim import access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

SEED = 0


def _tiny(name="tiny", **kw) -> ScenarioSpec:
    base = dict(n_files=120, seed=SEED, duration=480.0, n_windows=8, k=8,
                nodes=("dn1", "dn2", "dn3", "dn4"))
    base.update(kw)
    return ScenarioSpec(name=name, **base)


def _run(spec, **kw):
    return run_cell(spec, device="cpu", **kw)


# -- spec -------------------------------------------------------------------------

def test_spec_json_roundtrip():
    spec = preset("rack-partition")
    d = spec.to_dict()
    json.loads(json.dumps(d))
    assert ScenarioSpec.from_dict(d).to_dict() == d


def test_spec_validation():
    with pytest.raises(ValueError, match="workload kind"):
        ScenarioSpec(name="x", workload={"kind": "sawtooth"})
    with pytest.raises(ValueError, match="drift kind"):
        ScenarioSpec(name="x", drift={"kind": "nope"})
    with pytest.raises(ValueError, match="poisson workload only"):
        ScenarioSpec(name="x", workload={"kind": "diurnal"}, drift={"kind": "flip"})
    with pytest.raises(ValueError, match="scrub requires"):
        ScenarioSpec(name="x", scrub=1000)
    with pytest.raises(ValueError, match="unknown scenario spec keys"):
        ScenarioSpec.from_dict({"name": "x", "wat": 1})
    with pytest.raises(ValueError, match="unknown alert names"):
        ScenarioSpec(name="x", alerts={"expect": ["no_such_alert"]})
    with pytest.raises(ValueError, match="requires backend 'jax'|backend 'jax'"):
        ScenarioSpec(name="x", mesh={"data": 2})


def test_every_reference_cell_parses_and_round_trips():
    """Every preset and random cell of the reference, as JSON, is a port
    spec with the same dict (the repro contract across packages)."""
    specs = list(ref_presets.PRESETS.values()) + [ref_presets.random_cell(i, s)
                                                  for s in (0, 1, 2) for i in range(4)]
    for ref in specs:
        d = json.loads(json.dumps(ref.to_dict()))
        port = ScenarioSpec.from_dict(d)
        assert port.to_dict() == d == RefSpec.from_dict(d).to_dict(), ref.name


def test_random_cells_deterministic():
    a, b = random_cell(0, SEED), random_cell(0, SEED)
    assert a.to_dict() == b.to_dict()
    assert random_cell(1, SEED).to_dict() != a.to_dict()


def test_ci_smoke_suite_shape():
    cells = suite_cells("ci-smoke", SEED)
    assert len(cells) >= 12
    names = {c.name for c in cells}
    assert {"chaos-kill", "rack-partition", "storage-ec", "serve-chaos",
            "integrity-scrub"} <= names
    assert any(c.resume_window is not None for c in cells)
    assert len(names) == len(cells)


@pytest.mark.parametrize("suite", ["ci-smoke", "full"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suite_cells_equal_the_reference(suite, seed):
    got = suite_cells(suite, seed)
    want = ref_presets.suite_cells(suite, seed)
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
    assert [getattr(c, "_preset", None) for c in got] == \
        [getattr(c, "_preset", None) for c in want]


# -- unported axes ------------------------------------------------------------------

@pytest.mark.parametrize("axis,kw,item", [
    ("mesh", {"storage": "replicate", "mesh": {"data": 2}, "backend": "jax"}, "A9"),
    ("mesh", {"mesh": {"data": 2}, "backend": "jax"}, "A9"),
])
def test_unported_axis_is_refused_before_anything_runs(axis, kw, item):
    """Named for the refusal these mesh cells met until ROADMAP A9 landed:
    they now run, on a mesh of shards, and the mesh engages."""
    spec = _tiny(name=f"needs-{axis}", **kw)
    cell = _run(spec)
    assert cell["invariants"]["mesh_engaged"]
    assert cell["ok"], cell["invariants"]


@pytest.mark.parametrize("axis,kw", [
    ("placement", {"placement": "materialized_hash"}),
    ("elastic", {"serve": {"policy": "p2c"}, "placement": "functional",
                 "elastic": {"pool": ["sb1"]}}),
    ("placement", {"placement": "functional", "faults": {"specs": ["crash:dn2@2-4"]}}),
])
def test_placement_and_elastic_axes_run(axis, kw):
    """The placement and elastic axes (ROADMAP A8f) are ported: the cell runs
    and its placement stamp engages."""
    spec = _tiny(name=f"runs-{axis}", **kw)
    cell = _run(spec)
    assert cell["invariants"]["functional_engaged"]
    assert ("elastic_engaged" in cell["invariants"]) == (axis == "elastic")


def test_sweep_lists_unported_cells_and_runs_the_rest():
    cells = [_tiny(name="s1", faults={"specs": ["crash:dn2@2-4"]}),
             _tiny(name="s2", seed=SEED + 1),
             _tiny(name="s3", serve={"policy": "p2c"}),
             _tiny(name="s4", storage="replicate", placement="functional"),
             _tiny(name="s5", mesh={"data": 2}, backend="jax")]
    lines = []
    out = run_cells(cells, device="cpu", progress=lines.append)
    assert out["ok"] and out["n_cells"] == 5 and out["n_failed"] == 0
    assert [c["cell"] for c in out["cells"]] == ["s1", "s2", "s3", "s4", "s5"]
    assert out["cells"][3]["invariants"]["functional_engaged"]
    assert out["cells"][4]["invariants"]["mesh_engaged"]
    # The reference's artifact, key for key (no list of cells left out).
    want = ref_sweep.run_cells([], suite=None)
    assert set(out) == set(want)
    assert out["invariants_checked"] == sum(len(c["invariants"]) for c in out["cells"])
    assert {r["metric"] for r in out["bench_records"]} == \
        {"scenario_s1_churn_bytes", "scenario_s2_churn_bytes", "scenario_s3_churn_bytes",
         "scenario_s3_p99_ms", "scenario_s4_churn_bytes", "scenario_s5_churn_bytes"}
    assert len(lines) == 5 and all(line.startswith("  [ok  ]") for line in lines)


# -- fault templates ----------------------------------------------------------------

def test_cascade_template():
    s = FaultSchedule.cascade(["dn1", "dn2"], start=3, spacing=2, recover_after=3)
    assert [e.spec() for e in s] == ["crash:dn1@3", "crash:dn2@5", "recover:dn1@6",
                                     "recover:dn2@8"]
    assert [e.spec() for e in FaultSchedule.cascade(["dn1"], start=0)] == ["crash:dn1@0"]
    with pytest.raises(ValueError, match="spacing"):
        FaultSchedule.cascade(["dn1"], start=0, spacing=0)


def test_rolling_decommission_template():
    s = FaultSchedule.rolling_decommission(["dn2", "dn3"], start=4, spacing=4)
    assert [e.spec() for e in s] == ["decommission:dn2@4", "decommission:dn3@8"]


# -- harness invariants ---------------------------------------------------------------

def test_run_cell_green_and_records():
    cell = _run(_tiny(faults={"specs": ["crash:dn2@2-4"]}))
    assert cell["ok"], cell["invariants"]
    assert {"zero_lost_final", "budget_conserved", "faults_engaged"} <= set(cell["invariants"])
    assert {r["metric"] for r in cell["bench_records"]} == {"scenario_tiny_churn_bytes"}
    assert cell["repro"].startswith("python -m cdrs_tpu_torch scenarios run")
    assert len(cell["fingerprint"]) == 64 and "inv:faults_engaged" in cell["coverage"]


def test_invariant_failure_detected_with_repro():
    """Decommissions outrunning a starved repair budget lose data: the cell
    goes red with a repro line."""
    cell = _run(_tiny(name="doomed",
                      faults={"template": "rolling_decommission", "nodes": ["dn2", "dn3"],
                              "start": 1, "spacing": 1},
                      budget_frac=0.0001))
    assert not cell["invariants"]["zero_lost_final"]
    assert not cell["ok"]
    assert "scenarios run" in cell["repro"]


def test_engagement_invariants_catch_vacuous_cells():
    """A fault past the horizon fails ``faults_engaged``; engaged axes
    report their engagement alongside the negative checks."""
    cell = _run(_tiny(name="vacuous", faults={"specs": ["crash:dn2@100"]}))
    assert cell["invariants"]["faults_engaged"] is False
    assert not cell["ok"]
    live = _run(_tiny(name="live", faults={"specs": ["corrupt:dn2@2:0.5", "crash:dn3@2-4"]}))
    assert live["invariants"]["faults_engaged"]
    assert live["invariants"]["corruption_engaged"]
    assert live["ok"], live["invariants"]


def test_resume_bit_identity_sampled():
    cell = _run(_tiny(name="resume", faults={"specs": ["crash:dn2@2-5"]}, resume_window=3))
    assert cell["invariants"]["resume_bit_identical"]
    assert cell["ok"], cell["invariants"]


def test_budget_conservation_under_scrub_and_repair():
    """Repair, migration and scrub share one budget; the invariant holds
    with all three active at once."""
    cell = _run(_tiny(name="shared-budget", duration=720.0, n_windows=12,
                      faults={"specs": ["corrupt:dn2@2:0.5", "crash:dn3@3-5"]},
                      scrub=50_000_000, budget_frac=0.5))
    assert cell["invariants"]["budget_conserved"]
    assert cell["invariants"]["zero_silent_loss"]
    assert cell["ok"], cell["invariants"]


def test_presets_build_their_inputs():
    """Every preset whose axes are ported builds its manifest, events,
    schedule and controller at a small size."""
    for name, spec in PRESETS.items():
        small = spec.replace(n_files=min(spec.n_files, 60), k=4)
        manifest = generate_population(GeneratorConfig(n_files=small.n_files, seed=small.seed,
                                                       nodes=small.nodes))
        events, _ = build_events(small, manifest)
        assert len(events) > 0 and np.all(np.diff(events.ts) >= 0), name
        ctl = _controller(small, manifest, build_schedule(small), "cpu")
        assert ctl.cfg.window_seconds == small.window_seconds, name


# -- seeds and repro lines ------------------------------------------------------------

def test_suite_seed_shifts_preset_workloads():
    base = {c.name: c for c in suite_cells("ci-smoke", 0)}
    shifted = {c.name: c for c in suite_cells("ci-smoke", 5)}
    for name, sp in base.items():
        if name.startswith("random-"):
            continue
        assert shifted[name].seed == sp.seed + 5
        assert getattr(shifted[name], "_preset", None) == getattr(sp, "_preset", None)


def test_suite_repro_carries_seed_and_random_names_encode_it():
    spec = random_cell(1, 7)
    assert spec.name == "random-s7-1"
    line = repro_line(spec, suite="ci-smoke", suite_seed=7)
    assert "--seed 7" in line and line.endswith("--cell random-s7-1")
    cells = {c.name for c in suite_cells("ci-smoke", 7)}
    assert "random-s7-1" in cells and "random-s0-1" not in cells
    assert repro_line(preset("cascade")) == \
        "python -m cdrs_tpu_torch scenarios run --preset cascade"


def test_spec_repro_line_roundtrips():
    spec = _tiny(name="rt", faults={"specs": ["crash:dn2@2-3"]})
    payload = repro_line(spec).split("--spec ", 1)[1].strip("'")
    assert ScenarioSpec.from_dict(json.loads(payload)).to_dict() == spec.to_dict()


# -- CLI --------------------------------------------------------------------------------

def test_cli_scenarios_list(capsys):
    assert port_cli.main(["scenarios", "list"]) == 0
    out = capsys.readouterr().out
    assert "control-shift" in out and "ci-smoke" in out
    assert all(name in out for name in PRESETS)
    lines = {ln.split()[0]: ln for ln in out.splitlines() if ln.startswith("  ")}
    assert "mesh" in lines["scale-mesh"] and "mesh" not in lines["black-friday"]
    assert "elastic" in lines["black-friday"] and "placement=functional" in lines["region-loss"]
    assert "faults" in lines["chaos-kill"] and "storage=ec_archival" in lines["storage-ec"]
    assert "serve=p2c" in lines["serve-chaos"]


def test_cli_scenarios_run_spec_and_errors(tmp_path, capsys, monkeypatch):
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(_tiny(name="cli-cell").to_dict()))
    assert port_cli.main(["scenarios", "run", "--spec", str(path), "--device", "cpu"]) == 0
    cell = json.loads(capsys.readouterr().out)
    assert cell["cell"] == "cli-cell" and cell["ok"]
    assert port_cli.main(["scenarios", "run", "--device", "cpu"]) == 2
    assert port_cli.main(["scenarios", "run", "--cell", "nope", "--device", "cpu"]) == 2
    assert port_cli.main(["scenarios", "run", "--preset", "nope", "--device", "cpu"]) == 2
    assert port_cli.main(["scenarios", "run", "--preset", "cascade", "--seed", "1",
                          "--device", "cpu"]) == 2
    capsys.readouterr()
    # The mesh preset, refused until ROADMAP A9 landed, runs green.
    assert port_cli.main(["scenarios", "run", "--preset", "scale-mesh", "--device",
                          "cpu"]) == 0
    cell = json.loads(capsys.readouterr().out)
    assert cell["cell"] == "scale-mesh" and cell["ok"] and cell["invariants"]["mesh_engaged"]
    # search and triage run on a tiny budget over a temporary corpus.
    corpus = tmp_path / "corpus"
    (corpus / "violations").mkdir(parents=True)
    banked = json.loads((Path(__file__).resolve().parent.parent / "data" / "search_corpus"
                         / "violations" / "search-s0-11fcf7ee-bad.json").read_text())
    (corpus / "violations" / "search-s0-11fcf7ee-bad.json").write_text(json.dumps(banked))
    assert port_cli.main(["scenarios", "search", "--seed", "0", "--budget-cells", "1",
                          "--base", "cascade", "--corpus", str(corpus), "--device",
                          "cpu"]) == 0
    digest = json.loads(capsys.readouterr().out)
    assert {"seed", "budget_cells", "iterations", "cells_run", "baseline_bits",
            "coverage_bits", "new_coverage_cells", "fingerprint", "seconds",
            "violations"} == set(digest)
    assert digest["iterations"] == 1 and digest["baseline_bits"] > 0
    assert port_cli.main(["scenarios", "triage", "--corpus", str(corpus), "--device",
                          "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"names", "n_violations", "ok", "seconds"}
    assert out["names"] == ["triage-s0-11fcf7ee-bad"] and out["ok"]
    # sweep --round appends the cells' records to --history, deduped: a
    # second run appends none.  Two tiny cells stand in for the suite.
    from cdrs_tpu_torch.scenarios import sweep as port_sweep

    monkeypatch.setattr(port_sweep, "suite_cells",
                        lambda suite, seed=0: [_tiny(name="hist-a"),
                                               _tiny(name="hist-b", serve={"policy": "p2c"})])
    hist = tmp_path / "h.jsonl"
    argv = ["scenarios", "sweep", "--round", "3", "--history", str(hist), "--device", "cpu"]
    assert port_cli.main(argv) == 0
    digest = json.loads(capsys.readouterr().out)
    rows = [json.loads(line) for line in hist.read_text().splitlines()]
    assert digest["round"] == 3 and digest["history_appended"] == len(rows) == 3
    assert {r["metric"] for r in rows} == {"scenario_hist-a_churn_bytes",
                                           "scenario_hist-b_churn_bytes",
                                           "scenario_hist-b_p99_ms"}
    assert all(r["round"] == 3 and r["platform"] == "torch-cpu" for r in rows)
    assert port_cli.main(argv) == 0
    assert json.loads(capsys.readouterr().out)["history_appended"] == 0
    assert [json.loads(line) for line in hist.read_text().splitlines()] == rows
    assert port_cli.main(argv[:-2] + ["--seed", "1", "--device", "cpu"]) == 2


def test_cli_scenarios_run_suite_cell(capsys):
    rc = port_cli.main(["scenarios", "run", "--suite", "ci-smoke", "--cell", "cascade",
                        "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["cell"] == "cascade" and out["ok"]
    assert out["repro"].endswith("--seed 0 --cell cascade")


def test_cli_scenarios_sweep_extra_cells(tmp_path, capsys):
    """``sweep --extra_cells``: the corpus cells ride along with the suite
    and are run, the artifact and the cell events written."""
    extra = tmp_path / "extra.json"
    extra.write_text(json.dumps({"cells": [_tiny(name="x").to_dict(),
                                           _tiny(name="y", serve={"policy": "p2c"}).to_dict()],
                                 "names": ["corpus-a", "corpus-b"]}))
    out_path, metrics = tmp_path / "sw.json", tmp_path / "cells.jsonl"
    rc = port_cli.main(["scenarios", "sweep", "--suite", "ci-smoke", "--extra_cells",
                        str(extra), "--out", str(out_path), "--metrics", str(metrics),
                        "--device", "cpu"])
    captured = capsys.readouterr()
    digest = json.loads(captured.out)
    assert rc == 0 and digest["ok"] and digest["n_failed"] == 0
    art = json.loads(out_path.read_text())
    ran = [c["cell"] for c in art["cells"]]
    assert ran[-2:] == ["corpus-a", "corpus-b"] and digest["n_cells"] == len(ran) == 24
    assert {"storage-ec", "scale-placement", "region-loss", "wan-partition",
            "black-friday", "scale-mesh"} <= set(ran)
    assert set(digest) == {"suite", "seed", "n_cells", "n_failed", "invariants_checked",
                           "ok", "seconds"}
    assert captured.err.count("[ok  ]") == len(ran) and "[FAIL]" not in captured.err
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [e["cell"] for e in events if e.get("kind") == "cell"] == ran


# -- workload curves -----------------------------------------------------------------

def _assert_logs_equal(got, want):
    for key in ("ts", "path_id", "op", "client_id"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert got.clients == want.clients


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_workload_curves_are_bit_identical_to_the_reference(seed):
    m = generate_population(GeneratorConfig(n_files=300, seed=seed))
    rm = ref_generate(jcfg.GeneratorConfig(n_files=300, seed=seed))
    cfg = SimulatorConfig(duration_seconds=1800.0, seed=seed + 1)
    rcfg = jcfg.SimulatorConfig(duration_seconds=1800.0, seed=seed + 1)
    flip = {"hot": "archival", "archival": "hot"}
    _assert_logs_equal(access.simulate_access(m, cfg), ref_access.simulate_access(rm, rcfg))
    _assert_logs_equal(access.simulate_diurnal(m, cfg, amplitude=0.7, phase=1.0),
                       ref_access.simulate_diurnal(rm, rcfg, amplitude=0.7, phase=1.0))
    # amplitude 0 is the flat stream.
    _assert_logs_equal(access.simulate_diurnal(m, cfg, amplitude=0.0),
                       access.simulate_access(m, cfg))
    cohort = np.arange(len(m)) % 3 == 0
    shifts = [(400.0, flip, None), (900.0, flip, cohort), (1500.0, flip, None)]
    (ev, ch), (rev, rch) = (access.simulate_access_phased(m, cfg, shifts),
                            ref_access.simulate_access_phased(rm, rcfg, shifts))
    _assert_logs_equal(ev, rev)
    assert np.array_equal(ch, rch)
    crowd = np.asarray([c == "archival" for c in m.category])
    (ev, cm), (rev, _) = (
        access.simulate_flash_crowd(m, cfg, cohort=crowd, start=900.0, duration=180.0,
                                    boost=40.0),
        ref_access.simulate_flash_crowd(rm, rcfg, cohort=crowd, start=900.0,
                                        duration=180.0, boost=40.0))
    _assert_logs_equal(ev, rev)
    assert np.array_equal(cm, crowd)
    (ev, ch), (rev, rch) = (access.simulate_access_with_shift(m, cfg, 700.0, flip),
                            ref_access.simulate_access_with_shift(rm, rcfg, 700.0, flip))
    _assert_logs_equal(ev, rev)
    assert np.array_equal(ch, rch)


def test_workload_curve_errors():
    m = generate_population(GeneratorConfig(n_files=50, seed=0))
    cfg = SimulatorConfig(duration_seconds=100.0, seed=1)
    with pytest.raises(ValueError, match="amplitude"):
        access.simulate_diurnal(m, cfg, amplitude=1.0)
    with pytest.raises(ValueError, match="strictly increasing"):
        access.simulate_access_phased(m, cfg, [(50.0, {"hot": "archival"}, None),
                                               (40.0, {"hot": "archival"}, None)])
    with pytest.raises(ValueError, match="rate profile"):
        access.simulate_access_phased(m, cfg, [(50.0, {"hot": "lava"}, None)])
    with pytest.raises(ValueError, match="fit inside"):
        access.simulate_flash_crowd(m, cfg, cohort=np.ones(50, bool), start=90.0,
                                    duration=20.0, boost=2.0)
