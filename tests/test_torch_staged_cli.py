"""The staged batch commands of the port against ``cdrs_tpu``'s:
``gen -> simulate -> features -> cluster -> evaluate`` at 300 files over
300 s, each through ``cdrs_tpu_torch.cli.main([... "--device", "cpu"])``
and through ``cdrs_tpu.cli.main``.

* ``features``: the integer columns equal the numpy backend's, the float
  raw columns within a relative 1e-6 (the port's table is float32) and the
  normalized columns within 1e-6.
* ``cluster`` on the same features CSV, both sides from the reference's D²
  init of the float32 matrix (``carried_init``): categories, labels and
  per-file rf exact (``assignments.csv`` byte-identical), centroids within
  1e-5.
* ``evaluate`` on the same assignments: the JSON equal, ``--emit_plan`` and
  ``--emit_setrep`` files byte-identical, the same lines for unmatched
  rows.
* ``pipeline --evaluate``: the ``evaluation`` equal to the reference's
  from a carried init.
* ``--mesh``, ``--metrics`` and ``--profile``, once refused, run and
  change nothing the command writes besides their own output.
* The counterparts of ``tests/test_plan.py``, each also held to the
  reference's functions.
"""

import csv
import dataclasses
import json
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.cluster.plan as ref_plan  # noqa: E402
import cdrs_tpu.config as jcfg  # noqa: E402
import cdrs_tpu.models.replication as ref_models  # noqa: E402
from cdrs_tpu.cli import main as reference_main  # noqa: E402
from cdrs_tpu.features.jax_backend import compute_features_jax  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402
from cdrs_tpu.pipeline import run_pipeline as run_reference  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as jsimulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as jgenerate  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402

from cdrs_tpu_torch import (GeneratorConfig, KMeansConfig, PipelineConfig,  # noqa: E402
                            SimulatorConfig, run_pipeline, validated_scoring_config)
from cdrs_tpu_torch.cli import build_parser  # noqa: E402
from cdrs_tpu_torch.cli import main as port_main  # noqa: E402
from cdrs_tpu_torch.cluster.plan import (PlanEntry, build_plan, read_plan_csv,  # noqa: E402
                                         write_plan_csv, write_setrep_script)
from cdrs_tpu_torch.config import ScoringConfig  # noqa: E402
from cdrs_tpu_torch.io.features import load_feature_matrix  # noqa: E402

N, DURATION, K, SEED = 300, 300, 4, 3
INT_COLUMNS = ("access_freq", "concurrency")
RAW_FLOAT_COLUMNS = ("age_seconds", "write_ratio", "locality")
NORM_COLUMNS = ("access_freq_norm", "age_norm", "write_ratio_norm", "locality_norm",
                "concurrency_norm")


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _columns(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {key: [r[key] for r in rows] for key in rows[0]}


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """The manifest, the CSV log and both sides' features directories."""
    d = tmp_path_factory.mktemp("staged")
    m, log = str(d / "m.csv"), str(d / "a.log")
    assert port_main(["gen", "--n", str(N), "--seed", "7", "--out_manifest", m]) == 0
    assert port_main(["simulate", "--manifest", m, "--out", log, "--duration_seconds",
                      str(DURATION), "--seed", "8"]) == 0
    assert port_main(["features", "--manifest", m, "--access_log", log,
                      "--out", str(d / "port_features") + "/", "--device", "cpu"]) == 0
    assert reference_main(["features", "--manifest", m, "--access_log", log,
                           "--out", str(d / "ref_features") + "/"]) == 0
    return d


def _assert_features_match(got_path, want_path):
    got, want = _columns(got_path), _columns(want_path)
    assert list(got) == list(want)
    assert got["path"] == want["path"] and len(got["path"]) == N
    for key in INT_COLUMNS:
        np.testing.assert_array_equal(np.asarray(got[key], float), np.asarray(want[key], float))
    for key in RAW_FLOAT_COLUMNS:
        np.testing.assert_allclose(np.asarray(got[key], float), np.asarray(want[key], float),
                                   rtol=1e-6)
    for key in NORM_COLUMNS:
        np.testing.assert_allclose(np.asarray(got[key], float), np.asarray(want[key], float),
                                   atol=1e-6)


def test_features_match_the_numpy_backend(staged):
    got = staged / "port_features" / "part-00000-features.csv"
    _assert_features_match(got, staged / "ref_features" / "part-00000-features.csv")
    X, paths = load_feature_matrix(str(staged / "port_features"))
    assert X.shape == (N, 5) and X.dtype == np.float64
    assert paths == _columns(got)["path"]
    np.testing.assert_array_equal(X[:, 0], np.asarray(_columns(got)["access_freq_norm"], float))


def test_features_reads_the_binary_log(staged, tmp_path):
    log = str(tmp_path / "a.cdrsb")
    assert port_main(["simulate", "--manifest", str(staged / "m.csv"), "--out", log,
                      "--duration_seconds", str(DURATION), "--seed", "8"]) == 0
    out = str(tmp_path / "f.csv")
    assert port_main(["features", "--manifest", str(staged / "m.csv"), "--access_log", log,
                      "--out", out, "--device", "cpu"]) == 0
    assert reference_main(["features", "--manifest", str(staged / "m.csv"), "--access_log",
                           log, "--out", str(tmp_path / "ref.csv")]) == 0
    _assert_features_match(out, tmp_path / "ref.csv")


@pytest.fixture(scope="module")
def clustered(staged):
    """``cluster`` of the reference's features CSV through both CLIs, from
    the reference's D² init of the float32 matrix."""
    X, _ = load_feature_matrix(str(staged / "ref_features"))
    init = np.asarray(kmeans_jax_full(X.astype(np.float32), K, seed=SEED, max_iter=0,
                                      tol=0.0)[0])
    args = ["--input_path", str(staged / "ref_features"), "--k", str(K), "--seed", str(SEED),
            "--medians_from_data", "--scoring_config", "validated"]
    with carried_init():
        assert port_main(["cluster", *args, "--output_csv", str(staged / "port_cats.csv"),
                          "--assignments_csv", str(staged / "port_assign.csv"),
                          "--device", "cpu"]) == 0
    run = ref_models.ReplicationPolicyModel.run

    def from_init(self, X, feature_names=None, init_centroids=None):
        return run(self, X, feature_names, init_centroids=init)

    ref_models.ReplicationPolicyModel.run = from_init
    try:
        assert reference_main(["cluster", *args, "--backend", "jax",
                               "--output_csv", str(staged / "ref_cats.csv"),
                               "--assignments_csv", str(staged / "ref_assign.csv")]) == 0
    finally:
        ref_models.ReplicationPolicyModel.run = run
    return staged


def test_cluster_matches_the_reference_from_its_init(clustered):
    d = clustered
    # Labels, categories and (through the category) every file's rf.
    assert (d / "port_assign.csv").read_bytes() == (d / "ref_assign.csv").read_bytes()
    got, want = _columns(d / "port_cats.csv"), _columns(d / "ref_cats.csv")
    assert list(got) == list(want) and got["category"] == want["category"]
    for key in NORM_COLUMNS:
        np.testing.assert_allclose(np.asarray(got[key], float), np.asarray(want[key], float),
                                   atol=1e-5)
    rf = validated_scoring_config().replication_factors
    assigned = _columns(d / "port_assign.csv")
    assert len(assigned["path"]) == N
    assert {rf[c] for c in assigned["category"]} <= set(rf.values())


def test_cluster_float64_keeps_the_csv_values(staged):
    """``cluster --dtype float64`` clusters the features CSV's float64
    values, as the reference does with X64 on: from the same float64 init,
    labels exact and centroids within 1e-12 (a float32 cast of the table
    would move them by about 1e-8)."""
    d = staged
    X, _ = load_feature_matrix(str(d / "ref_features"))
    init = np.asarray(kmeans_jax_full(X, K, seed=SEED, max_iter=0, tol=0.0)[0])
    assert init.dtype == np.float64
    args = ["--input_path", str(d / "ref_features"), "--k", str(K), "--seed", str(SEED),
            "--scoring_config", "validated", "--dtype", "float64"]
    with carried_init():
        assert port_main(["cluster", *args, "--output_csv", str(d / "port_cats64.csv"),
                          "--assignments_csv", str(d / "port_assign64.csv"),
                          "--device", "cpu"]) == 0
    run = ref_models.ReplicationPolicyModel.run

    def from_init(self, X, feature_names=None, init_centroids=None):
        return run(self, X, feature_names, init_centroids=init)

    ref_models.ReplicationPolicyModel.run = from_init
    try:
        assert reference_main(["cluster", *args, "--backend", "jax",
                               "--output_csv", str(d / "ref_cats64.csv"),
                               "--assignments_csv", str(d / "ref_assign64.csv")]) == 0
    finally:
        ref_models.ReplicationPolicyModel.run = run
    assert (d / "port_assign64.csv").read_bytes() == (d / "ref_assign64.csv").read_bytes()
    got, want = _columns(d / "port_cats64.csv"), _columns(d / "ref_cats64.csv")
    assert list(got) == list(want) and got["category"] == want["category"]
    for key in NORM_COLUMNS:
        np.testing.assert_allclose(np.asarray(got[key], float), np.asarray(want[key], float),
                                   rtol=0, atol=1e-12)


def test_pipeline_float64_clusters_float64_features(tmp_path, capsys):
    """``pipeline --dtype float64`` computes the features in float64 too, so
    its decision is ``run_pipeline``'s with a float64 feature table."""
    argv = ["pipeline", "--n", str(N), "--k", str(K), "--seed", str(SEED),
            "--duration_seconds", "120", "--dtype", "float64", "--device", "cpu",
            "--outdir", str(tmp_path)]
    rc, out, err = _run(port_main, argv, capsys)
    assert rc == 0, err
    cfg = PipelineConfig(
        device="cpu", dtype="float64", generator=GeneratorConfig(n_files=N, seed=SEED),
        simulator=SimulatorConfig(duration_seconds=120, seed=SEED + 1),
        kmeans=KMeansConfig(k=K, seed=SEED, dtype="float64"))
    want = run_pipeline(cfg)
    assert json.loads(out)["categories"] == want.summary()["categories"]
    got = _columns(tmp_path / "final_categories.csv")
    centroids = np.stack([np.asarray(got[key], float) for key in NORM_COLUMNS], axis=1)
    assert want.decision.centroids.dtype == np.float64
    np.testing.assert_array_equal(centroids, want.decision.centroids)
    # The float32 feature table clusters to other centroids.
    f32 = run_pipeline(dataclasses.replace(cfg, dtype="float32"))
    assert np.abs(f32.decision.centroids - want.decision.centroids).max() > 1e-12


def test_evaluate_and_its_plan_files_match_the_reference(clustered, capsys):
    d = clustered
    outputs = {}
    for side, main in (("port", port_main), ("ref", reference_main)):
        rc, out, err = _run(main, [
            "evaluate", "--manifest", str(d / "m.csv"), "--access_log", str(d / "a.log"),
            "--assignments_csv", str(d / "port_assign.csv"), "--scoring_config", "validated",
            "--emit_plan", str(d / f"{side}_plan.csv"),
            "--emit_setrep", str(d / f"{side}_apply.sh")], capsys)
        assert rc == 0, err
        outputs[side] = (json.loads(out), err.replace(f"{side}_", ""))
    assert outputs["port"] == outputs["ref"]
    assert set(outputs["port"][0]) == {"uniform_1", "uniform_3", "policy"}
    for name in ("plan.csv", "apply.sh"):
        assert (d / f"port_{name}").read_bytes() == (d / f"ref_{name}").read_bytes(), name
    subprocess.run(["sh", "-n", str(d / "port_apply.sh")], check=True)


def test_evaluate_reports_unmatched_rows_as_the_reference_does(clustered, tmp_path, capsys):
    d = clustered
    rows = (d / "port_assign.csv").read_text().splitlines()
    partial, none = tmp_path / "partial.csv", tmp_path / "none.csv"
    partial.write_text("\n".join(rows + ["/no/such/file,0,Hot", rows[1].rsplit(",", 1)[0]
                                         + ",Sizzling"]) + "\n")
    none.write_text("path,cluster,category\n/no/such/file,0,Hot\n")
    for path, want_rc in ((partial, 0), (none, 1)):
        got = []
        for main in (port_main, reference_main):
            rc, out, err = _run(main, ["evaluate", "--manifest", str(d / "m.csv"),
                                       "--access_log", str(d / "a.log"),
                                       "--assignments_csv", str(path)], capsys)
            got.append((rc, json.loads(out) if out else None, err))
        assert got[0] == got[1]
        assert got[0][0] == want_rc
        assert ("warning: 2/" in got[0][2]) if want_rc == 0 else ("error: no row" in got[0][2])


def test_pipeline_evaluate_matches_the_reference_from_its_init(tmp_path):
    ref_cfg = jcfg.PipelineConfig(
        backend="jax", generator=jcfg.GeneratorConfig(n_files=N, seed=SEED),
        simulator=jcfg.SimulatorConfig(duration_seconds=DURATION, seed=SEED + 1),
        kmeans=jcfg.KMeansConfig(k=K, seed=SEED), scoring=jcfg.validated_scoring_config(),
        evaluate=True)
    ref = run_reference(ref_cfg)
    manifest = jgenerate(ref_cfg.generator)
    norm = compute_features_jax(manifest, jsimulate(manifest, ref_cfg.simulator)).norm
    init = np.asarray(kmeans_jax_full(norm, K, seed=SEED, max_iter=0, tol=0.0)[0])
    cfg = PipelineConfig(
        device="cpu", dtype="float64", generator=GeneratorConfig(n_files=N, seed=SEED),
        simulator=SimulatorConfig(duration_seconds=DURATION, seed=SEED + 1),
        kmeans=KMeansConfig(k=K, seed=SEED), scoring=validated_scoring_config(), evaluate=True)
    got = run_pipeline(cfg, init_centroids=init)
    np.testing.assert_array_equal(got.decision.labels, np.asarray(ref.decision.labels))
    assert got.evaluation == ref.evaluation
    assert got.summary()["evaluation"] == ref.summary()["evaluation"]
    assert "evaluate.seconds" in got.metrics.records


def test_pipeline_cli_evaluate_prints_what_run_pipeline_gives(tmp_path, capsys):
    rc, out, err = _run(port_main, [
        "pipeline", "--n", str(N), "--k", str(K), "--seed", str(SEED), "--duration_seconds",
        "120", "--scoring_config", "validated", "--evaluate", "--device", "cpu",
        "--outdir", str(tmp_path / "cli")], capsys)
    assert rc == 0, err
    cfg = PipelineConfig(
        device="cpu", generator=GeneratorConfig(n_files=N, seed=SEED),
        simulator=SimulatorConfig(duration_seconds=120, seed=SEED + 1),
        kmeans=KMeansConfig(k=K, seed=SEED), scoring=validated_scoring_config(), evaluate=True)
    assert json.loads(out)["evaluation"] == run_pipeline(cfg).evaluation
    rc, out, _ = _run(port_main, ["pipeline", "--n", "50", "--device", "cpu",
                                  "--outdir", str(tmp_path / "no")], capsys)
    assert rc == 0 and "evaluation" not in json.loads(out)


@pytest.mark.parametrize("argv,flag,writes", [
    (["features", "--manifest", "m.csv", "--access_log", "a.log", "--mesh", "8"], "--mesh",
     None),
    (["cluster", "--input_path", "f/", "--mesh", "data=2"], "--mesh", None),
    (["cluster", "--input_path", "f/", "--metrics", "t.jsonl"], "--metrics", "t.jsonl"),
    (["pipeline", "--n", "50", "--mesh", "2"], "--mesh", None),
    (["pipeline", "--n", "50", "--metrics", "t.jsonl"], "--metrics", "t.jsonl"),
    (["pipeline", "--n", "50", "--profile", "prof"], "--profile", "prof/trace.json"),
])
def test_unported_flags_are_refused_by_name(argv, flag, writes, tmp_path, capsys,
                                            monkeypatch):
    """The flags that were refused while their modules were not ported now
    run: ``--mesh`` since the mesh (ROADMAP A9), ``--metrics`` and
    ``--profile`` since telemetry (ROADMAP A10b).  The command writes what
    it writes without the flag, and the flag's stream or profile besides
    (``writes``): a stream with the command's root span and its kernel
    calls, or a Chrome trace."""
    monkeypatch.chdir(tmp_path)
    for pre in (["gen", "--n", "120", "--seed", "7", "--out_manifest", "m.csv"],
                ["simulate", "--manifest", "m.csv", "--out", "a.log",
                 "--duration_seconds", "60", "--seed", "8"],
                ["features", "--manifest", "m.csv", "--access_log", "a.log", "--out",
                 "f/", "--device", "cpu"]):
        assert _run(port_main, pre, capsys)[0] == 0
    outputs = {"features": "features_out/part-00000-features.csv",
               "cluster": "final_categories.csv"}
    i = argv.index(flag)
    plain = argv[:i] + argv[i + 2:]
    runs = []
    for args in (plain, argv):
        rc, out, err = _run(port_main, [*args, "--device", "cpu"], capsys)
        assert rc == 0, err
        if argv[0] == "pipeline":
            summary = json.loads(out)
            runs.append((summary["categories"], summary["planted_accuracy"]))
        else:
            runs.append((tmp_path / outputs[argv[0]]).read_text())
    if argv[0] == "cluster" and flag == "--mesh":
        # Categories exact; centroids within 1e-5 (float32 sums added in
        # another order), so their full-precision columns may differ.
        (head0, *rows0), (head1, *rows1) = (list(csv.reader(r.splitlines())) for r in runs)
        assert head0 == head1 and [r[1] for r in rows0] == [r[1] for r in rows1]
        np.testing.assert_allclose(np.asarray([r[2:] for r in rows0], float),
                                   np.asarray([r[2:] for r in rows1], float), atol=1e-5)
    else:
        assert runs[0] == runs[1]
    if writes is None:
        return
    if flag == "--profile":
        assert json.loads((tmp_path / writes).read_text())["traceEvents"]
        return
    from cdrs_tpu_torch.obs import read_events

    events = read_events(str(tmp_path / writes))
    roots = [e for e in events if e["kind"] == "span" and e["parent"] is None]
    assert [r["name"] for r in roots] == [{"cluster": "cluster_cmd"}.get(argv[0], argv[0])]
    calls = {e["name"]: e["value"] for e in events if e["kind"] == "counter"}
    assert calls["kernel.calls.kmeans_full"] == 1 and calls["kernel.calls.classify"] == 1
    assert calls["kernel.calls.lloyd_assign_reduce"] >= 2


# -- the counterparts of tests/test_plan.py ----------------------------------

def _ref_entries(entries):
    return [ref_plan.PlanEntry(e.path, e.category, e.rf) for e in entries]


def test_build_plan_uses_config_rf_table():
    cfg = ScoringConfig()
    entries = build_plan(["/a", "/b"], ["Hot", "Archival"], cfg)
    assert entries == [PlanEntry("/a", "Hot", cfg.replication_factors["Hot"]),
                       PlanEntry("/b", "Archival", cfg.replication_factors["Archival"])]
    assert _ref_entries(entries) == ref_plan.build_plan(["/a", "/b"], ["Hot", "Archival"],
                                                        jcfg.ScoringConfig())


def test_build_plan_rejects_unknown_category():
    with pytest.raises(ValueError, match="Sizzling") as got:
        build_plan(["/a"], ["Sizzling"], ScoringConfig())
    with pytest.raises(ValueError) as want:
        ref_plan.build_plan(["/a"], ["Sizzling"], jcfg.ScoringConfig())
    assert str(got.value) == str(want.value)


def test_build_plan_explicit_rf_overrides_table():
    entries = build_plan(["/a", "/b"], ["Hot", "Hot"], rf=np.array([5, 1]))
    assert [e.rf for e in entries] == [5, 1]
    assert _ref_entries(entries) == ref_plan.build_plan(["/a", "/b"], ["Hot", "Hot"],
                                                        rf=np.array([5, 1]))


def test_plan_csv_round_trip(tmp_path):
    paths = [f"/data/file_{i:04d}.bin" for i in range(50)]
    cats = ["Hot", "Moderate", "Shared", "Archival"] * 12 + ["Hot", "Shared"]
    entries = build_plan(paths, cats, ScoringConfig())
    p, r = tmp_path / "plan.csv", tmp_path / "ref.csv"
    write_plan_csv(str(p), entries)
    assert read_plan_csv(str(p)) == entries
    ref_plan.write_plan_csv(str(r), ref_plan.build_plan(paths, cats, jcfg.ScoringConfig()))
    assert p.read_bytes() == r.read_bytes()


def test_setrep_script_groups_by_rf(tmp_path):
    entries = build_plan([f"/f{i}" for i in range(10)], ["Hot"] * 4 + ["Archival"] * 6,
                         ScoringConfig())
    p, r = tmp_path / "apply.sh", tmp_path / "ref.sh"
    n = write_setrep_script(str(p), entries, batch=500)
    text = p.read_text()
    assert n == 2 == text.count("hdfs dfs -setrep")
    for e in entries:
        assert f"'{e.path}'" in text
    cfg = ScoringConfig()
    assert f"-setrep {cfg.replication_factors['Archival']} " in text
    assert f"-setrep {cfg.replication_factors['Hot']} " in text
    assert ref_plan.write_setrep_script(str(r), _ref_entries(entries), batch=500) == n
    assert p.read_bytes() == r.read_bytes()


@pytest.mark.parametrize("wait", [False, True])
def test_setrep_script_batches_and_quotes(tmp_path, wait):
    entries = [PlanEntry(f"/weird it's {i}", "Hot", 3) for i in range(7)]
    p, r = tmp_path / "apply.sh", tmp_path / "ref.sh"
    n = write_setrep_script(str(p), entries, batch=3, wait=wait)
    assert n == 3
    subprocess.run(["sh", "-n", str(p)], check=True)
    assert ref_plan.write_setrep_script(str(r), _ref_entries(entries), batch=3,
                                        wait=wait) == n
    assert p.read_bytes() == r.read_bytes()


def test_cli_evaluate_emit_plan_round_trip(tmp_path, capsys):
    """``evaluate --emit_plan/--emit_setrep``: the plan holds the
    assignments that the evaluation applied."""
    from cdrs_tpu_torch.sim.access import simulate_access
    from cdrs_tpu_torch.sim.generator import generate_population

    manifest = generate_population(GeneratorConfig(n_files=30, seed=3))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=30, seed=3))
    mpath, apath = tmp_path / "m.csv", tmp_path / "a.log"
    manifest.write_csv(str(mpath))
    events.write_csv(str(apath), manifest)
    cats = ["Hot", "Shared", "Moderate"]
    assign = tmp_path / "assign.csv"
    with open(assign, "w") as f:
        f.write("path,cluster,category\n")
        for i, p in enumerate(manifest.paths):
            f.write(f"{p},0,{cats[i % 3]}\n")
    plan_p, setrep_p = tmp_path / "plan.csv", tmp_path / "apply.sh"
    rc, out, _ = _run(port_main, ["evaluate", "--manifest", str(mpath), "--access_log",
                                  str(apath), "--assignments_csv", str(assign),
                                  "--emit_plan", str(plan_p), "--emit_setrep",
                                  str(setrep_p)], capsys)
    assert rc == 0
    json.loads(out)
    cfg = ScoringConfig()
    entries = read_plan_csv(str(plan_p))
    assert len(entries) == 30
    by_path = {e.path: e for e in entries}
    for i, p in enumerate(manifest.paths):
        assert by_path[p].category == cats[i % 3]
        assert by_path[p].rf == cfg.replication_factors[cats[i % 3]]
    subprocess.run(["sh", "-n", str(setrep_p)], check=True)


@pytest.mark.parametrize("value,match", [
    ("abc", "invalid literal"), ("0", ">= 1"), ("data=0", ">= 1"),
    ("rows=2", "unknown mesh axis"), ("data=2=3", "too many values"),
    ("data=x,model=2", "invalid literal"),
])
def test_bad_mesh_value_is_a_usage_error(value, match, capsys):
    """``--mesh`` is checked by ``validate_mesh_shape`` as it is parsed: a
    bad value exits 2 with an error naming the flag, before anything runs."""
    with pytest.raises(SystemExit) as e:
        port_main(["pipeline", "--n", "50", "--mesh", value, "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--mesh" in err and match in err
    args = build_parser().parse_args(["pipeline", "--mesh", "data=4, model=2"])
    assert args.mesh == {"data": 4, "model": 2}
    assert build_parser().parse_args(["pipeline", "--mesh", "8"]).mesh == {"data": 8}
