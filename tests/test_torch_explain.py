"""Decision provenance on the port (``obs/explain.py``,
``placement_fn.explain_placement``, ``ops.scoring.score_table_terms``)
against the reference's.

* ``explain_placement`` equals the reference's trace dict for dict and the
  port's ``compute_placement`` row, on flat, racked and geo topologies, with
  and without the region-local pin (exact).
* ``score_table_terms`` equals the reference's within 1e-12 and sums to the
  port's float64 score table within 1e-12.
* On the reference fixture's chaos run (``tests/test_explain.py``: 250
  files, k = 8, dn2 crashed over windows 5-9, ``materialized_hash``), the
  port's controller on the CPU from the reference's D² init and the
  reference's ``backend="jax"`` controller each write a stream and a
  checkpoint.  ``explain file``, ``category`` (every category) and
  ``window`` print the same bytes from the port and from the reference on
  either run's files.  Across the two runs the text is the same but for
  numbers computed from each side's float32 centroids (drift and centroid
  shift, a category's centroid, deltas, contributions and scores), which
  agree within fp tolerance (the repo's standard for float reductions)
  and may then print one unit apart in their last printed digit: such a
  number is held to one unit of that digit, every other byte exactly.
* The clean errors and exit codes are the reference's.
"""

import re

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.cluster import ClusterTopology as RefTopology  # noqa: E402
from cdrs_tpu.control import ControllerConfig as RefConfig  # noqa: E402
from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.faults import FaultSchedule as RefSchedule  # noqa: E402
from cdrs_tpu.obs import JsonlSink as RefSink  # noqa: E402
from cdrs_tpu.obs import Telemetry as RefTelemetry  # noqa: E402
from cdrs_tpu.obs.explain import main as ref_explain  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402
from cdrs_tpu.ops.scoring_np import score_table_terms as ref_terms  # noqa: E402
from cdrs_tpu.placement_fn import explain_placement as ref_explain_placement  # noqa: E402
from cdrs_tpu.sim.access import simulate_access_with_shift as ref_shift  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch.cluster.placement import ClusterTopology, primary_on_topology  # noqa: E402
from cdrs_tpu_torch.config import (CATEGORIES, GeneratorConfig, KMeansConfig,  # noqa: E402
                                   ScoringConfig, SimulatorConfig, validated_scoring_config)
from cdrs_tpu_torch.control.controller import ControllerConfig, ReplicationController  # noqa: E402
from cdrs_tpu_torch.faults import FaultSchedule  # noqa: E402
from cdrs_tpu_torch.obs import JsonlSink, Telemetry  # noqa: E402
from cdrs_tpu_torch.obs.explain import explain_category, main as port_explain  # noqa: E402
from cdrs_tpu_torch.ops.scoring import score_table, score_table_terms, scoring_tables  # noqa: E402
from cdrs_tpu_torch.placement_fn import compute_placement, explain_placement  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access_with_shift  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

GEO = {
    "nodes": [f"dn{i}" for i in range(1, 13)],
    "levels": ["rack", "region"],
    "rack": {f"r{j}": [f"dn{2 * j + 1}", f"dn{2 * j + 2}"] for j in range(6)},
    "region": {"eu": ["r0", "r1"], "us": ["r2", "r3"], "ap": ["r4", "r5"]},
}
RACKS6 = ("dn1", "dn2", "dn3", "dn4", "dn5", "dn6")
RACK_SPEC = "r0=dn1,dn2;r1=dn3,dn4;r2=dn5,dn6"


def _topologies(name):
    if name == "flat":
        return ClusterTopology(nodes=("dn1", "dn2", "dn3", "dn4", "dn5")), \
            RefTopology(nodes=("dn1", "dn2", "dn3", "dn4", "dn5"))
    if name == "racked":
        return ClusterTopology.from_rack_spec(RACKS6, RACK_SPEC), \
            RefTopology.from_rack_spec(RACKS6, RACK_SPEC)
    return ClusterTopology.from_hierarchy(GEO), RefTopology.from_hierarchy(GEO)


@pytest.mark.parametrize("topo,local", [("flat", False), ("racked", False), ("geo", False),
                                        ("geo", True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_explain_placement_equals_the_reference_and_the_chooser(topo, local, seed):
    port_t, ref_t = _topologies(topo)
    n = len(port_t)
    rng = np.random.default_rng(seed)
    fids = rng.integers(0, 10**6, 12)
    prims = rng.integers(0, n, 12)
    for fid, prim in zip(fids, prims):
        for rf in range(1, n + 2):
            got = explain_placement(int(fid), rf, int(prim), port_t, seed, local=local)
            want = ref_explain_placement(int(fid), rf, int(prim), ref_t, seed, local=local)
            assert got == want
            slots, eff = compute_placement(
                np.asarray([fid]), np.asarray([rf]), np.asarray([prim]), port_t, seed,
                local_mask=np.asarray([local]) if port_t.n_levels else None)
            assert [s["node"] for s in got["slots"]] == slots[0, :int(eff[0])].tolist()


@pytest.mark.parametrize("validated", [False, True])
def test_score_table_terms_reconcile(validated):
    cfg = validated_scoring_config() if validated else ScoringConfig()
    rcfg = jcfg.validated_scoring_config() if validated else jcfg.ScoringConfig()
    rng = np.random.default_rng(7)
    med = rng.random((16, len(cfg.features)))
    med[3] = np.nan          # an empty cluster
    med[5, 2] = cfg.global_medians[cfg.features[2]]   # delta 0 exactly
    terms = score_table_terms(med, cfg)
    assert terms.shape == (16, len(CATEGORIES), len(cfg.features))
    assert terms.dtype == np.float64
    np.testing.assert_allclose(terms, ref_terms(med, rcfg), rtol=0, atol=1e-12)
    t = scoring_tables(cfg)
    import torch

    table = score_table(torch.as_tensor(med), t["global_medians"], t["W"], t["D"],
                        t["is_moderate"], t["band"]).numpy()
    np.testing.assert_allclose(terms.sum(axis=2), table, rtol=0, atol=1e-12)
    assert not terms[3].any()
    gm = rng.random(len(cfg.features))
    np.testing.assert_allclose(score_table_terms(med, cfg, gm), ref_terms(med, rcfg, gm),
                               rtol=0, atol=1e-12)


def test_explain_category_sums_to_the_score():
    cfg = validated_scoring_config()
    cent = np.random.default_rng(3).random((8, 5))
    t = scoring_tables(cfg)
    import torch

    table = score_table(torch.as_tensor(cent), t["global_medians"], t["W"], t["D"],
                        t["is_moderate"], t["band"])
    cat_idx = table.argmax(dim=1).numpy()
    for name in CATEGORIES:
        d = explain_category(name, cent, cat_idx, cfg)
        for c in d["clusters"]:
            assert round(sum(f["contribution"] for f in c["features"]), 4) == \
                round(c["score"], 4)
            assert c["margin"] >= 0
    with pytest.raises(ValueError, match="unknown category"):
        explain_category("Bogus", cent, cat_idx, cfg)


# -- the chaos run of the reference fixture, on both sides -------------------

K = 8


def _cfg(port: bool):
    kw = dict(window_seconds=100.0, default_rf=2, drift_threshold=0.02,
              placement_mode="materialized_hash")
    if port:
        return ControllerConfig(kmeans=KMeansConfig(k=K, seed=42),
                                scoring=validated_scoring_config(), device="cpu",
                                fault_schedule=FaultSchedule.from_specs(["crash:dn2@5-9"]), **kw)
    return RefConfig(kmeans=jcfg.KMeansConfig(k=K, seed=42),
                     scoring=jcfg.validated_scoring_config(), backend="jax",
                     fault_schedule=RefSchedule.from_specs(["crash:dn2@5-9"]), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    td = tmp_path_factory.mktemp("explain")
    flip = {"hot": "archival", "archival": "hot"}
    m = generate_population(GeneratorConfig(n_files=250, seed=11))
    ev, _ = simulate_access_with_shift(m, SimulatorConfig(duration_seconds=1500.0, seed=12),
                                       750.0, flip)
    rm = ref_generate(jcfg.GeneratorConfig(n_files=250, seed=11))
    rev, _ = ref_shift(rm, jcfg.SimulatorConfig(duration_seconds=1500.0, seed=12), 750.0, flip)
    out = {"manifest": str(td / "m.csv")}
    m.write_csv(out["manifest"])

    ctl = ReplicationController(m, _cfg(True))
    run = ctl._model_full.run

    def from_reference_init(X, init_centroids=None, **kw):
        if init_centroids is None:
            init_centroids = np.asarray(kmeans_jax_full(X.cpu().numpy(), K, seed=42,
                                                        max_iter=0, tol=0.0)[0])
        return run(X, init_centroids=init_centroids, **kw)

    ctl._model_full.run = from_reference_init
    mp, ck = str(td / "port.jsonl"), str(td / "port.npz")
    with Telemetry(JsonlSink(mp)):
        port_res = ctl.run(ev, metrics_path=mp, checkpoint_path=ck)
    rmp, rck = str(td / "ref.jsonl"), str(td / "ref.npz")
    with RefTelemetry(RefSink(rmp), meta=False):
        ref_res = RefController(rm, _cfg(False)).run(rev, metrics_path=rmp, checkpoint_path=rck)
    out.update(port=(mp, ck), ref=(rmp, rck), records=port_res.records,
               ref_records=ref_res.records, dir=td)
    return out


def _argvs(runs, side):
    mp, ck = runs[side]
    crash = next(r["window"] for r in runs["records"] if r.get("fault_events"))
    moved = sorted({w for r in runs["records"] for w in [r["window"]]
                    if (r.get("causes") or {})})
    out = [["file", str(f), "--manifest", runs["manifest"], "--metrics", mp,
            "--checkpoint", ck] for f in (0, 3, 117, 249)]
    out += [["file", "5", "--manifest", runs["manifest"], "--rf", "3", "--racks",
             "r0=dn1;r1=dn2,dn3"]]
    out += [["category", name, "--checkpoint", ck, "--scoring_config", "validated"]
            for name in CATEGORIES]
    out += [["window", str(w), "--metrics", mp] for w in sorted({0, crash, *moved})]
    return out


def test_the_runs_decide_alike(runs):
    assert [r["plan_hash"] for r in runs["records"]] == \
        [r["plan_hash"] for r in runs["ref_records"]]
    assert any(r.get("fault_events") for r in runs["records"])


#: A decimal number (a point or an exponent) standing alone: integers, node
#: names and hashes stay in the text that must match exactly.
_NUMBER = re.compile(r"(?<![\w.])[-+]?(?:\d+\.\d*|\.\d+|\d+(?=e))(?:e[-+]?\d+)?(?![\w.])")


def _last_digit_unit(tok: str) -> float:
    """One unit of the last printed digit of a number token."""
    mant, _, exp = tok.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - decimals)


def assert_same_text(got: str, want: str, what) -> int:
    """Same text; decimal numbers that differ are at most one unit of their
    last printed digit apart.  Returns how many numbers printed differently."""
    gt, wt = _NUMBER.split(got), _NUMBER.split(want)
    assert gt == wt, what
    gn, wn = _NUMBER.findall(got), _NUMBER.findall(want)
    assert len(gn) == len(wn), what
    apart = 0
    for a, b in zip(gn, wn):
        if a != b:
            unit = max(_last_digit_unit(a), _last_digit_unit(b))
            assert abs(float(a) - float(b)) <= unit * (1 + 1e-9), (what, a, b)
            apart += 1
    return apart


def test_explain_prints_the_references_bytes(runs, capsys):
    printed = apart = 0
    for port_argv, ref_argv in zip(_argvs(runs, "port"), _argvs(runs, "ref")):
        assert port_explain(port_argv) == 0, port_argv
        got = capsys.readouterr().out
        # The reference reading the port's stream and checkpoint.
        assert ref_explain(port_argv) == 0
        assert capsys.readouterr().out == got, port_argv
        # The port reading the reference's.
        assert ref_explain(ref_argv) == 0, ref_argv
        want = capsys.readouterr().out
        assert port_explain(ref_argv) == 0
        assert capsys.readouterr().out == want, ref_argv
        # The two runs: the same text (numbers from float32 centroids within
        # one unit of their last printed digit).
        apart += assert_same_text(got, want, port_argv)
        printed += len(got)
    assert printed > 5000
    assert apart <= 3


def test_explain_shows_the_crash_and_the_moves(runs, capsys):
    mp, ck = runs["port"]
    crash = next(r["window"] for r in runs["records"] if r.get("fault_events"))
    assert port_explain(["window", str(crash), "--metrics", mp]) == 0
    out = capsys.readouterr().out
    assert "CROSSED" in out and "repair" in out and "fault events" in out
    assert port_explain(["file", "3", "--manifest", runs["manifest"], "--metrics", mp,
                         "--checkpoint", ck]) == 0
    out = capsys.readouterr().out
    assert "computed placement" in out and "move history (cause-tagged)" in out
    assert "decided category" in out


@pytest.mark.parametrize("argv,code,msg", [
    (["file", "99999", "--manifest", "{m}", "--checkpoint", "{ck}"], 2, "out of range"),
    (["file", "-1", "--manifest", "{m}"], 2, "out of range"),
    (["category", "Bogus", "--checkpoint", "{ck}"], 2, "unknown category"),
    (["window", "999", "--metrics", "{mp}"], 2, "no window 999"),
    (["window", "1", "--metrics", "{dir}/nope.jsonl"], 1, "cannot read"),
    (["window", "1", "--metrics", "{dir}/empty.jsonl"], 1, "no telemetry events"),
    (["category", "Hot", "--checkpoint", "{dir}/nope.npz"], 1, "cannot load checkpoint"),
    (["file", "1", "--manifest", "{m}", "--racks", "r0=dnX"], 2, "bad topology"),
])
def test_clean_errors_and_exit_codes(runs, capsys, argv, code, msg):
    mp, ck = runs["port"]
    (runs["dir"] / "empty.jsonl").write_text("")
    fill = dict(m=runs["manifest"], ck=ck, mp=mp, dir=str(runs["dir"]))
    argv = [a.format(**fill) for a in argv]
    assert port_explain(argv) == code
    err = capsys.readouterr().err
    assert msg in err
    rmp, rck = runs["ref"]
    ref_argv = [a.replace(mp, rmp).replace(ck, rck) for a in argv]
    assert ref_explain(ref_argv) == code
    assert capsys.readouterr().err == err.replace(mp, rmp).replace(ck, rck)


def test_a_materialized_checkpoint_is_refused(tmp_path, capsys):
    m = generate_population(GeneratorConfig(n_files=60, seed=20))
    ev, _ = simulate_access_with_shift(m, SimulatorConfig(duration_seconds=300.0, seed=21),
                                       150.0, {"hot": "archival"})
    ctl = ReplicationController(m, ControllerConfig(
        window_seconds=100.0, kmeans=KMeansConfig(k=6, seed=42),
        scoring=validated_scoring_config(), device="cpu"))
    ck = str(tmp_path / "c.npz")
    ctl.run(ev, checkpoint_path=ck)
    mpath = str(tmp_path / "m.csv")
    m.write_csv(mpath)
    assert port_explain(["file", "0", "--manifest", mpath, "--checkpoint", ck]) == 2
    assert "materialized" in capsys.readouterr().err


def test_cli_hands_over_to_explain(runs, capsys):
    from cdrs_tpu_torch import cli

    mp, _ = runs["port"]
    assert cli.main(["explain", "window", "0", "--metrics", mp]) == 0
    assert capsys.readouterr().out.startswith("window 0:")
    assert primary_on_topology(["dn1"], np.zeros(3, dtype=np.int32),
                               ClusterTopology(nodes=("dn1", "dn2"))).tolist() == [0, 0, 0]
