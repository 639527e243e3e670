"""The failure-space search of the port (``cdrs_tpu_torch.scenarios.search``)
against ``cdrs_tpu.scenarios.search``, on the CPU.

The counterparts of ``tests/test_search.py``'s non-slow tests: the
schedule edit API, mutations (the reference's spec dicts exactly, seeds
0-19 from every ``SEARCH_BASE`` preset), coverage fingerprints, the ddmin
shrinker on the planted cell (the reference's minimal events and repro
line), distillation (the committed ``distilled.json``), the reserved name
prefixes and ``scenarios run --spec`` with a banked entry.  The search
loop itself is held in ``test_torch_search_2.py``.

``reference_init`` is the carry of ``test_torch_scenario_parity.py``
extended to a search's mix of cells: a decay-1 cell is held to the
reference on its jax backend (float32 scoring, as the port's) and starts
from the reference's D² init of the snapshot; a decay < 1 cell is held to
the numpy reference (its float64 decayed counters, as the port's) and
takes the k-means++ init and reseed rows that reference drew.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.scenarios.search as ref_search  # noqa: E402
from cdrs_tpu.faults import FaultSchedule as RefSchedule  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402
from cdrs_tpu.scenarios import preset as ref_preset  # noqa: E402
from cdrs_tpu.scenarios import run_cell as ref_run_cell  # noqa: E402
from test_torch_scenario_parity import NumpyDraws, _key  # noqa: E402

import cdrs_tpu_torch.ops.kmeans as port_kmeans  # noqa: E402
from cdrs_tpu_torch.cli import main as port_main  # noqa: E402
from cdrs_tpu_torch.faults import FaultEvent, FaultSchedule  # noqa: E402
from cdrs_tpu_torch.models.replication import ReplicationPolicyModel  # noqa: E402
from cdrs_tpu_torch.obs.aggregate import coverage_fingerprint  # noqa: E402
from cdrs_tpu_torch.scenarios import (PRESETS, ScenarioSpec, distill_corpus,  # noqa: E402
                                      mutate_spec, preset, run_cell, shrink_cell)
from cdrs_tpu_torch.scenarios.search import (RESERVED_NAME_PREFIXES,  # noqa: E402
                                             SEARCH_BASE, load_corpus,
                                             planted_violation_spec, search_cell_name)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "search_corpus")


def port_repro(line: str) -> str:
    """The reference's repro line as the port prints it."""
    return line.replace("python -m cdrs_tpu ", "python -m cdrs_tpu_torch ", 1)


def reference_cell(spec, draws: NumpyDraws, **kw):
    """The reference's ``run_cell`` of ``spec``: on its jax backend at
    decay 1, else on its numpy backend, recording that backend's draws."""
    if spec.decay == 1.0:
        return ref_run_cell(spec.replace(backend="jax"), **kw)
    with draws.recording():
        return ref_run_cell(spec, **kw)


@contextlib.contextmanager
def reference_init(draws: NumpyDraws):
    """Every port re-cluster starts from the reference's cold init of its
    snapshot: the numpy reference's k-means++ init (and its reseed rows)
    where ``draws`` recorded that snapshot, else the jax backend's D²
    init."""
    run, table = ReplicationPolicyModel.run, port_kmeans._reseed_table
    current: dict = {}

    def run_from_reference_init(self, X, feature_names=None, init_centroids=None, **kw):
        x = X.cpu().numpy()
        current["key"] = _key(x)
        if init_centroids is None:
            if current["key"] in draws.inits:
                init_centroids = draws.inits[current["key"]].astype(np.float32)
            else:
                init_centroids = np.asarray(kmeans_jax_full(
                    x, self.kmeans_cfg.k, seed=self.kmeans_cfg.seed, max_iter=0, tol=0.0)[0])
        return run(self, X, feature_names, init_centroids=init_centroids, **kw)

    def reference_reseeds(seed, iter_offset, iters, k, n_valid):
        rows = table(seed, iter_offset, iters, k, n_valid)
        for it, by_cluster in draws.reseeds.get(current.get("key"), {}).items():
            if iter_offset <= it < iter_offset + iters:
                for j, row in by_cluster.items():
                    rows[it - iter_offset, j] = row
        return rows

    ReplicationPolicyModel.run, port_kmeans._reseed_table = (run_from_reference_init,
                                                             reference_reseeds)
    try:
        yield
    finally:
        ReplicationPolicyModel.run, port_kmeans._reseed_table = run, table


# -- the fault-schedule edit API ---------------------------------------------

def test_events_roundtrip_property():
    nodes = [f"dn{i}" for i in range(1, 6)]
    for seed in (0, 1, 2):
        s = FaultSchedule.random(nodes, n_windows=12, seed=seed)
        specs = [e.spec() for e in s]
        assert specs and specs == [e.spec() for e in RefSchedule.random(nodes, 12, seed=seed)]
        assert [e.spec() for e in FaultSchedule.from_events(s.events())] == specs
        via_json = FaultSchedule.from_events(s.to_json())
        assert [e.spec() for e in via_json] == specs and via_json.to_json() == s.to_json()


def test_events_view_is_tuple_and_callable():
    s = FaultSchedule.from_specs(["crash:dn1@2", "recover:dn1@4"])
    assert isinstance(s.events, tuple) and len(s.events) == 2
    rows = s.events()
    assert isinstance(rows, list) and rows == list(s.events)
    rows.pop()
    assert len(s.events) == 2


def test_schedule_edit_constructors():
    s = FaultSchedule.from_specs(["crash:dn1@2", "crash:dn2@5"])
    assert [e.spec() for e in s.drop(0)] == ["crash:dn2@5"]
    assert [e.spec() for e in s.retime(1, 7)] == ["crash:dn1@2", "crash:dn2@7"]
    spliced = s.splice(FaultEvent(window=3, kind="crash", node="dn3"))
    assert "crash:dn3@3" in [e.spec() for e in spliced]
    assert [e.spec() for e in s.mutate(0, node="dn4")] == ["crash:dn4@2", "crash:dn2@5"]


# -- mutation ----------------------------------------------------------------

@pytest.mark.parametrize("name", SEARCH_BASE)
def test_mutations_are_the_reference_mutations(name):
    for seed in range(20):
        n_ops = 1 + seed % 4
        got = mutate_spec(preset(name), np.random.default_rng([seed, 19, 7]), n_ops=n_ops)
        want = ref_search.mutate_spec(ref_preset(name), np.random.default_rng([seed, 19, 7]),
                                      n_ops=n_ops)
        assert (got is None) == (want is None), (name, seed)
        if got is not None:
            assert got[0].to_dict() == want[0].to_dict(), (name, seed)
            assert got[1] == want[1], (name, seed)


def test_mutate_spec_deterministic_and_valid():
    parent = preset("chaos-kill")
    a = mutate_spec(parent, np.random.default_rng([0, 7]), n_ops=2)
    b = mutate_spec(parent, np.random.default_rng([0, 7]), n_ops=2)
    assert a is not None and a[0].to_dict() == b[0].to_dict()
    assert a[1] == b[1] and len(a[1]) >= 1
    ScenarioSpec.from_dict(a[0].to_dict())
    assert a[0].to_dict() != parent.to_dict()


def test_run_cell_coverage_and_fingerprint():
    res = run_cell(preset("chaos-kill"), device="cpu")
    cov = res["coverage"]
    assert cov == sorted(set(cov)) and "fault:crash" in cov
    assert any(b.startswith("inv:") for b in cov)
    assert res["fingerprint"] == coverage_fingerprint(cov)
    assert coverage_fingerprint(reversed(cov + cov[:2])) == res["fingerprint"]


# -- the shrinker on the planted cell -----------------------------------------

def test_shrinker_reduces_planted_cell_to_the_reference_minimal_cause(capsys):
    spec = planted_violation_spec(0)
    planted = run_cell(spec, device="cpu")
    assert [k for k, v in planted["invariants"].items() if not v] == ["zero_silent_loss"]
    got = shrink_cell(spec, device="cpu")
    want = ref_search.shrink_cell(ref_search.planted_violation_spec(0))
    assert got["n_events"] == want["n_events"] == 2
    assert got["events"] == want["events"]
    assert set(got["events"]) == {"corrupt:dn2@3:1", "decommission:dn1@5"}
    assert got["failed"] == want["failed"] == ["zero_silent_loss"]
    assert got["spec"] == want["spec"] and got["repro"] == port_repro(want["repro"])
    payload = got["repro"].split("--spec ", 1)[1].strip().strip("'")
    assert port_main(["scenarios", "run", "--spec", payload, "--device", "cpu"]) == 1
    assert not json.loads(capsys.readouterr().out)["ok"]


# -- the corpus ----------------------------------------------------------------

def test_distill_of_the_committed_corpus_is_distilled_json():
    with open(os.path.join(CORPUS, "distilled.json"), encoding="utf-8") as f:
        want = json.load(f)
    entries = load_corpus(CORPUS)
    assert [e["name"] for e in entries] == [e["name"] for e in ref_search.load_corpus(CORPUS)]
    got = distill_corpus(entries)
    assert got["names"] == want["names"] and got["fingerprint"] == want["fingerprint"]
    assert got["coverage_bits"] == want["coverage_bits"] and got["cells"] == want["cells"]


def test_distill_is_deterministic_greedy_cover():
    entries = [
        {"name": "c", "spec": {"name": "c"}, "coverage": ["a", "b"], "seconds": 2.0},
        {"name": "a", "spec": {"name": "a"}, "coverage": ["a", "b", "x"], "seconds": 1.0},
        {"name": "b", "spec": {"name": "b"}, "coverage": ["y"], "seconds": 0.5},
        {"name": "d", "spec": {"name": "d"}, "coverage": ["y"], "seconds": 0.5},
    ]
    d = distill_corpus(entries)
    assert d["names"] == ["a", "b"] and d["coverage_bits"] == 4
    assert d == distill_corpus(list(reversed(entries))) == ref_search.distill_corpus(entries)
    assert d["fingerprint"] == coverage_fingerprint(["a", "b", "x", "y"])


def test_generated_cell_name_prefixes_are_reserved():
    assert RESERVED_NAME_PREFIXES == ref_search.RESERVED_NAME_PREFIXES
    assert SEARCH_BASE == ref_search.SEARCH_BASE
    assert not any(n.startswith(RESERVED_NAME_PREFIXES) for n in PRESETS)
    assert search_cell_name(0, "deadbeefcafe") == "search-s0-deadbeef"


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_run_spec_accepts_file_and_banked_entry(tmp_path):
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(preset("cascade").to_dict()))
    rc, out, _ = _cli(["scenarios", "run", "--spec", str(path), "--device", "cpu"])
    assert rc == 0 and json.loads(out)["cell"] == "cascade"
    banked = os.path.join(CORPUS, "search-s0-54742316.json")
    rc, out, _ = _cli(["scenarios", "run", "--spec", banked, "--device", "cpu"])
    assert rc == 0 and json.loads(out)["ok"] and json.loads(out)["cell"] == "search-s0-54742316"


def test_cli_run_spec_file_errors_name_the_path(tmp_path):
    rc, _, err = _cli(["scenarios", "run", "--spec", str(tmp_path / "nope.json")])
    assert rc == 2 and "cannot read spec file" in err and "nope.json" in err
    bad = tmp_path / "bad.json"
    bad.write_text('{"name": "x", "wat": 1}')
    rc, _, err = _cli(["scenarios", "run", "--spec", str(bad)])
    assert rc == 2 and "invalid scenario spec" in err and "bad.json" in err
