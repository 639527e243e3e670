"""The port's scenario cells against the reference's ``run_cell``, from the
reference's cold init carried in (part 1: the decay-1 fault cells).

Each of the ten ported seed-0 ``ci-smoke`` cells and ``control-shift`` runs
through both harnesses; the cell records must agree in ``invariants``,
``metrics``, ``coverage`` and ``fingerprint``.  Decay-1 cells are held to
the reference cell re-run with ``backend="jax"`` (the port scores in
float32, as that backend does): the port's full re-clusters start from
the reference's D² init of the same snapshot.  Decay-0.7 cells are held to
``backend="numpy"`` (its float64 decayed counters): the reference's own
k-means++ inits and the rows its generator drew to reseed an empty
cluster are recorded by snapshot and replayed on the port's side
(``test_torch_scenario_parity_2.py``); the port's own reseed generator
differs by design (the port's PRNG design; ROADMAP Queue C3).  The port's
own inits are held to the invariants alone
(``test_torch_scenario_seeds.py``).
"""

import contextlib
import hashlib

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.ops.kmeans_np as ref_kmeans_np  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402
from cdrs_tpu.scenarios import run_cell as ref_run_cell  # noqa: E402
from cdrs_tpu.scenarios import suite_cells as ref_suite_cells  # noqa: E402

import cdrs_tpu_torch.ops.kmeans as port_kmeans  # noqa: E402
from cdrs_tpu_torch.models.replication import ReplicationPolicyModel  # noqa: E402
from cdrs_tpu_torch.scenarios import run_cell, suite_cells  # noqa: E402

COMPARED = ("invariants", "metrics", "coverage", "fingerprint")


def spec_pair(name: str, seed: int = 0):
    """(port spec, reference spec) of a ``full``-suite cell; the reference
    runs decay-1 cells on its jax backend."""
    port = {c.name: c for c in suite_cells("full", seed)}[name]
    ref = {c.name: c for c in ref_suite_cells("full", seed)}[name]
    if ref.decay == 1.0:
        ref = ref.replace(backend="jax")
    return port, ref


def _key(X) -> str:
    return hashlib.sha256(np.ascontiguousarray(X, dtype=np.float32).tobytes()).hexdigest()


class NumpyDraws:
    """What the numpy reference drew, keyed by the float32 cast of each
    snapshot it clustered (the port clusters that cast): the k-means++ init
    of a full re-cluster, and the rows that reseeded empty clusters,
    ``{lloyd iteration: {cluster: row}}``."""

    def __init__(self):
        self.inits: dict[str, np.ndarray] = {}
        self.reseeds: dict[str, dict[int, dict[int, int]]] = {}

    @contextlib.contextmanager
    def recording(self):
        init, kmeans, step = (ref_kmeans_np.kmeans_plusplus_init, ref_kmeans_np.kmeans,
                              ref_kmeans_np.lloyd_step)
        call: dict = {}

        def recorded_init(X, k, random_state=None):
            c = init(X, k, random_state=random_state)
            self.inits[_key(X)] = np.asarray(c)
            return c

        def recorded_kmeans(X, k, *a, **kw):
            call["key"], call["it"] = _key(X), 0
            self.reseeds[call["key"]] = {}
            return kmeans(X, k, *a, **kw)

        def recorded_step(X, centroids, rng):
            rows = []

            class Recorder:   # the generator, recording the reseed draws
                def integers(self, *a, **kw):
                    rows.append(int(rng.integers(*a, **kw)))
                    return rows[-1]

            out = step(X, centroids, Recorder())
            empty = np.flatnonzero(np.bincount(out[1], minlength=len(centroids)) == 0)
            if len(empty):
                self.reseeds[call["key"]][call["it"]] = dict(zip(empty.tolist(), rows))
            call["it"] += 1
            return out

        (ref_kmeans_np.kmeans_plusplus_init, ref_kmeans_np.kmeans,
         ref_kmeans_np.lloyd_step) = recorded_init, recorded_kmeans, recorded_step
        try:
            yield self
        finally:
            (ref_kmeans_np.kmeans_plusplus_init, ref_kmeans_np.kmeans,
             ref_kmeans_np.lloyd_step) = init, kmeans, step


@contextlib.contextmanager
def carried_init(draws: NumpyDraws | None = None, reseeds: bool = True):
    """Every port model's full re-clusters start from the reference's cold
    init: its D² init of the snapshot (jax backend), or, given ``draws``,
    the numpy reference's k-means++ init of the same snapshot; then (with
    ``reseeds``) an empty cluster takes the row the numpy reference's
    generator drew for it, where the port's own generator would."""
    run, table = ReplicationPolicyModel.run, port_kmeans._reseed_table
    current: dict = {}

    def run_from_reference_init(self, X, feature_names=None, init_centroids=None, **kw):
        x = X.cpu().numpy()
        current["key"] = _key(x)
        if init_centroids is None:
            if draws is None:
                init_centroids = np.asarray(kmeans_jax_full(
                    x, self.kmeans_cfg.k, seed=self.kmeans_cfg.seed, max_iter=0, tol=0.0)[0])
            else:
                init_centroids = draws.inits[current["key"]].astype(np.float32)
        return run(self, X, feature_names, init_centroids=init_centroids, **kw)

    def reference_reseeds(seed, iter_offset, iters, k, n_valid):
        rows = table(seed, iter_offset, iters, k, n_valid)
        for it, by_cluster in draws.reseeds.get(current.get("key"), {}).items():
            if iter_offset <= it < iter_offset + iters:
                for j, row in by_cluster.items():
                    rows[it - iter_offset, j] = row
        return rows

    ReplicationPolicyModel.run = run_from_reference_init
    if draws is not None and reseeds:
        port_kmeans._reseed_table = reference_reseeds
    try:
        yield
    finally:
        ReplicationPolicyModel.run, port_kmeans._reseed_table = run, table


def run_pair(name: str, seed: int = 0, reseeds: bool = True):
    """(port cell, reference cell) from the reference's cold init (and, for
    the numpy reference, its reseed draws unless ``reseeds`` is False)."""
    port_spec, ref_spec = spec_pair(name, seed)
    draws = None
    if ref_spec.backend == "numpy":
        draws = NumpyDraws()
        with draws.recording():
            want = ref_run_cell(ref_spec)
    else:
        want = ref_run_cell(ref_spec)
    with carried_init(draws, reseeds):
        got = run_cell(port_spec, device="cpu")
    return got, want


def assert_cells_match(got: dict, want: dict) -> None:
    assert got["cell"] == want["cell"] and got["seed"] == want["seed"]
    for key in COMPARED:
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["ok"] == want["ok"]


@pytest.mark.parametrize("name", ["chaos-kill", "rack-kill", "rack-partition", "cascade",
                                  "rolling-decommission"])
def test_fault_cell_matches_the_reference(name):
    got, want = run_pair(name)
    assert_cells_match(got, want)
    assert got["ok"], got["invariants"]
    assert got["invariants"]["faults_engaged"] and got["invariants"]["alerts_expected"]
    if name in ("chaos-kill", "rack-partition"):
        assert got["invariants"]["resume_bit_identical"]
    if name.startswith("rack-"):
        assert got["invariants"]["domain_diversity"]

