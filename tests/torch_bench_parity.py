"""Shared parts of the subsystem-bench parity tests
(``tests/test_torch_bench_<name>.py``): the reference benches' decay-1
controllers on ``backend="jax"``, the numpy reference's cold inits and
reseed rows carried in call order, and the field-by-field comparison.

The port scores in float32 as the reference's jax backend does, so decay-1
benches are held to the reference re-run on that backend from its D² init
of the same snapshot (``carried_init`` of ``test_torch_scenario_parity``).
Decay-0.7 runs are held to ``backend="numpy"``; its k-means++ inits and
reseed rows are replayed here in call order, since a baseline that
re-featurizes the whole log in float32 need not cast to the bytes the
float64 reference clustered."""

import contextlib
import json
import math

import numpy as np
import pytest
import torch

import cdrs_tpu.control as ref_control
import cdrs_tpu.ops.kmeans_np as ref_kmeans_np

import cdrs_tpu_torch.ops.kmeans as port_kmeans
from cdrs_tpu_torch.models.replication import ReplicationPolicyModel

#: Wall-clock fields, never compared.
WALL_CLOCK = frozenset({"seconds", "run_seconds"})


@pytest.fixture
def one_torch_thread():
    """One torch intra-op thread for the test.  With several pytest-xdist
    workers on the host's cores, torch's spinning thread pool makes the
    benches' many small ops tens of times slower than one thread does."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@contextlib.contextmanager
def reference_on_jax(*modules):
    """Every decay-1 ``ControllerConfig`` the given reference modules (and
    ``cdrs_tpu.control``, for function-local imports) build runs on
    ``backend="jax"``."""
    targets = [ref_control, *(m for m in modules if hasattr(m, "ControllerConfig"))]
    saved = [m.ControllerConfig for m in targets]
    original = ref_control.ControllerConfig

    def on_jax(*args, **kw):
        if kw.get("decay", 1.0) == 1.0:
            kw["backend"] = "jax"
        return original(*args, **kw)

    for m in targets:
        m.ControllerConfig = on_jax
    try:
        yield
    finally:
        for m, cc in zip(targets, saved):
            m.ControllerConfig = cc


class OrderedDraws:
    """What the numpy reference drew, by k-means call: the k-means++ init of
    a cold call (None for a warm one) and the rows that reseeded empty
    clusters, ``{lloyd iteration: {cluster: row}}``."""

    def __init__(self):
        self.calls: list[dict] = []

    @contextlib.contextmanager
    def recording(self):
        init, kmeans, step = (ref_kmeans_np.kmeans_plusplus_init, ref_kmeans_np.kmeans,
                              ref_kmeans_np.lloyd_step)

        def recorded_init(X, k, random_state=None):
            c = init(X, k, random_state=random_state)
            self.calls[-1]["init"] = np.asarray(c)
            return c

        def recorded_kmeans(X, k, *a, **kw):
            self.calls.append({"init": None, "reseeds": {}, "it": 0})
            return kmeans(X, k, *a, **kw)

        def recorded_step(X, centroids, rng):
            rows = []
            call = self.calls[-1]

            class Recorder:   # the generator, recording the reseed draws
                def integers(self, *a, **kw):
                    rows.append(int(rng.integers(*a, **kw)))
                    return rows[-1]

            out = step(X, centroids, Recorder())
            empty = np.flatnonzero(np.bincount(out[1], minlength=len(centroids)) == 0)
            if len(empty):
                call["reseeds"][call["it"]] = dict(zip(empty.tolist(), rows))
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
def carried_in_order(draws: OrderedDraws):
    """The port's i-th model run starts from the numpy reference's i-th
    k-means init (a cold run) and reseeds an emptied cluster with the row
    the reference drew there."""
    run, table = ReplicationPolicyModel.run, port_kmeans._reseed_table
    current = {"i": -1}

    def run_in_order(self, X, feature_names=None, init_centroids=None, **kw):
        current["i"] += 1
        call = draws.calls[current["i"]]
        if init_centroids is None:
            init_centroids = call["init"].astype(np.float32)
        return run(self, X, feature_names, init_centroids=init_centroids, **kw)

    def reference_reseeds(seed, iter_offset, iters, k, n_valid):
        rows = table(seed, iter_offset, iters, k, n_valid)
        for it, by_cluster in draws.calls[current["i"]]["reseeds"].items():
            if iter_offset <= it < iter_offset + iters:
                for j, row in by_cluster.items():
                    rows[it - iter_offset, j] = row
        return rows

    ReplicationPolicyModel.run = run_in_order
    port_kmeans._reseed_table = reference_reseeds
    try:
        yield
    finally:
        ReplicationPolicyModel.run, port_kmeans._reseed_table = run, table
    assert current["i"] + 1 == len(draws.calls), (current["i"] + 1, len(draws.calls))


def assert_matches(got, want, *, rel: float = 1e-5, skip=WALL_CLOCK, path: str = "") -> None:
    """``got`` equals ``want`` key by key and item by item: ints, bools,
    strings and None exactly, floats within ``rel`` of the larger magnitude
    (at least 1); keys in ``skip`` are not compared."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for key in want:
            if key not in skip:
                assert_matches(got[key], want[key], rel=rel, skip=skip, path=f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_matches(g, w, rel=rel, skip=skip, path=f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert isinstance(got, (int, float)), (path, got, want)
        if math.isnan(want):
            assert math.isnan(got), (path, got, want)
        else:
            assert abs(got - want) <= rel * max(1.0, abs(want), abs(got)), (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def round_trips(out: dict, tmp_path) -> None:
    """The artifact written as JSON reads back equal."""
    p = tmp_path / "artifact.json"
    p.write_text(json.dumps(out))
    assert json.loads(p.read_text()) == json.loads(json.dumps(out))
