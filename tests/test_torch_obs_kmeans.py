"""The convergence trace of the port's ``kmeans_full`` under an instrument
against the reference's traced runs.

The reference swaps its fused kernel for the matmul strategy to see
distances (``kmeans_jax_full`` with an active ``Telemetry``); the port
keeps its Lloyd kernel and derives each iteration's inertia from the
kernel's own (sums, counts).  From the reference's D² init (carried
across), in float64, the port takes the same iterations as the traced
``kmeans_jax_full`` and ``kmeans_np``: the same ``n_iter``, ``shift`` per
step within 1e-6 relative and ``inertia`` per step within 1e-4 relative
(the reference's trace buffers are float32).  Tracing changes no bit of
the port's run."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.obs import JsonlSink as RefSink  # noqa: E402
from cdrs_tpu.obs import Telemetry as RefTelemetry  # noqa: E402
from cdrs_tpu.obs import read_events as ref_read_events  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402
from cdrs_tpu.ops.kmeans_np import kmeans as kmeans_np  # noqa: E402

from cdrs_tpu_torch.device import deterministic  # noqa: E402
from cdrs_tpu_torch.obs import JsonlSink, Telemetry, read_events  # noqa: E402
from cdrs_tpu_torch.ops.kmeans import kmeans_full  # noqa: E402

SHIFT_RTOL, INERTIA_RTOL = 1e-6, 1e-4


def blobs(seed, n=1999, d=5, centers=7, spread=0.08):
    rng = np.random.default_rng(seed)
    mu = rng.random((centers, d))
    lab = rng.integers(0, centers, n)
    return mu[lab] + spread * rng.normal(size=(n, d))


def trace_of(events):
    it = sorted((e for e in events if e["kind"] == "kmeans_iter"), key=lambda e: e["step"])
    return (np.array([e["inertia"] for e in it], dtype=np.float64),
            np.array([e["shift"] for e in it], dtype=np.float64), it)


def port_traced(tmp_path, X, k, name="port", **kw):
    p = str(tmp_path / f"{name}.jsonl")
    with deterministic(), Telemetry(JsonlSink(p)) as tel:
        out = kmeans_full(torch.from_numpy(X), k, **kw)
    return out, tel, read_events(p)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_matches_the_reference_traced_runs(tmp_path, seed):
    X = blobs(seed)
    k = 7
    init = np.array(kmeans_jax_full(X, k, seed=seed, max_iter=0, tol=0.0,
                                      dtype=np.float64)[0])
    ref_p = str(tmp_path / "ref.jsonl")
    with RefTelemetry(RefSink(ref_p)):
        _, _, it_j, _ = kmeans_jax_full(X, k, seed=seed, tol=1e-4, max_iter=100,
                                        init_centroids=init, dtype=np.float64)
    np_p = str(tmp_path / "np.jsonl")
    with RefTelemetry(RefSink(np_p)):
        kmeans_np(X, k, tol=1e-4, random_state=seed, max_iter=100, init_centroids=init)
    (c, lab, it, shift), tel, events = port_traced(
        tmp_path, X, k, seed=seed, tol=1e-4, max_iter=100,
        init_centroids=torch.from_numpy(init))
    inertia, shifts, rows = trace_of(events)
    assert tel.counters["kernel.calls.kmeans_full"] == 1
    assert tel.histograms["kmeans.iterations"] == [float(it)]
    assert len(rows) == it == int(it_j) and shifts[-1] == pytest.approx(shift)
    assert {(r["kernel"], r["backend"], r["k"], r["n"], r["update"]) for r in rows} == \
        {("kmeans_full", "torch", k, len(X), "lloyd")}
    for ref_events in (ref_read_events(ref_p), ref_read_events(np_p)):
        ref_inertia, ref_shifts, _ = trace_of(ref_events)
        assert len(ref_shifts) == it
        np.testing.assert_allclose(shifts, ref_shifts, rtol=SHIFT_RTOL, atol=1e-12)
        np.testing.assert_allclose(inertia, ref_inertia, rtol=INERTIA_RTOL)
    # The inertia of each step against the centroids it assigned to, recomputed.
    assert inertia[0] == pytest.approx(
        float(((X[:, None, :] - init[None]) ** 2).sum(-1).min(1).sum()), rel=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("tol, max_iter", [(1e-4, 100), (0.0, 9)])
def test_traced_and_untraced_runs_are_bit_identical(tmp_path, dtype, tol, max_iter):
    X = blobs(3).astype(dtype)
    with deterministic():
        c0, lab0, it0, s0 = kmeans_full(torch.from_numpy(X), 6, seed=3, tol=tol,
                                        max_iter=max_iter)
    (c1, lab1, it1, s1), _, events = port_traced(tmp_path, X, 6, seed=3, tol=tol,
                                                 max_iter=max_iter)
    assert torch.equal(c0, c1) and torch.equal(lab0, lab1) and (it0, s0) == (it1, s1)
    _, shifts, rows = trace_of(events)
    assert len(rows) == it1 and shifts[-1] == pytest.approx(s1)


def test_trace_off_and_model_axis_stay_untraced(tmp_path):
    X = blobs(4)
    p = str(tmp_path / "t.jsonl")
    with deterministic(), Telemetry(JsonlSink(p), kmeans_trace=False) as tel:
        kmeans_full(torch.from_numpy(X), 4, seed=4)
        kmeans_full(torch.from_numpy(X), 4, seed=4, mesh_shape={"data": 2, "model": 2},
                    device="cpu")
    assert not [e for e in read_events(p) if e["kind"] == "kmeans_iter"]
    assert tel.counters["kernel.calls.kmeans_full"] == 2
    p2 = str(tmp_path / "t2.jsonl")
    with deterministic(), Telemetry(JsonlSink(p2)):
        kmeans_full(torch.from_numpy(X), 4, seed=4, mesh_shape={"data": 2, "model": 2},
                    device="cpu")
    assert not [e for e in read_events(p2) if e["kind"] == "kmeans_iter"]


def test_data_mesh_trace_equals_one_device(tmp_path):
    """On a data-only mesh the trace adds the shards' statistics, so it is
    the one-device trace within float64 rounding."""
    X = blobs(5)
    (_, _, it1, _), _, ev1 = port_traced(tmp_path, X, 5, seed=5)
    (_, _, it4, _), _, ev4 = port_traced(tmp_path, X, 5, "mesh", seed=5,
                                         mesh_shape={"data": 4}, device="cpu")
    i1, s1, _ = trace_of(ev1)
    i4, s4, _ = trace_of(ev4)
    assert it1 == it4
    np.testing.assert_allclose(i4, i1, rtol=1e-12)
    np.testing.assert_allclose(s4, s1, rtol=1e-9, atol=1e-15)
