"""The port's host workload and feature pass against the JAX package's.

Generator and simulator: bit-identical on the same seeds.  Features at
float64 on the CPU against ``compute_features_jax`` (x64, as the test suite
runs it): exact on the integer-derived columns; 1e-12 relative where a mean
or a min-max may be reduced in another order.  At float32: one f32
rounding of the f64 values (1e-6 relative, 1e-7 absolute near 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.features.jax_backend import compute_features_jax  # noqa: E402
from cdrs_tpu.io.events import EventLog as JEventLog  # noqa: E402
from cdrs_tpu.io.events import Manifest as JManifest  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as jsimulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as jgenerate  # noqa: E402

from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig  # noqa: E402
from cdrs_tpu_torch.features.batch import compute_features_torch  # noqa: E402
from cdrs_tpu_torch.io.events import EventLog, Manifest  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

EXACT_RAW = (0, 3, 4)        # access_freq, locality, concurrency
ROUNDED_RAW = (1, 2)         # age_seconds, write_ratio


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def _workloads(seed, n=600, duration=300.0):
    port_m = generate_population(GeneratorConfig(n_files=n, seed=seed))
    ref_m = jgenerate(jcfg.GeneratorConfig(n_files=n, seed=seed))
    port_e = simulate_access(port_m, SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    ref_e = jsimulate(ref_m, jcfg.SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    return port_m, port_e, ref_m, ref_e


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generator_and_simulator_are_bit_identical(seed):
    port_m, port_e, ref_m, ref_e = _workloads(seed)
    assert port_m.paths == ref_m.paths
    assert port_m.category == ref_m.category
    assert port_m.nodes == ref_m.nodes
    for name in ("creation_ts", "primary_node_id", "size_bytes"):
        np.testing.assert_array_equal(getattr(port_m, name), getattr(ref_m, name))
    assert port_e.clients == ref_e.clients
    for name in ("ts", "path_id", "op", "client_id"):
        a, b = getattr(port_e, name), getattr(ref_e, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


def _compare_f64(port, ref):
    raw = port.raw.numpy()
    for j in EXACT_RAW:
        np.testing.assert_array_equal(raw[:, j], ref.raw[:, j])
    np.testing.assert_array_equal(port.writes.numpy(), ref.writes)
    np.testing.assert_array_equal(port.reads.numpy(), ref.reads)
    for j in ROUNDED_RAW:
        np.testing.assert_allclose(raw[:, j], ref.raw[:, j], rtol=1e-12, atol=0)
    np.testing.assert_allclose(port.norm.numpy(), ref.norm, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_features_float64_match_reference(seed):
    port_m, port_e, ref_m, ref_e = _workloads(seed)
    port = compute_features_torch(port_m, port_e, device="cpu", dtype="float64")
    ref = compute_features_jax(ref_m, ref_e)
    assert port.raw.dtype == torch.float64 and port.paths == ref.paths
    _compare_f64(port, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_features_float32_within_one_rounding(seed):
    port_m, port_e, ref_m, ref_e = _workloads(seed)
    port = compute_features_torch(port_m, port_e, device="cpu")
    ref = compute_features_jax(ref_m, ref_e)
    assert port.norm.dtype == torch.float32
    np.testing.assert_allclose(port.raw.double().numpy(), ref.raw, rtol=1e-6, atol=0)
    np.testing.assert_allclose(port.norm.double().numpy(), ref.norm, rtol=1e-6, atol=1e-7)


def _pair(ts, pid, op, client, n=4):
    """The same hand-made log in both packages' types."""
    creation = 1_700_000_000.0 - np.arange(n) * 1000.0
    primary = (np.arange(n) % 3).astype(np.int32)
    paths = [f"/f{i}" for i in range(n)]
    nodes = ["dn1", "dn2", "dn3"]
    cols = dict(ts=np.asarray(ts, np.float64), path_id=np.asarray(pid, np.int32),
                op=np.asarray(op, np.int8), client_id=np.asarray(client, np.int32),
                clients=nodes + ["dn4"])
    man = dict(paths=paths, creation_ts=creation, primary_node_id=primary,
               size_bytes=np.full(n, 1024, np.int64), category=["hot"] * n, nodes=nodes)
    return Manifest(**man), EventLog(**cols), JManifest(**man), JEventLog(**cols)


def test_empty_log():
    pm, pe, rm, re = _pair([], [], [], [])
    port = compute_features_torch(pm, pe, observation_end=1_700_000_100.0,
                                  device="cpu", dtype="float64")
    ref = compute_features_jax(rm, re, observation_end=1_700_000_100.0)
    np.testing.assert_array_equal(port.raw.numpy()[:, 3], 1.0)   # locality
    np.testing.assert_array_equal(port.norm.numpy()[:, [0, 2, 3, 4]], 0.0)
    _compare_f64(port, ref)


def test_events_of_unknown_paths_count_only_toward_observation_end():
    t0 = 1_700_000_200.0
    pm, pe, rm, re = _pair(
        ts=[t0, t0 + 0.5, t0 + 1.2, t0 + 1.4, t0 + 9.0],
        pid=[0, -1, 2, 0, -1],
        op=[1, 1, 0, 0, 1],
        client=[0, 1, 2, 3, 0])
    port = compute_features_torch(pm, pe, device="cpu", dtype="float64")
    ref = compute_features_jax(rm, re)
    _compare_f64(port, ref)
    np.testing.assert_array_equal(port.raw.numpy()[:, 0], [2, 0, 1, 0])
    # observation_end is the last event, unknown path or not.
    assert port.raw[3, 1].item() == t0 + 9.0 - pm.creation_ts[3]


def test_concurrency_ties_and_runs():
    t0 = 1_700_000_300.0
    # path 0: seconds {0: 2, 1: 2} (tie); path 1: {0: 1, 2: 3}; path 3: {1: 1}
    ts = [t0, t0 + 0.1, t0 + 1.1, t0 + 1.2, t0 + 0.3, t0 + 2.0, t0 + 2.1, t0 + 2.9,
          t0 + 1.5]
    pid = [0, 0, 0, 0, 1, 1, 1, 1, 3]
    order = np.argsort(ts, kind="stable")
    pm, pe, rm, re = _pair(np.asarray(ts)[order], np.asarray(pid)[order],
                           np.zeros(9)[order], np.zeros(9)[order])
    port = compute_features_torch(pm, pe, device="cpu", dtype="float64")
    ref = compute_features_jax(rm, re)
    _compare_f64(port, ref)
    np.testing.assert_array_equal(port.raw.numpy()[:, 4], [2, 3, 0, 1])
