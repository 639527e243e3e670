"""The port's read router, hotspot detector and serving digest against
``cdrs_tpu.serve`` and ``cdrs_tpu.obs.aggregate.serve_digest``, and the
reference's own router and detector cases (``tests/test_serve.py``) on the
port.

Router parity: the same seeded inputs (a 500-file rf-3 placement on six
nodes, 20,000 skewed reads with in- and out-of-topology clients) through
both routers, per policy, under each input the router takes: a clean map,
unreachable slots, stragglers, rot with verification on and off, per-read
extra latency, a cross-node latency matrix, an empty batch and a full
outage.  ``server``, ``latency_ms``, the per-node counts and utilization,
``corrupt_pairs`` and every ``record_fields()`` value are equal bitwise.
All host numpy: routing runs no kernel.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from cdrs_tpu.obs.aggregate import serve_digest as ref_serve_digest  # noqa: E402
from cdrs_tpu.serve import HotspotDetector as RefHotspot  # noqa: E402
from cdrs_tpu.serve import ReadRouter as RefRouter  # noqa: E402
from cdrs_tpu.serve import ServeConfig as RefServeConfig  # noqa: E402
from cdrs_tpu.serve import SloSpec as RefSlo  # noqa: E402

from cdrs_tpu_torch.cluster.evaluate import _client_to_topology, evaluate_placement  # noqa: E402
from cdrs_tpu_torch.cluster.placement import ClusterTopology, place_replicas  # noqa: E402
from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig  # noqa: E402
from cdrs_tpu_torch.obs.aggregate import serve_digest  # noqa: E402
from cdrs_tpu_torch.serve import (POLICIES, HotspotDetector, ReadRouter,  # noqa: E402
                                  ServeConfig, SloSpec)
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

SEED = 0


def _placement(n_files=500, n_nodes=6, rf=3, seed=SEED):
    nodes = tuple(f"dn{i}" for i in range(1, n_nodes + 1))
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=nodes))
    placement = place_replicas(manifest, np.full(n_files, rf, dtype=np.int32),
                               ClusterTopology(nodes=nodes), seed=seed)
    return manifest, placement


def _reads(n_files, n_nodes, e=20000, seed=SEED, span=60.0, skew=3.0):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.random(e) * span)
    pid = (n_files * rng.random(e) ** skew).astype(np.int32)
    client = rng.integers(-1, n_nodes, e).astype(np.int32)
    return ts, pid, client


# -- router parity -------------------------------------------------------------

CASES = ("clean", "unreachable", "stragglers", "rot_verified", "rot_unverified",
         "extra_ms", "edge_ms", "empty", "outage")


def _case_inputs(case):
    """(replica_map, slot_ok, throughput, reads, route kwargs, verify)."""
    manifest, placement = _placement()
    rm = placement.replica_map
    n_nodes = len(placement.topology)
    ts, pid, client = _reads(len(manifest), n_nodes, seed=SEED + 1)
    rng = np.random.default_rng(SEED + 7)
    slot_ok = rm >= 0
    thr = np.ones(n_nodes)
    kw: dict = {}
    verify = True
    if case == "unreachable":
        node_ok = np.asarray([i not in (1, 3, 4) for i in range(n_nodes)])
        slot_ok = slot_ok & node_ok[np.clip(rm, 0, None)]
    elif case == "stragglers":
        thr = np.asarray([1.0, 0.25, 1.0, 0.5, 1.0, 0.1])
    elif case.startswith("rot"):
        kw["slot_corrupt"] = (rng.random(rm.shape) < 0.2) & slot_ok
        verify = case == "rot_verified"
    elif case == "extra_ms":
        kw["extra_ms"] = rng.random(len(pid)) * 3.0
    elif case == "edge_ms":
        edge = rng.random((n_nodes, n_nodes)) * 4.0
        np.fill_diagonal(edge, 0.0)
        kw["edge_ms"] = edge
    elif case == "empty":
        ts, pid, client = ts[:0], pid[:0], client[:0]
    elif case == "outage":
        slot_ok = np.zeros_like(slot_ok)
    return rm, slot_ok, thr, (ts, pid, client), kw, verify


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("policy", POLICIES)
def test_router_matches_the_reference_bitwise(policy, case):
    rm, slot_ok, thr, (ts, pid, client), kw, verify = _case_inputs(case)
    n_nodes = len(thr)
    slo = dict(target_ms=2.0, availability=0.99)
    got = ReadRouter(n_nodes, ServeConfig(policy=policy, seed=3, slo=SloSpec(**slo),
                                          verify_reads=verify)).route(
        rm, slot_ok, thr, ts=ts, pid=pid, client=client, window_seconds=60.0,
        rng=np.random.default_rng([3, 5]), **kw)
    want = RefRouter(n_nodes, RefServeConfig(policy=policy, seed=3, slo=RefSlo(**slo),
                                             verify_reads=verify)).route(
        rm, slot_ok, thr, ts=ts, pid=pid, client=client, window_seconds=60.0,
        rng=np.random.default_rng([3, 5]), **kw)
    for name in ("server", "latency_ms", "reads_per_node", "utilization"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name
    assert got.record_fields() == want.record_fields()
    assert (got.p50_ms, got.p95_ms, got.p99_ms, got.slo_burn) == \
        (want.p50_ms, want.p95_ms, want.p99_ms, want.slo_burn)
    if want.corrupt_pairs is None:
        assert got.corrupt_pairs is None
    else:
        assert got.corrupt_pairs.tobytes() == want.corrupt_pairs.tobytes()
    # Each case reaches its branch.
    f = got.record_fields()
    if case == "rot_verified":
        assert f["reads_corrupt_detected"] > 0 and len(got.corrupt_pairs)
    if case == "rot_unverified":
        assert f["reads_corrupt_served"] > 0 and got.corrupt_pairs is None
    if case in ("unreachable", "outage"):
        assert f["reads_unavailable"] > 0
    if case in ("empty", "outage"):
        assert f["latency_p99_ms"] is None


# -- hotspot and digest parity -----------------------------------------------------

def _spike_windows(n=64, seed=SEED):
    rng = np.random.default_rng(seed)
    windows = [rng.poisson(8.0, n).astype(float) for _ in range(8)]
    windows[3][[5, 9, 40]] += (500.0, 300.0, 500.0)
    windows[6][17] += 90.0
    return windows


def test_hotspot_matches_the_reference_and_its_state_crosses_packages():
    windows = _spike_windows()
    port, ref = HotspotDetector(64, min_reads=10, top_k=2), RefHotspot(64, min_reads=10, top_k=2)
    fired = []
    for i, counts in enumerate(windows):
        g, w = port.observe(counts), ref.observe(counts)
        assert (g.fired, g.score, g.files) == (w.fired, w.score, w.files), i
        assert port.ewma.tobytes() == ref.ewma.tobytes()
        fired.append(g.fired)
        if i == 4:
            # The state round-trips both ways mid-sequence.
            a, b = port.state_arrays(), ref.state_arrays()
            assert set(a) == set(b) == {"serve_ewma", "serve_ewma_init"}
            port2, ref2 = HotspotDetector(64, min_reads=10, top_k=2), \
                RefHotspot(64, min_reads=10, top_k=2)
            port2.load_state_arrays(b)
            ref2.load_state_arrays(a)
    for counts in windows[5:]:
        g, w = port2.observe(counts), ref2.observe(counts)
        assert (g.fired, g.score, g.files) == (w.fired, w.score, w.files)
    assert fired[0] is False and fired[3] and fired[6]
    with pytest.raises(ValueError, match="stale checkpoint"):
        HotspotDetector(32).load_state_arrays(a)


def test_serve_digest_matches_the_reference():
    rm, slot_ok, thr, (ts, pid, client), _, _ = _case_inputs("clean")
    det = HotspotDetector(rm.shape[0], min_reads=5)
    records = []
    for w in range(4):
        ok = np.zeros_like(slot_ok) if w == 2 else slot_ok
        sel = slice(w * 5000, (w + 1) * 5000)
        res = ReadRouter(len(thr), ServeConfig(policy="p2c")).route(
            rm, ok, thr, ts=ts[sel], pid=pid[sel], client=client[sel],
            rng=np.random.default_rng([0, w]))
        hs = det.observe(np.bincount(pid[sel], minlength=rm.shape[0]) * (1 + 9 * (w == 3)))
        records.append({"window": w, **res.record_fields(), "hotspot_score": hs.score,
                        "hotspot_files": list(hs.files),
                        "recluster_trigger": "hotspot" if hs.fired else None})
    records.append({"window": 4, "n_events": 0})
    got = serve_digest(records)
    assert got == ref_serve_digest(records)
    assert got["hotspot_reclusters"] >= 1 and got["reads_unavailable"] == 5000
    assert serve_digest([{"window": 0}]) is None is ref_serve_digest([{"window": 0}])


# -- the reference's own router and detector cases ---------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_never_selects_unreachable_node(policy):
    """No policy routes a read to an unreachable node; reads of files with
    no reachable slot are unavailable (-1)."""
    manifest, placement = _placement(seed=SEED)
    n_nodes = len(placement.topology)
    rm = placement.replica_map
    down = {1, 4}
    node_ok = np.asarray([i not in down for i in range(n_nodes)])
    slot_ok = (rm >= 0) & node_ok[np.clip(rm, 0, None)]
    ts, pid, client = _reads(len(manifest), n_nodes, seed=SEED + 1)
    res = ReadRouter(n_nodes, ServeConfig(policy=policy, seed=SEED)).route(
        rm, slot_ok, np.ones(n_nodes), ts=ts, pid=pid, client=client, window_seconds=60.0)
    assert not np.isin(res.server[res.server >= 0], list(down)).any()
    expect_unavail = ~slot_ok[pid].any(axis=1)
    assert np.array_equal(res.server < 0, expect_unavail)
    assert res.n_unavailable == int(expect_unavail.sum())
    assert res.latency_ms.shape == (res.n_routed,)
    assert np.isfinite(res.latency_ms).all() and (res.latency_ms > 0).all()


def test_p2c_load_not_worse_than_random():
    manifest, placement = _placement(n_files=300, seed=SEED)
    n_nodes = len(placement.topology)
    rm = placement.replica_map
    ts, pid, client = _reads(len(manifest), n_nodes, e=60000, seed=SEED + 2, skew=5.0)
    client = np.full_like(client, -1)   # no local short-circuit: the policy alone
    loads = {}
    for policy in ("random", "p2c"):
        res = ReadRouter(n_nodes, ServeConfig(policy=policy, seed=SEED)).route(
            rm, rm >= 0, np.ones(n_nodes), ts=ts, pid=pid, client=client, window_seconds=60.0)
        loads[policy] = res.reads_per_node.max()
    assert loads["p2c"] <= loads["random"]


def test_flat_nominal_locality_matches_offline_replay():
    """Flat topology, nominal throughput: the router's locality equals the
    offline replay's read locality (local reads always short-circuit)."""
    manifest, placement = _placement(n_files=400, rf=2, seed=SEED)
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=300, seed=SEED + 3))
    m = evaluate_placement(manifest, events, placement, seed=0)
    keep = events.path_id >= 0
    is_read = np.asarray(events.op)[keep] == 0
    client = _client_to_topology(events, placement.topology)[keep][is_read]
    n_nodes = len(placement.topology)
    for policy in ("primary", "random"):
        res = ReadRouter(n_nodes, ServeConfig(policy=policy, seed=SEED)).route(
            placement.replica_map, placement.replica_map >= 0, np.ones(n_nodes),
            ts=events.ts[keep][is_read], pid=events.path_id[keep][is_read], client=client)
        assert res.locality == pytest.approx(m.read_locality, abs=1e-12)
        assert res.n_unavailable == 0


def test_queue_model_matches_naive_fifo():
    rng = np.random.default_rng(SEED)
    ts = np.sort(rng.random(800) * 2.0)
    rm = np.zeros((50, 1), dtype=np.int32)
    res = ReadRouter(1, ServeConfig(policy="primary", service_ms=1.5)).route(
        rm, rm >= 0, np.ones(1), ts=ts, pid=rng.integers(0, 50, 800).astype(np.int32),
        client=np.full(800, -1, dtype=np.int32))
    f_prev, naive = -np.inf, []
    for a in ts:
        f_prev = max(a, f_prev) + 1.5e-3
        naive.append((f_prev - a) * 1000.0)
    assert np.allclose(res.latency_ms, naive)
    assert res.p50_ms <= res.p95_ms <= res.p99_ms


def test_straggler_stretches_service_time():
    rng = np.random.default_rng(SEED)
    e = 2000
    ts = np.sort(rng.random(e) * 60.0)
    rm = np.zeros((10, 1), dtype=np.int32)
    kw = dict(ts=ts, client=np.full(e, -1, dtype=np.int32), window_seconds=60.0)
    router = ReadRouter(1, ServeConfig(policy="primary", service_ms=0.5))
    slow = router.route(rm, rm >= 0, np.asarray([0.25]),
                        pid=rng.integers(0, 10, e).astype(np.int32), **kw)
    assert slow.latency_ms.min() >= 2.0 - 1e-9   # 0.5 ms / 0.25
    nominal = router.route(rm, rm >= 0, np.ones(1),
                           pid=rng.integers(0, 10, e).astype(np.int32), **kw)
    assert slow.p99_ms > nominal.p99_ms


def test_routing_deterministic_given_seed():
    manifest, placement = _placement(seed=SEED)
    n_nodes = len(placement.topology)
    ts, pid, client = _reads(len(manifest), n_nodes, seed=SEED)
    for policy in POLICIES:
        a, b = (ReadRouter(n_nodes, ServeConfig(policy=policy, seed=7)).route(
            placement.replica_map, placement.replica_map >= 0, np.ones(n_nodes), ts=ts,
            pid=pid, client=client, rng=np.random.default_rng([7, 3])) for _ in range(2))
        assert np.array_equal(a.server, b.server)
        assert np.array_equal(a.latency_ms, b.latency_ms)


def test_full_outage_window_has_no_latency_sample():
    """An all-unavailable window reports no percentiles (not 0) and still
    counts its reads in the digest's unavailable fraction."""
    rng = np.random.default_rng(SEED)
    rm = np.zeros((10, 1), dtype=np.int32)
    res = ReadRouter(1, ServeConfig(policy="p2c")).route(
        rm, np.zeros((10, 1), dtype=bool), np.ones(1), ts=np.sort(rng.random(100)),
        pid=rng.integers(0, 10, 100).astype(np.int32), client=np.full(100, -1, dtype=np.int32))
    assert res.n_unavailable == 100 and res.n_routed == 0
    fields = res.record_fields()
    assert fields["latency_p99_ms"] is None and fields["latency_p50_ms"] is None
    d = serve_digest([{"window": 0, **fields}])
    assert d["reads_unavailable"] == 100 and d["unavailable_fraction"] == 1.0
    assert d["latency_p99_ms_max"] is None


def test_slo_burn_accounting():
    """Burn = (over target + unavailable) / reads / error budget."""
    rng = np.random.default_rng(SEED)
    e = 4000
    ts = np.sort(rng.random(e) * 1.0)   # 4000 reads/s on one 2000 reads/s node
    rm = np.zeros((10, 1), dtype=np.int32)
    res = ReadRouter(1, ServeConfig(policy="primary", service_ms=0.5,
                                    slo=SloSpec(target_ms=5.0, availability=0.99))).route(
        rm, rm >= 0, np.ones(1), ts=ts, pid=rng.integers(0, 10, e).astype(np.int32),
        client=np.full(e, -1, dtype=np.int32), window_seconds=1.0)
    over = int((res.latency_ms > 5.0).sum())
    assert res.slo_violations == over
    assert res.slo_burn == pytest.approx((over / e) / 0.01)
    assert res.slo_burn > 1.0


def test_hotspot_detects_spike_not_stationary():
    det = HotspotDetector(100, spike_factor=4.0, min_reads=20, top_k=4)
    rng = np.random.default_rng(SEED)
    assert not det.observe(rng.poisson(10.0, 100).astype(float)).fired   # the baseline
    for _ in range(3):
        assert not det.observe(rng.poisson(10.0, 100).astype(float)).fired
    spike = rng.poisson(10.0, 100).astype(float)
    spike[[7, 42]] += 200.0
    res = det.observe(spike)
    assert res.fired and set(res.files) == {7, 42} and res.score >= 4.0
    assert det.observe(spike).score < res.score   # folded into the baseline


def test_hotspot_deterministic_and_seed_invariant():
    windows = _spike_windows()

    def run():
        det = HotspotDetector(64, min_reads=10)
        return [(r.fired, r.score, r.files) for r in map(det.observe, windows)]

    assert run() == run()


def test_hotspot_state_roundtrip():
    det = HotspotDetector(32, alpha=0.5)
    det.observe(np.arange(32, dtype=float))
    det.observe(np.ones(32))
    det2 = HotspotDetector(32, alpha=0.5)
    det2.load_state_arrays(det.state_arrays())
    a, b = det.observe(np.full(32, 7.0)), det2.observe(np.full(32, 7.0))
    assert (a.fired, a.score, a.files) == (b.fired, b.score, b.files)
    assert np.array_equal(det.ewma, det2.ewma)


@pytest.mark.parametrize("make,match", [
    (lambda: ServeConfig(policy="nearest"), "policy"),
    (lambda: ServeConfig(service_ms=0.0), "service_ms"),
    (lambda: ServeConfig(chunk=0), "chunk"),
    (lambda: ServeConfig(hotspot_alpha=0.0), "hotspot_alpha"),
    (lambda: ServeConfig(hotspot_spike_factor=1.0), "spike_factor"),
    (lambda: ServeConfig(hotspot_top_k=0), "top_k"),
    (lambda: SloSpec(availability=1.0), "availability"),
    (lambda: SloSpec(target_ms=0.0), "target_ms"),
    (lambda: ReadRouter(0, ServeConfig()), "n_nodes"),
])
def test_serve_config_validation(make, match):
    with pytest.raises(ValueError, match=match):
        make()
