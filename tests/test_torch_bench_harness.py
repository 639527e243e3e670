"""The port's benchmark harness (``cdrs_tpu_torch/benchmarks/harness.py``)
against the reference's (``cdrs_tpu/benchmarks/harness.py``) on the CPU:
the host-drawn data bit for bit, the timed Lloyd windows against
``kmeans_jax_full`` from a carried init, config 1's keys under the renames
(``numpy_*`` -> ``baseline_*``), the refusals and the memory guard's
arithmetic.  The device path's keys and the entry points at toy configs
are in ``test_torch_bench_entry.py``."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.benchmarks import harness as ref_harness  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402

from cdrs_tpu_torch.benchmarks import harness  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NEW_MODULES = ("harness", "__main__", "ingest", "stream1b", "init_quality", "regress",
               "summary")


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


@pytest.fixture
def toy_configs(monkeypatch):
    """Configs 2-4 cut to toy sizes (their shapes' roles kept: 3 past the
    direct-baseline limit, 4 on a mesh of 8)."""
    c = harness.CONFIGS
    monkeypatch.setitem(c, 2, dataclasses.replace(c[2], n=4096, d=8, k=16, iters=4,
                                                  e2e_iters=3))
    monkeypatch.setitem(c, 3, dataclasses.replace(c[3], n=6000, d=8, k=16, iters=3,
                                                  e2e_iters=2, direct_baseline_limit=4000))
    monkeypatch.setitem(c, 4, dataclasses.replace(c[4], n=8192, d=8, k=16, iters=3,
                                                  e2e_iters=2, direct_baseline_limit=4000))
    monkeypatch.setitem(c, 5, dataclasses.replace(c[5], n=3000, iters=3))
    return c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_data_is_bit_identical_to_the_reference(seed):
    x = harness.synth_blobs_np(5000, 12, 16, seed)
    want = ref_harness.synth_blobs_np(5000, 12, 16, seed)
    assert x.dtype == want.dtype and np.array_equal(x, want)
    assert np.array_equal(harness._init_from_rows(x, 32, seed),
                          ref_harness._init_from_rows(want, 32, seed))
    got = harness._synth_event_batch(np.random.default_rng(seed), 700, 20_000, 1.7e9)
    ref = ref_harness._synth_event_batch(np.random.default_rng(seed), 700, 20_000, 1.7e9)
    assert got.keys() == ref.keys()
    for key in got:
        assert got[key].dtype == ref[key].dtype and np.array_equal(got[key], ref[key]), key


def test_timed_lloyd_windows_match_the_reference_loop():
    """``_time_lloyd`` runs exactly ``iters`` steps in every window, and from
    a carried init its centroids are ``kmeans_jax_full``'s at tol 0."""
    x = harness.synth_blobs_np(8192, 16, 32, 0).astype(np.float32)
    init = harness._init_from_rows(x, 32, 0)
    iters = 8
    _, windows, c = harness._time_lloyd(torch.from_numpy(x), 32, torch.from_numpy(init),
                                        iters, repeats=2)
    assert len(windows) == 2 and all(w > 0 for w in windows)
    want, _, it, _ = kmeans_jax_full(x, 32, tol=0.0, seed=0, init_centroids=init,
                                     max_iter=iters, dtype=np.float32)
    assert int(it) == iters
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(c.double().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_config1_keys_are_the_references_under_the_renames():
    got = harness.run_bench(config=1, device="cpu", quality=False)
    want = ref_harness.run_bench(config=1, quality=False)
    renames = {"numpy_iters_per_sec": "baseline_iters_per_sec",
               "numpy_estimated": "baseline_estimated"}
    assert set(got) == {renames.get(k, k) for k in want} | {"baseline"}
    assert got["metric"] == want["metric"] == "lloyd_iters_per_sec_n10000_d8_k10"
    assert got["backend"] == got["baseline"] == "torch-cpu" and got["vs_baseline"] == 1.0
    assert got["value"] == got["baseline_iters_per_sec"] > 0


@pytest.mark.parametrize("kw,match", [
    (dict(config=2, update="pallas"), "only 'auto' is taken"),
    (dict(config=2, update="scatter"), "the TPU's strategies have no counterpart"),
    (dict(config=2, update="kernel"), "update='kernel': the port has one Lloyd step"),
    (dict(config=1, update="matmul"), "update='matmul': the port has one Lloyd step"),
    (dict(config=1, dtype="bfloat16"), "--dtype selects the device path's points dtype"),
    (dict(config=1, e2e=True), "--e2e measures the device pipeline"),
    (dict(config=5, update="pallas"), "only 'auto' is taken"),
    (dict(config=5, dtype="float32"), "not the streaming fold"),
    (dict(config=2, backend="jax"), "unknown backend"),
])
def test_refusals_name_the_ports_choices(kw, match):
    with pytest.raises(ValueError, match=match):
        harness.run_bench(device="cpu", quality=False, **kw)


@pytest.mark.parametrize("n,itemsize,memory,want", [
    (104_857_600, 2, 80 * 10**9, 52_428_800),     # the bf16 rehearsal on an 80 GB card
    (104_857_600, 4, 80 * 10**9, 26_214_400),
    (10_485_760, 4, 80 * 10**9, 10_485_760),      # config 3 fits whole
    (104_857_600, 2, 16 * 2**30, 13_107_200),     # 5 GiB of a 16 GiB card: the ref's
])
def test_memory_guard_arithmetic(n, itemsize, memory, want):
    budget = int(memory * harness.POINTS_BUDGET_SHARE)
    assert harness.downscaled_rows(n, 128 * itemsize, 1, budget) == want
    # The reference's loop at the same budget gives the same rows.
    n_run = n
    while n_run > 1 and n_run * 128 * itemsize > budget:
        n_run //= 2
    assert n_run == want


def test_memory_guard_downscales_and_names_the_true_n(monkeypatch, toy_configs):
    """With a stated memory size the guard halves the rows until the points
    fit 5/16 of it: ``n_downscaled_from`` holds the config's n, the metric
    name the n that ran, and the baseline is rescaled to it."""
    monkeypatch.setattr(harness, "_device_memory", lambda dev: 200_000)
    out = harness.run_bench(config=3, device="cpu", quality=False)
    # 6000 rows x 8 x 4 B = 192,000 B > 62,500 B: halved twice to 1500.
    assert out["points_budget_bytes"] == 62_500
    assert out["n_downscaled_from"] == 6000 and out["n"] == 1500
    assert out["metric"] == "lloyd_iters_per_sec_n1500_d8_k16"
    assert out["baseline_estimated"]
    e2e = harness.run_bench(config=4, device="cpu", quality=False, e2e=True)
    assert e2e["n_downscaled_from"] == 8192 and e2e["n"] == 1024
    assert e2e["metric"] == "e2e_seconds_to_categories_n1024_d8_k16"
    assert e2e["mesh_downscaled_to"] == {"data": 1} and e2e["mesh"] == {"data": 1}


def test_new_modules_import_with_jax_and_the_jax_package_blocked():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['cdrs_tpu'] = None\n"
            f"for name in {NEW_MODULES!r}:\n"
            "    importlib.import_module('cdrs_tpu_torch.benchmarks.' + name)\n"
            "import cdrs_tpu_torch.cli, cdrs_tpu_torch.scenarios.sweep\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _route_of(call, monkeypatch):
    """Whether each Lloyd step ``call`` makes runs inside
    ``ops/lloyd.rowmajor()`` (B3's route, counted apart on the card)."""
    from cdrs_tpu_torch.control import drift
    from cdrs_tpu_torch.ops import kmeans, kmeans_stream, lloyd

    seen = []

    def spy(*args, **kw):
        seen.append(lloyd._ROWMAJOR.get())
        return lloyd.lloyd_assign_reduce(*args, **kw)

    for mod in (drift, kmeans, kmeans_stream):
        monkeypatch.setattr(mod, "lloyd_assign_reduce", spy)
    call()
    return seen


@pytest.mark.parametrize("path,rowmajor", [
    ("minibatch", True), ("predict", True), ("drift", True), ("kmeans_full", False)])
def test_b3_callers_mark_their_launches(path, rowmajor, monkeypatch):
    from cdrs_tpu_torch.control.drift import detect_drift_torch
    from cdrs_tpu_torch.ops.kmeans import kmeans_full
    from cdrs_tpu_torch.ops.kmeans_stream import MiniBatchKMeans

    x = torch.from_numpy(harness.synth_blobs_np(256, 4, 3, 0))
    mb = MiniBatchKMeans(3, seed=0, device="cpu")
    mb.partial_fit(x)
    calls = {
        "minibatch": lambda: mb.partial_fit(x),
        "predict": lambda: mb.predict(x),
        "drift": lambda: detect_drift_torch(x, mb.centroids.numpy(), np.array([0, 1, 2]),
                                            np.full(3, 1 / 3), 3, device="cpu"),
        "kmeans_full": lambda: kmeans_full(x, 3, seed=0, max_iter=2),
    }
    seen = _route_of(calls[path], monkeypatch)
    assert seen and all(s is rowmajor for s in seen)
