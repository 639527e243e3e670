"""The port's host runtime library (``cdrs_tpu_torch/csrc/host/cdrs_native.cpp``
through ``cdrs_tpu_torch/runtime/native.py``) against the reference's
(``native/cdrs_native.cpp`` through ``cdrs_tpu/runtime/native.py``).

Both libraries are built by g++ from the same source but for the port's
``intern_lookup``, which splits its rows over ``std::thread``s instead of an
OpenMP loop.  The native event engine, its thread-count invariance, the
interning ids and their growth are held equal bit for bit (exact integer
and float64 equality, no tolerance).  ``gen --write_payloads`` is held to
the reference's manifest and to the manifest's sizes.
"""

import os
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.runtime import native as ref_native  # noqa: E402
from cdrs_tpu.sim import access as ref_access  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig  # noqa: E402
from cdrs_tpu_torch.ops import _build  # noqa: E402
from cdrs_tpu_torch.runtime import native  # noqa: E402
from cdrs_tpu_torch.sim import access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

COLUMNS = ("ts", "path_id", "op", "client_id")


@pytest.fixture(scope="module", autouse=True)
def reference_library():
    """The reference builds its library with ``make -C native`` at first
    use; another test worker may be running that make, so a failed load is
    retried while it finishes (the reference caches a failure)."""
    for _ in range(60):
        if ref_native.load() is not None:
            return
        ref_native._load_attempted = False
        time.sleep(1.0)
    pytest.fail("the reference's native library did not build (make -C native)")


def _assert_same_log(got, want):
    for name in COLUMNS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.clients == want.clients


def _workload(n_files, seed):
    return (generate_population(GeneratorConfig(n_files=n_files, seed=seed)),
            ref_generate(jcfg.GeneratorConfig(n_files=n_files, seed=seed)))


def test_library_builds_from_the_package_without_openmp():
    lib = native.load()
    path = _build._target(_build.HOST)
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert _build.HOST_SOURCE.parent.parent.parent.name == "cdrs_tpu_torch"
    assert lib._name == str(path)
    blob = path.read_bytes()
    assert b"libgomp" not in blob and b"GOMP_" not in blob and b"omp_get" not in blob
    assert not any("fopenmp" in f for f in _build.HOST_FLAGS)


@pytest.mark.parametrize("n_files,seed,duration", [(300, 3, 60.0), (1200, 8, 20.0)])
def test_native_engine_equals_the_references(n_files, seed, duration):
    m, rm = _workload(n_files, seed)
    got = access.simulate_access(m, SimulatorConfig(duration_seconds=duration, seed=seed + 1),
                                 engine="native")
    want = ref_access.simulate_access(
        rm, jcfg.SimulatorConfig(duration_seconds=duration, seed=seed + 1), engine="native")
    assert len(got) > 1000
    _assert_same_log(got, want)


def test_native_engine_is_invariant_to_the_thread_count():
    rng = np.random.default_rng(0)
    n = 500
    args = (rng.uniform(0.1, 1.0, n), rng.uniform(0.0, 0.3, n), rng.uniform(0.0, 1.0, n),
            rng.integers(0, 3, n).astype(np.int32), np.arange(4, dtype=np.int32), 90.0, 1.7e9)
    runs = [native.simulate_events_native(*args, seed=7, n_threads=t) for t in (0, 1, 3, 8)]
    want = ref_native.simulate_events_native(*args, seed=7, n_threads=2)
    assert (np.diff(runs[0][0]) >= 0).all()
    for got in runs:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("curve", ["phased", "flash", "shift"])
def test_native_engine_through_the_curves(curve):
    m, rm = _workload(200, 4)
    cfg, rcfg = (SimulatorConfig(duration_seconds=120.0, seed=5),
                 jcfg.SimulatorConfig(duration_seconds=120.0, seed=5))
    if curve == "phased":
        shifts = [(40.0, {"hot": "archival"}, None), (80.0, {"archival": "hot"}, None)]
        got = access.simulate_access_phased(m, cfg, shifts, engine="native")
        want = ref_access.simulate_access_phased(rm, rcfg, shifts, engine="native")
    elif curve == "flash":
        cohort = np.arange(200) % 10 == 0
        kw = dict(cohort=cohort, start=30.0, duration=20.0, boost=10.0, engine="native")
        got = access.simulate_flash_crowd(m, cfg, **kw)
        want = ref_access.simulate_flash_crowd(rm, rcfg, **kw)
    else:
        flip = {"hot": "archival", "archival": "hot"}
        got = access.simulate_access_with_shift(m, cfg, 60.0, flip, engine="native")
        want = ref_access.simulate_access_with_shift(rm, rcfg, 60.0, flip, engine="native")
    _assert_same_log(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_unseeded_native_runs_draw_fresh_seeds():
    m, _ = _workload(100, 2)
    cfg = SimulatorConfig(duration_seconds=60.0, seed=None)
    a = access.simulate_access(m, cfg, engine="native")
    b = access.simulate_access(m, cfg, engine="native")
    assert len(a) and len(b)
    assert len(a) != len(b) or not np.array_equal(a.ts, b.ts)
    with pytest.raises(ValueError, match="unknown simulator engine"):
        access.simulate_access(m, cfg, engine="gpu")


def test_intern_ids_and_growth_equal_the_references():
    names = ["/a", "/b", "/a", "/c", ""]
    got, want = native.InternMap(names), ref_native.InternMap(names)
    assert len(got) == len(want) == 5
    assert got.names_from(0) == want.names_from(0) == names
    blob, off = native._strings_to_blob(["/c", "/a", "/b", "/zzz", ""])
    assert np.array_equal(got.lookup(blob, off), want.lookup(blob, off))
    assert got.lookup(blob, off).tolist() == [3, 0, 1, -1, 4]
    # Growth: unseen names take the next ids in insertion order.
    batch = ["dn9", "/a", "dn7", "dn9", "dn8", "dn7"]
    blob, off = native._strings_to_blob(batch)
    assert np.array_equal(got.insert_lookup(blob, off), want.insert_lookup(blob, off))
    assert got.names_from(5) == want.names_from(5) == ["dn9", "dn7", "dn8"]
    assert len(got) == len(want) == 8
    empty_blob, empty_off = native._strings_to_blob([])
    assert got.lookup(empty_blob, empty_off).shape == (0,)


@pytest.mark.parametrize("n_rows", [65_537, 200_003])
def test_threaded_lookup_equals_the_references(n_rows):
    """Past 65,536 rows the port's lookup splits over threads (the
    reference's over OpenMP): ids equal row for row, misses included."""
    rng = np.random.default_rng(n_rows)
    vocab = [f"/data/synth/synth_{i}.bin" for i in range(50_000)]
    pick = rng.integers(0, 60_000, n_rows)
    keys = [f"/data/synth/synth_{i}.bin" for i in pick]
    blob, off = native._strings_to_blob(keys)
    got = native.InternMap(vocab).lookup(blob, off)
    want = ref_native.InternMap(vocab).lookup(blob, off)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.where(pick < 50_000, pick, -1))


def test_gen_write_payloads_keeps_the_manifest(tmp_path, monkeypatch):
    from cdrs_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    assert cli.main(["gen", "--n", "12", "--seed", "3", "--hdfs_dir", "/data/synth",
                     "--min_size", "10", "--max_size", "300", "--out_manifest", "m.csv",
                     "--write_payloads"]) == 0
    assert cli.main(["gen", "--n", "12", "--seed", "3", "--hdfs_dir", "/data/synth",
                     "--min_size", "10", "--max_size", "300",
                     "--out_manifest", "plain.csv"]) == 0
    assert open("m.csv").read() == open("plain.csv").read()
    want = ref_generate(jcfg.GeneratorConfig(n_files=12, seed=3, base_dir="/data/synth",
                                             min_size=10, max_size=300))
    want.write_csv(str(tmp_path / "ref.csv"))
    assert open("m.csv").read() == open("ref.csv").read()
    from cdrs_tpu_torch.io.events import Manifest

    m = Manifest.read_csv("m.csv")
    for p, size in zip(m.paths, m.size_bytes):
        local = os.path.join(tmp_path, p.lstrip("/"))
        assert os.path.getsize(local) == int(size)
