"""Per-kernel work and first-launch time (``cdrs_tpu_torch/obs/kprof.py``),
the kernel-build counter (``ops/_build.py``) and the roofline rows of the
stream (``obs/aggregate.roofline_rows``).

``kernel_cost`` at smoke phase 2's shapes reproduces the bounds of the
kernel table (B1 0.0149, B2 0.0179, B3 0.0019 ms on an H100; B1's general
path 0.0523, 0.0200 in bf16, and 1.6667 ms at 1M x 128, k = 1024; B2's
general path 0.1621, 1.6157 and 4.0697 ms at 1M, 10,485,760 and 52,428,800
(bf16) x 128, k = 1024, and 0.0179 ms at 2,499,997 x 5, k = 64; B2's general
form, the float sums, 0.1617 and 0.0815 (bf16) ms at 1M x 128, k = 1024 and
0.0179 ms at 2,499,997 x 5, k = 8); on the CPU a
kernel event has ``seconds`` null and its roofline row says "not
measured"; a build found on disk counts nothing; and the wrappers give
bit-identical results with the instrument on or off."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cdrs_tpu_torch.obs import JsonlSink, Telemetry, kprof, read_events  # noqa: E402
from cdrs_tpu_torch.obs.aggregate import collect, roofline_rows  # noqa: E402
from cdrs_tpu_torch.obs.metrics_cli import summarize_events  # noqa: E402
from cdrs_tpu_torch.ops import _build  # noqa: E402
from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce, sharded_assign_reduce  # noqa: E402
from cdrs_tpu_torch.ops.seg_count import label_threshold_count  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
N_MAIN = 2_500_000 - 3      # smoke phase 2's pipeline rows
MB_BATCH = 262_144          # its mini-batch rows
WIDE = 1 << 20              # its wide B1 shapes' rows


@pytest.fixture(autouse=True)
def _fresh_signatures():
    kprof.clear_cache()
    yield
    kprof.clear_cache()


@pytest.mark.parametrize("kernel, kw, bound_ms, by", [
    ("lloyd_assign_reduce", dict(n=N_MAIN, d=5, k=8, n_valid=N_MAIN), 0.0149, "bytes"),
    ("label_threshold_count", dict(n=N_MAIN, d=5, k=8, with_global=True), 0.0179, "bytes"),
    ("lloyd_assign_reduce", dict(n=MB_BATCH, d=5, k=8, n_valid=MB_BATCH - 1000,
                                 with_labels=True), 0.0019, "bytes"),
    # B1's general path at smoke phase 2's wide shapes: f32 work bound by
    # f32-accurate tensor-core products (165 TFLOP/s), bf16 by its bytes.
    ("lloyd_assign_reduce", dict(n=WIDE, d=32, k=128, n_valid=WIDE - 5), 0.0523,
     "operations"),
    ("lloyd_assign_reduce", dict(n=WIDE, d=32, k=128, n_valid=WIDE - 5, dtype="bfloat16"),
     0.0200, "bytes"),
    ("lloyd_assign_reduce", dict(n=WIDE, d=128, k=1024, n_valid=WIDE), 1.6667, "operations"),
    # B2's general path at smoke phase 2's shapes: config 3's width at 1M
    # rows and at its whole rows, the config-4 rehearsal's bf16 rows on an
    # 80 GB card, entry()'s k at the main path's width.
    ("label_threshold_count", dict(n=WIDE, d=128, k=1024), 0.1621, "bytes"),
    ("label_threshold_count", dict(n=10_485_760, d=128, k=1024), 1.6157, "bytes"),
    ("label_threshold_count", dict(n=52_428_800, d=128, k=1024, dtype="bfloat16"), 4.0697,
     "bytes"),
    ("label_threshold_count", dict(n=N_MAIN, d=5, k=64), 0.0179, "bytes"),
    # B2's general form (float y) at smoke phase 2's shapes.
    ("label_segment_sum", dict(n=WIDE, d=128, k=1024), 0.1617, "bytes"),
    ("label_segment_sum", dict(n=WIDE, d=128, k=1024, dtype="bfloat16"), 0.0815, "bytes"),
    ("label_segment_sum", dict(n=N_MAIN, d=5, k=8), 0.0179, "bytes"),
], ids=["B1", "B2", "B3", "B1-1Mx32-k128-f32", "B1-1Mx32-k128-bf16", "B1-1Mx128-k1024-f32",
        "B2-1Mx128-k1024", "B2-10Mx128-k1024", "B2-52Mx128-k1024-bf16", "B2-2.5Mx5-k64",
        "B2sum-1Mx128-k1024-f32", "B2sum-1Mx128-k1024-bf16", "B2sum-2.5Mx5-k8"])
def test_kernel_cost_reproduces_the_kernel_table_bounds(kernel, kw, bound_ms, by):
    cost = kprof.kernel_cost(kernel, **kw)
    secs, bound_by = kprof.bound_seconds(cost, kprof.resolve_peaks(H100, cost["dtype"]))
    assert bound_by == by and round(secs * 1e3, 4) == bound_ms


def test_kernel_cost_counts_each_byte_once():
    b1 = kprof.kernel_cost("lloyd_assign_reduce", n=10, d=3, k=2, n_valid=7)
    assert b1 == {"flops": 2.0 * 10 * 2 * 3 + 7 * 3,
                  "bytes": 10 * 3 * 4 + 2 * 3 * 8 + 2 * 8, "dtype": "float32"}
    b3 = kprof.kernel_cost("lloyd_assign_reduce", n=10, d=3, k=2, dtype="bfloat16",
                           with_labels=True)
    assert b3["bytes"] == 10 * 3 * 2 + 10 * 4 + 2 * 3 * 8 + 2 * 8
    b2 = kprof.kernel_cost("label_threshold_count", n=10, d=3, k=2, with_global=False)
    assert b2 == {"flops": 2.0 * 10 * 3, "bytes": 10 * 3 * 4 + 10 * 4 + 2 * 2 * 3 * 4 * 2,
                  "dtype": "float32"}
    with pytest.raises(ValueError, match="unknown kernel"):
        kprof.kernel_cost("nope", n=1, d=1, k=1)


@pytest.mark.parametrize("kw, n_bytes", [
    (dict(n=WIDE, d=128, k=1024), 541_589_504),
    (dict(n=WIDE, d=128, k=1024, dtype="bfloat16"), 273_154_048),
    (dict(n=N_MAIN, d=5, k=8), 60_000_088),
])
def test_kernel_cost_of_the_segment_sum(kw, n_bytes):
    """y and the labels read once, the (k, d) float32 sums written once;
    one add an element."""
    cost = kprof.kernel_cost("label_segment_sum", **kw)
    assert cost == {"flops": float(kw["n"] * kw["d"]), "bytes": float(n_bytes),
                    "dtype": kw.get("dtype", "float32")}


def test_resolve_peaks_knows_only_the_h100():
    assert kprof.resolve_peaks(H100) == (495e12 / 3, 3.35e12)
    assert kprof.resolve_peaks(H100, "bfloat16") == (989e12, 3.35e12)
    assert kprof.resolve_peaks("cpu") is None and kprof.resolve_peaks(None) is None


def _inputs(seed=0, n=4000, d=5, k=8):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((n, d), dtype=np.float32))
    c = torch.from_numpy(rng.random((k, d), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(-1, k, n).astype(np.int32))
    thr = torch.from_numpy(rng.random((2, k, d), dtype=np.float32))
    gthr = torch.from_numpy(rng.random((2, d), dtype=np.float32))
    return x, c, labels, thr, gthr


def _calls(x, c, labels, thr, gthr):
    return (lloyd_assign_reduce(x, c, 3999, with_labels=True),
            lloyd_assign_reduce(x, c, 3999, with_labels=False),
            label_threshold_count(x, labels, thr, gthr))


@pytest.mark.parametrize("seed", [0, 1])
def test_results_are_bit_identical_with_the_instrument_on(tmp_path, seed):
    args = _inputs(seed)
    off = _calls(*args)
    with Telemetry(JsonlSink(str(tmp_path / "t.jsonl"))) as tel:
        on = _calls(*args)
        on_again = _calls(*args)
    for a, b in zip(off, on):
        for u, v in zip(a, b):
            assert (u is None and v is None) or torch.equal(u, v)
    assert tel.counters["kernel.calls.lloyd_assign_reduce"] == 4
    assert tel.counters["kernel.calls.label_threshold_count"] == 2
    events = [e for e in read_events(str(tmp_path / "t.jsonl")) if e["kind"] == "kernel"]
    # One event per (kernel, signature): labels on and off are two signatures.
    assert sorted(e["kernel"] for e in events) == ["label_threshold_count",
                                                   "lloyd_assign_reduce",
                                                   "lloyd_assign_reduce"]
    for e in events:
        assert e["event"] == "exec" and e["seconds"] is None and e["device"] == "cpu"
        assert e["flops"] > 0 and e["bytes"] > 0 and isinstance(e["sig"], int)
    del on_again


def test_kprof_off_counts_nothing(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with Telemetry(JsonlSink(p), kprof=False) as tel:
        _calls(*_inputs())
    assert tel.counters == {}
    assert not [e for e in read_events(p) if e["kind"] == "kernel"]


def test_cpu_rows_say_not_measured(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with Telemetry(JsonlSink(p)):
        _calls(*_inputs())
    digest = collect(read_events(p))
    rows = roofline_rows(digest)
    assert len(rows) == 3 and all(r["exec_seconds"] is None for r in rows)
    assert all("peak_fraction" not in r and "gbps" not in r for r in rows)
    out = io.StringIO()
    summarize_events(read_events(p), out=out)
    lines = [ln for ln in out.getvalue().splitlines() if "time not measured" in ln]
    assert len(lines) == 3
    # With the peaks given, the bound is stated and the share still is not.
    rows = roofline_rows(digest, peak_flops=67e12, peak_gbps=3350.0)
    assert all(r["bound"] in ("bytes", "operations") and "peak_fraction" not in r
               for r in rows)


def test_roofline_share_of_a_timed_launch():
    cost = kprof.kernel_cost("lloyd_assign_reduce", n=N_MAIN, d=5, k=8)
    events = [{"kind": "meta", "run": {"device_name": H100}},
              {"kind": "kernel", "event": "exec", "kernel": "lloyd_assign_reduce",
               "sig": 7, **cost, "device": H100, "seconds": 0.0000298},
              {"kind": "kernel", "event": "exec", "kernel": "lloyd_assign_reduce",
               "sig": 7, **cost, "device": H100, "seconds": 0.0000400}]
    (row,) = roofline_rows(collect(events))
    assert row["exec_seconds"] == 0.0000298   # the fastest launch of the signature
    assert row["bound"] == "bytes"
    assert row["peak_fraction"] == pytest.approx(cost["bytes"] / 3.35e12 / 0.0000298)
    assert row["gbps"] == pytest.approx(cost["bytes"] / 0.0000298 / 1e9)


def test_mesh_calls_stamp_devices_and_collective_bytes(tmp_path):
    from cdrs_tpu_torch.parallel.mesh import make_mesh

    x, c, *_ = _inputs()
    mesh = make_mesh(4, device="cpu")
    n_loc, shards = mesh.split(x)
    p = str(tmp_path / "t.jsonl")
    with Telemetry(JsonlSink(p)):
        sharded_assign_reduce(mesh, shards, n_loc, c, x.shape[0])
        lloyd_assign_reduce(x, c)
    events = [e for e in read_events(p) if e["kind"] == "kernel"]
    stamped = [e for e in events if "devices" in e]
    assert len(events) == 2 and len(stamped) == 1
    assert stamped[0]["devices"] == 4
    assert stamped[0]["collective_bytes_per_iter"] == 2 * 3 * 8 * (5 + 1) * 4


@pytest.mark.parametrize("cached", [True, False], ids=["hit", "miss"])
def test_build_counter(tmp_path, monkeypatch, cached):
    """A library already loaded (or on disk) builds nothing and counts 0;
    an ``nvcc`` run counts one build and its wall time."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    if cached:
        _build._target("lloyd").write_bytes(b"")
    else:
        fake = tmp_path / "nvcc"
        fake.write_text("#!/bin/sh\nwhile [ \"$1\" != \"-o\" ]; do shift; done\n"
                        ": > \"$2\"\n")
        fake.chmod(0o755)
        monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    with Telemetry() as tel:
        _build.load("lloyd")
        _build.load("lloyd")
    if cached:
        assert tel.counters == {} and "kernel.build.seconds" not in tel.histograms
    else:
        assert tel.counters == {"kernel.builds.lloyd": 1.0}
        assert len(tel.histograms["kernel.build.seconds"]) == 1
