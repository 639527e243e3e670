"""The idle share, the idle gaps, the p95 and the roofline on synthetic
traces."""

from __future__ import annotations

import pytest

from portbench import spec
from portbench.readers import Context
from portbench.trace import Trace, merged
from portbench.traffic import Window


def _trace():
    kernels = [("lloyd_wgmma_kernel", 10.0, 40.0), ("add", 30.0, 50.0),
               ("lloyd_wgmma_kernel", 70.0, 90.0), ("before", 0.0, 5.0)]
    spans = [("portbench.window", 10.0, 110.0), ("portbench.solve", 10.0, 95.0),
             ("portbench.solve", 95.0, 110.0)]
    return Trace(kernels=kernels, spans=spans, window=(10.0, 110.0))


def test_merged_clips_and_joins():
    assert merged(_trace().kernels, 10.0, 110.0) == [(10.0, 50.0), (70.0, 90.0)]


def test_idle_share_and_gaps():
    win = Window(launches={"before": {"b1": 0}, "after": {"b1": 2}})
    ctx = Context(window=win, trace=_trace())
    assert ctx.idle_share() == pytest.approx(40.0)
    gaps = _trace().idle_gaps()
    assert gaps[0] == ["portbench.solve", pytest.approx(20e-6)]
    assert [g[0] for g in gaps] == ["portbench.solve", "portbench.solve"]


def test_roofline_is_missing_never_zero_when_launches_disagree():
    win = Window(launches={"before": {"b1": 0}, "after": {"b1": 3}})
    win.work["b1"] = [(1_048_576, 32, 128, False, 3)]
    ctx = Context(window=win, trace=_trace(), device_name="NVIDIA H100 80GB HBM3")
    assert ctx.roofline("b1", ("lloyd_wgmma_kernel",)) is None
    win.launches["after"]["b1"] = 2
    win.work["b1"] = [(1_048_576, 32, 128, False, 2)]
    share = ctx.roofline("b1", ("lloyd_wgmma_kernel",))
    assert share == pytest.approx(100.0 * 2 * 0.0523e-3 / 50e-6, rel=1e-3)


def test_roofline_is_missing_when_the_wrapper_counts_other_calls_than_the_units_ask():
    win = Window(launches={"before": {"b1": 0}, "after": {"b1": 2}})
    win.work["b1"] = [(1_048_576, 32, 128, False, 2), (1_048_576, 32, 128, True, 1)]
    ctx = Context(window=win, trace=_trace(), device_name="NVIDIA H100 80GB HBM3")
    assert ctx.roofline("b1", ("lloyd_wgmma_kernel",)) is None


def test_roofline_needs_a_trace_and_a_known_card():
    win = Window(launches={"before": {"b1": 0}, "after": {"b1": 2}})
    assert Context(window=win).roofline("b1", ("x",)) is None
    assert Context(window=win, trace=_trace(), device_name="cpu").roofline("b1", ("x",)) is None


def test_p95_and_rates():
    win = Window(t0=0.0, t1=10.0)
    win.units = [{"send": i, "done": i + (1.0 if i < 19 else 3.0), "iters": 5} for i in range(20)]
    p95 = spec.reader("e2e", "decide_p95_s").read(win)
    assert p95 == pytest.approx(1.0 + 0.05 * 2.0)
    assert spec.reader("e2e", "decide_s").read(win) == pytest.approx(0.5)
    assert spec.reader("e2e", "lloyd_iter_per_s").read(win) == pytest.approx(10.0)


def test_reduce_reads_the_window_and_spans_of_a_profile():
    import torch

    from portbench.trace import Capture

    cap = Capture(False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.window"):
            with cap.span("portbench.solve"), torch.profiler.record_function("portbench.solve"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    from portbench.trace import reduce

    tr = reduce(prof)
    assert tr.window[1] > tr.window[0] >= 0 and tr.kernels == []
    assert [s[0] for s in tr.spans] == ["portbench.window", "portbench.solve"]
