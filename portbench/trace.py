"""The traced window: ``torch.profiler`` around the whole window, the
benchmark's own spans inside it, and the reduction of the device trace to
busy time, idle gaps and time by kernel.

The capture synchronises, keeps the profiler open ``PAD_S`` more and only
then stops, so that the profiler's records of long launches near the end
of the window fall inside its capture (they were seen dropped as out of
range without it).  Spans are ``record_function`` ranges named
``portbench.<what>``: the window, and each call the traffic makes into the
program.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

#: Seconds the profiler stays open after the window's last synchronise.
PAD_S = 0.2
WINDOW = "portbench.window"


@dataclass
class Trace:
    """Device activities and benchmark spans of one capture, in
    microseconds on the profiler's clock."""

    kernels: list = field(default_factory=list)     # (name, start, end)
    spans: list = field(default_factory=list)       # (name, start, end)
    window: tuple = (0.0, 0.0)

    def busy_us(self) -> float:
        """Length of the union of the device activities inside the window."""
        return sum(b - a for a, b in merged(self.kernels, *self.window))

    def count(self, patterns) -> int:
        return sum(1 for name, _, _ in self.kernels if matches(name, patterns))

    def device_us(self, patterns) -> float:
        return sum(b - a for name, a, b in self.kernels if matches(name, patterns))

    def top_ops(self, limit: int = 10) -> list:
        by: dict[str, float] = {}
        for name, a, b in self.kernels:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:limit]
        return [[name, us / 1e6] for name, us in top]

    def idle_gaps(self, limit: int = 10) -> list:
        """The longest gaps between device activities inside the window, each
        named by the innermost benchmark span at its middle."""
        w0, w1 = self.window
        busy = merged(self.kernels, w0, w1)
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for a, b in gaps[:limit]:
            mid = 0.5 * (a + b)
            inside = [s for s in self.spans if s[1] <= mid <= s[2] and s[0] != WINDOW]
            name = min(inside, key=lambda s: s[2] - s[1])[0] if inside else "outside any span"
            out.append([name, (b - a) / 1e6])
        return out


def matches(name: str, patterns) -> bool:
    return any(p in name for p in patterns)


def merged(intervals, lo: float, hi: float) -> list:
    """The union of ``(name, start, end)`` intervals clipped to [lo, hi], as
    sorted disjoint (start, end) pairs."""
    out: list = []
    for a, b in sorted((max(a, lo), min(b, hi)) for _, a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Capture:
    """The profiler around the window when ``active``; null contexts
    otherwise.  ``trace`` holds the reduced capture after the window."""

    def __init__(self, active: bool, device=None):
        self.active = bool(active)
        self.device = device
        self.trace: Trace | None = None
        self.reduce_s = 0.0

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.active:
            yield
            return
        import torch

        torch.cuda.synchronize(self.device)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
            torch.cuda.synchronize(self.device)
            time.sleep(PAD_S)
        t = time.perf_counter()
        self.trace = reduce(prof)
        self.reduce_s = time.perf_counter() - t


def reduce(prof) -> Trace:
    """The device activities and the benchmark's spans of a finished profile,
    read from the profiler's raw records (building its Python event tree
    takes minutes for a window of a million launches)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    tr = Trace()
    for ev in results.events():
        name = ev.name()
        a, b = (ev.start_ns() - t0) / 1e3, (ev.end_ns() - t0) / 1e3
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith("portbench."):    # the spans' device-side copies
                tr.kernels.append((name, a, b))
        elif name.startswith("portbench."):
            tr.spans.append((name, a, b))
            if name == WINDOW:
                tr.window = (a, b)
    return tr
