"""What a metric's reader reads: the window, the reduced trace, the
kernels' work and the wrappers' launch counters; and the arithmetic the
readers share.  A reader returns None where it finds nothing to read, and
says why on standard error."""

from __future__ import annotations

import sys
from dataclasses import dataclass

from . import cost


@dataclass
class Context:
    window: object            # traffic.Window
    trace: object = None      # trace.Trace (traced runs)
    device_name: str = ""
    dtype: str = "float32"

    def note(self, msg: str) -> None:
        print(f"portbench: {msg}", file=sys.stderr)

    def launches(self, counter: str) -> int:
        w = self.window.launches
        return w["after"][counter] - w["before"][counter]

    def peaks(self):
        return cost.peaks(self.device_name, self.dtype)

    def bound_s(self, kernel: str) -> float:
        """The least seconds of the window's calls of ``kernel`` ("b1", "b2")."""
        pk = self.peaks()
        total = 0.0
        for n, d, k, flag, calls in self.window.work[kernel]:
            if kernel == "b1":
                ops, n_bytes = cost.lloyd_cost(n, d, k, self.dtype, with_labels=flag)
            else:
                ops, n_bytes = cost.seg_count_cost(n, d, k, self.dtype, with_global=flag)
            total += calls * cost.bound_seconds(ops, n_bytes, pk)
        return total

    def roofline(self, kernel: str, patterns) -> float | None:
        """Share (%) of the kernel's bound over its device time in the trace;
        None where the wrapper counted another number of launches than the
        calls the bound is made of, or the trace holds another number than
        the wrapper counted, or none."""
        if self.trace is None or self.peaks() is None:
            return None
        calls = sum(c[-1] for c in self.window.work[kernel])
        want, seen = self.launches(kernel), self.trace.count(patterns)
        if want != calls:
            self.note(f"{kernel}: the wrapper counted {want} launches, the window's units ask "
                      f"for {calls} calls; its roofline is left out")
            return None
        if seen != want:
            self.note(f"{kernel}: the trace holds {seen} launches of {list(patterns)}, the "
                      f"wrapper counted {want}; its roofline is left out")
            return None
        dev_s = self.trace.device_us(patterns) / 1e6
        if want == 0 or dev_s <= 0:
            return None
        return 100.0 * self.bound_s(kernel) / dev_s

    def idle_share(self) -> float | None:
        """Share (%) of the traced window in which no device activity ran."""
        if self.trace is None:
            return None
        w0, w1 = self.trace.window
        if w1 <= w0:
            return None
        return 100.0 * (1.0 - self.trace.busy_us() / (w1 - w0))

    def mean_span(self, key: str) -> float | None:
        vals = [u[key] for u in self.window.units if key in u]
        return sum(vals) / len(vals) if vals else None
