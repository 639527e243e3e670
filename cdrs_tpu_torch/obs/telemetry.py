"""The ambient instrument: hierarchical spans, counters, gauges and
histograms over one JSONL sink (``cdrs_tpu/obs/telemetry.py``).

* **Ambient activation.**  ``with Telemetry(...)`` installs the instance as
  the process-wide active instrument; ``current()`` returns it (or None)
  from any depth of the stack, so the kernel wrappers and the stage timers
  instrument themselves without a handle threaded through every layer, and
  a process without an instrument pays one ``is None`` check.
* **Hierarchical spans.**  Each thread carries its own span stack, so a
  producer thread's spans nest under its own root.  Durations are
  ``time.perf_counter`` (monotonic), timestamps ``time.time``.  A span is
  emitted on exit (children before parents); ``id``/``parent`` let readers
  rebuild the tree.
* **In-memory aggregates.**  Counters, gauges and histograms accumulate on
  the instance too, so in-process consumers read final values without
  parsing the stream.
* **Kernel calls.**  ``record_kernel_call(kernel, signature)`` counts
  ``kernel.calls.<kernel>`` and reports whether the (shape, dtype, static
  config) signature is new in this process.  The reference's per-signature
  recompile counter has no counterpart: a CUDA kernel is built once per
  source, and ``ops/_build`` counts those builds (``kernel.builds.<source>``).

Event kinds, names and the histogram ladder are the reference's, so its
readers and the port's read each other's streams.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import threading
import time

from .sink import JsonlSink

__all__ = ["Telemetry", "Span", "current", "run_metadata", "HIST_BUCKETS",
           "HIST_RAW_CAP", "HIST_BULK_SAMPLE_CAP", "bucket_counts"]

#: Log-spaced bucket ladder of every ``histogram_bulk`` producer and
#: reader: ``10^(k/4)`` for k in -32..40 (1e-8 .. 1e10).  Values above the
#: top bucket land in +Inf; values at or below the bottom bound (0 and
#: negatives too) in the first bucket.
HIST_BUCKETS: tuple[float, ...] = tuple(10.0 ** (k / 4.0) for k in range(-32, 41))

#: Raw per-key sample cap of ``Telemetry.histogram``: past it the list is
#: decimated 2:1 (uniform stride).
HIST_RAW_CAP = 8192

#: Bucketing cap of one ``histogram_bulk`` call: past it the buckets come
#: from a uniform 1-in-stride subsample scaled back to the exact count.
HIST_BULK_SAMPLE_CAP = 32768


def bucket_counts(values) -> "tuple[list, int, float, float, float]":
    """(sparse ``[le, count]`` pairs, count, sum, min, max) of ``values``
    on the ``HIST_BUCKETS`` ladder; the overflow bucket's ``le`` is
    ``"+Inf"``.  ``count`` is the exact sample count; above
    ``HIST_BULK_SAMPLE_CAP`` samples the split comes from a uniform
    subsample scaled up with largest-remainder rounding, so the bucket
    counts still add up to ``count``.  ``sum`` scales with the subsample;
    min/max are exact."""
    import numpy as np

    v = np.asarray(values, dtype=np.float64).ravel()
    n = int(v.size)
    if n == 0:
        return [], 0, 0.0, 0.0, 0.0
    vmin, vmax = float(v.min()), float(v.max())
    sub = v
    if n > HIST_BULK_SAMPLE_CAP:
        stride = -(-n // HIST_BULK_SAMPLE_CAP)
        sub = v[::stride]
    ladder = np.asarray(HIST_BUCKETS)
    idx = np.searchsorted(ladder, sub, side="left")
    counts = np.bincount(idx, minlength=len(HIST_BUCKETS) + 1)
    total = float(n) / float(sub.size)
    if sub.size != n:
        scaled = counts * total
        floors = np.floor(scaled).astype(np.int64)
        short = n - int(floors.sum())
        if short > 0:
            order = np.argsort(-(scaled - floors), kind="stable")[:short]
            floors[order] += 1
        counts = floors
    sparse: list = []
    for i in np.flatnonzero(counts):
        le = "+Inf" if i == len(HIST_BUCKETS) else float(ladder[i])
        sparse.append([le, int(counts[i])])
    return (sparse, n, float(sub.sum()) * total, vmin, vmax)


#: Active instruments (module-global, not a contextvar: worker threads see
#: the instrument of the thread that activated it).
_ACTIVE: list["Telemetry"] = []

#: Seen signatures per instrumented entry point, for the life of the process.
_KERNEL_SIGS: dict[str, set] = {}

#: ``nvidia-smi``'s power limit of each card, read once per process.
_POWER_LIMITS: list | None = None


def current() -> "Telemetry | None":
    """The active instrument, or None when telemetry is off."""
    return _ACTIVE[-1] if _ACTIVE else None


def _power_limits() -> list | None:
    """``power.limit`` of every card as ``nvidia-smi`` prints it (say
    "700.00 W"), or None where the command is absent or fails."""
    global _POWER_LIMITS
    if _POWER_LIMITS is None:
        smi = shutil.which("nvidia-smi")
        if smi is None:
            return None
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        if out.returncode != 0:
            return None
        _POWER_LIMITS = [line.strip() for line in out.stdout.splitlines() if line.strip()]
    return _POWER_LIMITS


def run_metadata() -> dict:
    """The environment stamp: interpreter, numpy, torch and its CUDA
    version, and, once the process has initialised CUDA, the card's name
    (``device_name``, what the roofline peak lookup reads), the card count
    and the power limit.  Never initialises CUDA itself: a CPU run must not
    pay for it."""
    meta: dict = {"python": sys.version.split()[0], "platform": sys.platform}
    np = sys.modules.get("numpy")
    if np is not None:
        meta["numpy"] = getattr(np, "__version__", None)
    torch = sys.modules.get("torch")
    if torch is not None:
        meta["torch"] = torch.__version__
        meta["torch_cuda"] = torch.version.cuda
        if torch.cuda.is_initialized():
            count = torch.cuda.device_count()
            meta["device_count"] = count
            meta["device_name"] = torch.cuda.get_device_name(0) if count else None
            limits = _power_limits()
            meta["power_limit"] = limits[0] if limits else None
    return meta


class Span:
    """One timed region; the context manager ``Telemetry.span`` hands out."""

    __slots__ = ("tel", "name", "attrs", "id", "parent", "t_wall", "_t0", "dur")

    def __init__(self, tel: "Telemetry", name: str, attrs: dict):
        self.tel = tel
        self.name = name
        self.attrs = attrs
        self.id = tel._next_id()
        self.parent: int | None = None
        self.dur = 0.0

    def __enter__(self) -> "Span":
        stack = self.tel._stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.dur = time.perf_counter() - self._t0
        stack = self.tel._stack()
        if stack and stack[-1] is self:
            stack.pop()
        event = {"kind": "span", "name": self.name, "id": self.id, "parent": self.parent,
                 "t": self.t_wall, "dur": self.dur}
        if self.attrs:
            event["attrs"] = self.attrs
        self.tel._emit(event)
        if self.tel.device_memory:
            from .devtools import device_memory_gauges

            device_memory_gauges(self.tel, stage=self.name)


class Telemetry:
    """The instrument.  ``with Telemetry(sink=JsonlSink(path)):`` activates
    it; everything instrumented against ``obs.current()`` then emits."""

    def __init__(self, sink: JsonlSink | None = None, *, kmeans_trace: bool = True,
                 device_memory: bool = False, kprof: bool = True, audit: bool = True,
                 meta: bool = True):
        self.sink = sink
        #: Per-instrument id stamped on every event: span ids restart per
        #: process and the sink appends, so readers tell runs apart by it.
        self.run_id = f"{os.getpid():x}-{time.monotonic_ns():x}"
        #: Per-Lloyd-iteration convergence records from ``ops/kmeans``.
        self.kmeans_trace = kmeans_trace
        #: ``torch.cuda.memory_stats`` gauges at every span exit.
        self.device_memory = device_memory
        #: Per-kernel work and first-launch time (``obs/kprof.py``) at the
        #: kernel wrappers.
        self.kprof = kprof
        #: Per-window decision-quality audit of the controller (``obs/audit.py``).
        self.audit = audit
        self._meta = meta
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, list[float]] = {}
        #: Decimation stride per raw histogram: sample i is kept iff
        #: i % stride == 0.
        self._hist_stride: dict[str, int] = {}
        self._hist_seen: dict[str, int] = {}
        #: ``histogram_bulk`` aggregates: name -> {"count", "sum", "min",
        #: "max", "buckets": {le: count}}.
        self.hist_buckets: dict[str, dict] = {}
        self._local = threading.local()
        self._id_lock = threading.Lock()
        self._ids = 0
        self._agg_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "Telemetry":
        _ACTIVE.append(self)
        if self._meta:
            self._emit({"kind": "meta", "t": time.time(), "run": run_metadata()})
        return self

    def __exit__(self, *exc) -> None:
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        if self._meta:
            # Second stamp at exit: the entry stamp precedes the command's
            # first CUDA call, so only this one carries the card's name.
            # Readers take the last meta event.
            self._emit({"kind": "meta", "t": time.time(), "run": run_metadata()})
        if self.sink is not None:
            self.sink.close()

    # -- plumbing ----------------------------------------------------------
    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_id(self) -> int:
        with self._id_lock:
            self._ids += 1
            return self._ids

    def _emit(self, event: dict) -> None:
        if self.sink is not None:
            event.setdefault("run", self.run_id)
            self.sink.emit(event)

    def current_span_id(self) -> int | None:
        stack = self._stack()
        return stack[-1].id if stack else None

    # -- instruments -------------------------------------------------------
    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def emit_span(self, name: str, dur: float, *, parent: int | None = None,
                  **attrs) -> int:
        """Emit one already-measured region as a span event (the schema and
        id allocator of :class:`Span`) under ``parent`` (default: the open
        span) and return its id."""
        sid = self._next_id()
        if parent is None:
            parent = self.current_span_id()
        event = {"kind": "span", "name": name, "id": sid, "parent": parent,
                 "t": time.time(), "dur": float(dur)}
        if attrs:
            event["attrs"] = attrs
        self._emit(event)
        return sid

    def counter_inc(self, name: str, delta: float = 1.0) -> float:
        with self._agg_lock:
            value = self.counters.get(name, 0.0) + float(delta)
            self.counters[name] = value
        self._emit({"kind": "counter", "name": name, "t": time.time(),
                    "delta": float(delta), "value": value})
        return value

    def gauge(self, name: str, value: float) -> None:
        with self._agg_lock:
            self.gauges[name] = float(value)
        self._emit({"kind": "gauge", "name": name, "t": time.time(), "value": float(value)})

    def histogram(self, name: str, value: float) -> None:
        """One sample: a ``hist`` event, and a bounded raw list in memory
        (2:1 decimation past ``HIST_RAW_CAP``).  Producers of thousands of
        samples a call use ``histogram_bulk``."""
        with self._agg_lock:
            lst = self.histograms.setdefault(name, [])
            seen = self._hist_seen.get(name, 0)
            stride = self._hist_stride.get(name, 1)
            if seen % stride == 0:
                lst.append(float(value))
                if len(lst) >= HIST_RAW_CAP:
                    del lst[1::2]
                    self._hist_stride[name] = stride * 2
            self._hist_seen[name] = seen + 1
        self._emit({"kind": "hist", "name": name, "t": time.time(), "value": float(value)})

    def histogram_bulk(self, name: str, values) -> None:
        """A batch of samples as one ``hist_bulk`` event on the
        ``HIST_BUCKETS`` ladder (count, sum, min, max, sparse buckets),
        merged into ``hist_buckets``."""
        sparse, n, total, vmin, vmax = bucket_counts(values)
        if n == 0:
            return
        with self._agg_lock:
            agg = self.hist_buckets.setdefault(
                name, {"count": 0, "sum": 0.0, "min": vmin, "max": vmax, "buckets": {}})
            agg["count"] += n
            agg["sum"] += total
            agg["min"] = min(agg["min"], vmin)
            agg["max"] = max(agg["max"], vmax)
            for le, c in sparse:
                key = float("inf") if le == "+Inf" else float(le)
                agg["buckets"][key] = agg["buckets"].get(key, 0) + c
        self._emit({"kind": "hist_bulk", "name": name, "t": time.time(), "count": n,
                    "sum": total, "min": vmin, "max": vmax, "buckets": sparse})

    # -- kernel hooks ------------------------------------------------------
    def record_kernel_call(self, kernel: str, signature) -> bool:
        """Count one call of an instrumented entry point as
        ``kernel.calls.<kernel>``; returns whether its ``signature`` (shapes,
        dtypes, static configuration) is new in this process.  Nothing is
        compiled per signature here, so no recompile counter follows from
        it (``ops/_build`` counts the kernels' builds)."""
        seen = _KERNEL_SIGS.setdefault(kernel, set())
        new = signature not in seen
        if new:
            seen.add(signature)
        self.counter_inc(f"kernel.calls.{kernel}")
        return new

    def emit_kmeans_trace(self, kernel: str, *, inertia, shift, **attrs) -> None:
        """One ``kmeans_iter`` event per Lloyd iteration, and the
        ``kmeans.iterations`` histogram."""
        call = int(self.counter_inc("kmeans.trace_calls"))
        span = self.current_span_id()
        n_iter = len(shift)
        for i in range(n_iter):
            self._emit({
                "kind": "kmeans_iter", "kernel": kernel, "call": call, "span": span,
                "step": i, "inertia": None if inertia is None else float(inertia[i]),
                "shift": float(shift[i]), **attrs,
            })
        self.histogram("kmeans.iterations", float(n_iter))
