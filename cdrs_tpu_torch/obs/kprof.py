"""Per-kernel work and first-launch time: the counterpart of
``cdrs_tpu/obs/xprof.py``.

The reference asks XLA's cost analysis what a compiled program does and
times its first execution.  The port's kernels are written by hand, so
their work is counted here from the shapes, the same way whatever
implements them: :func:`kernel_cost` gives the operations and the bytes of
one call (each input byte read once, each output byte written once), the
only place the port counts a kernel's work.  Its users are the wrappers
(``ops/lloyd.lloyd_assign_reduce``, ``ops/seg_count.label_threshold_count``,
``ops/seg_sum.label_segment_sum``),
the roofline rows of ``cdrs metrics summarize`` (``obs/aggregate.py``) and
the smoke's bounds.

With an instrument active and ``kprof`` on, each wrapper call runs inside
:func:`instrumented_kernel`, which counts ``kernel.calls.<kernel>`` and, at
the first call of a (kernel, signature) in the process, emits one
``{"kind": "kernel", "event": "exec", ...}`` event with the call's
``flops``, ``bytes``, ``dtype``, ``device`` and ``seconds``.  On the card
``seconds`` is the time between two ``torch.cuda.Event``s recorded on the
launch's stream around the kernel's launch, read after one synchronise.
Before the start event the stream spins for ``SPIN_CYCLES`` clock cycles
(``torch.cuda._sleep``, untimed): an idle stream would stamp the start
event at once and count the host's launch path (tens of microseconds
through ``ctypes``, as long as the kernel itself at the main path's
shapes) as kernel time.  Later calls of the signature pay nothing.  On a
CPU tensor (the plain version) ``seconds`` is null: a CPU run never
writes a device time.  The launch itself is the same with the instrument
on or off.

:data:`DEVICE_PEAKS` is keyed by ``torch.cuda.get_device_name()``;
``cdrs metrics summarize --peak_flops/--peak_gbps`` override it.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time

from .telemetry import current

__all__ = ["instrumented_kernel", "kernel_cost", "bound_seconds", "DEVICE_PEAKS",
           "resolve_peaks", "clear_cache", "mesh_stamp"]

#: Per-card peaks: HBM bytes/s and operations/s by the operands' type (bf16
#: dense on the tensor cores).  H100 SXM5, HBM3.  f32: the card computes
#: f32-accurate products on its tensor cores as three TF32 products (high
#: and low parts, as B1's general path does), so 495 TFLOP/s TF32 / 3 bounds
#: f32 work; the 67 TFLOP/s of its CUDA cores no longer does, and a
#: tensor-core kernel would read a share over 100% against it.
DEVICE_PEAKS: dict[str, dict] = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "ops_per_s": {"float32": 495e12 / 3, "bfloat16": 989e12}},
}

#: Cycles the stream spins before a timed launch's start event: about
#: 0.5 ms on an H100, longer than the host takes to reach the launch.
SPIN_CYCLES = 1_000_000

#: The kernels whose work :func:`kernel_cost` counts, and their sources.
KERNELS = {"lloyd_assign_reduce": "lloyd", "label_threshold_count": "seg_count",
           "label_segment_sum": "seg_sum"}

_LOCK = threading.Lock()
#: (kernel, signature, stamp) seen in this process: the first call is timed.
_SEEN: set = set()
#: Mesh facts stamped on the events of calls made inside ``mesh_stamp``.
_STAMP: list[tuple] = []


def resolve_peaks(device_name: str | None, dtype: str = "float32"):
    """(peak operations/s for ``dtype``, peak bytes/s) of a card named as
    ``torch.cuda.get_device_name()`` names it, or None for any other name
    (a CPU, an unlisted card)."""
    peaks = DEVICE_PEAKS.get(device_name or "")
    if peaks is None:
        return None
    ops = peaks["ops_per_s"].get(dtype)
    return None if ops is None else (ops, peaks["bytes_per_s"])


def kernel_cost(kernel: str, *, n: int, d: int, k: int, n_valid: int | None = None,
                dtype: str = "float32", with_labels: bool = False,
                with_global: bool = True) -> dict:
    """Operations and bytes of one call, from its shapes.

    * ``lloyd_assign_reduce`` (B1; B3 is the same call with labels): x
      read once ((n, d) in ``dtype``), the labels written once when asked
      (int32), the centroids and |c|^2 read and the sums and counts
      written ((k, d) + k, eight bytes a value in all); operations
      ``2 n k d`` for the distances and ``n_valid d`` for the sums.
    * ``label_threshold_count`` (B2): x ((n, d) in ``dtype``) and the
      int32 labels read once, both threshold tables read and both count
      tables written ((2 k d + 2 d) cells of four bytes each way, without
      the global 2 d when ``with_global`` is false); operations: four
      compares an element with the global table, two without.
    * ``label_segment_sum`` (B2's general form): y ((n, d) in ``dtype``)
      and the int32 labels read once, the (k, d) float32 sums written
      once; operations: one add an element.

    Returns ``{"flops", "bytes", "dtype"}``."""
    esize = 2 if dtype == "bfloat16" else 4
    if kernel == "lloyd_assign_reduce":
        n_valid = n if n_valid is None else int(n_valid)
        n_bytes = n * d * esize + (n * 4 if with_labels else 0) + k * d * 8 + k * 8
        ops = 2.0 * n * k * d + n_valid * d
    elif kernel == "label_threshold_count":
        g_cells = 2 * d if with_global else 0
        n_bytes = n * d * esize + n * 4 + (2 * k * d + g_cells) * 4 * 2
        ops = (4.0 if with_global else 2.0) * n * d
    elif kernel == "label_segment_sum":
        n_bytes = n * (4 + d * esize) + k * d * 4
        ops = float(n * d)
    else:
        raise ValueError(f"unknown kernel {kernel!r}; known: {sorted(KERNELS)}")
    return {"flops": float(ops), "bytes": float(n_bytes), "dtype": dtype}


def bound_seconds(cost: dict, peaks) -> tuple[float, str]:
    """The least time the card could take for ``cost``: the larger of its
    bytes over the memory rate and its operations over the peak rate of
    its type, and which of the two it is ("bytes" or "operations").
    ``peaks`` is :func:`resolve_peaks`'s (ops/s, bytes/s)."""
    t_ops = cost["flops"] / peaks[0]
    t_bytes = cost["bytes"] / peaks[1]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def clear_cache() -> None:
    """Forget the timed signatures (tests): the next call of each is timed
    again."""
    with _LOCK:
        _SEEN.clear()


@contextlib.contextmanager
def mesh_stamp(devices: int, collective_bytes_per_iter: int):
    """Stamp ``devices`` and ``collective_bytes_per_iter`` on the kernel
    events of the calls made inside (one sharded Lloyd step)."""
    _STAMP.append((("devices", int(devices)),
                   ("collective_bytes_per_iter", int(collective_bytes_per_iter))))
    try:
        yield
    finally:
        _STAMP.pop()


def _sig_id(kernel: str, signature) -> int:
    """Small content-hashed id of a signature (stable across processes)."""
    digest = hashlib.blake2b(repr((kernel, signature)).encode(), digest_size=4).digest()
    return int.from_bytes(digest, "big")


class _Probe:
    """Times one launch between two CUDA events and emits its event."""

    __slots__ = ("tel", "kernel", "sig", "device", "cost", "stamp", "_events")

    def __init__(self, tel, kernel, sig, device, cost, stamp):
        self.tel, self.kernel, self.sig = tel, kernel, sig
        self.device, self.cost, self.stamp = device, cost, stamp
        self._events = None

    def __enter__(self):
        if self.device.type == "cuda":
            import torch

            from ..ops import _build

            _build.load(KERNELS[self.kernel])   # a build is never part of the time
            stream = torch.cuda.current_stream(self.device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)
            with torch.cuda.stream(stream):
                torch.cuda._sleep(SPIN_CYCLES)
            self._events[0].record(stream)
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None:
            return
        seconds = None
        name = "cpu"
        if self._events is not None:
            import torch

            start, end, stream = self._events
            end.record(stream)
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
            name = torch.cuda.get_device_name(self.device)
        event = {"kind": "kernel", "event": "exec", "kernel": self.kernel,
                 "sig": _sig_id(self.kernel, self.sig), "t": time.time(),
                 **self.cost(), "device": name, "seconds": seconds}
        event.update(dict(self.stamp))
        self.tel._emit(event)


def instrumented_kernel(kernel: str, x, static: tuple, cost):
    """The context to launch one call of ``kernel`` on points ``x`` in.

    Without an active instrument (or with ``kprof`` off) it is a null
    context, and nothing else is computed.  Otherwise it counts
    ``kernel.calls.<kernel>`` and, at the first call of the signature (the
    shape and dtype of ``x`` and the ``static`` flags; a mesh stamp adds to
    it) in this process, times the call on ``x``'s device and emits its
    ``kernel`` event; ``cost`` is a callable giving :func:`kernel_cost`'s
    dict, called only then."""
    tel = current()
    if tel is None or not tel.kprof:
        return contextlib.nullcontext()
    tel.counter_inc(f"kernel.calls.{kernel}")
    stamp = _STAMP[-1] if _STAMP else ()
    key = (kernel, tuple(x.shape), str(x.dtype), static, stamp)
    with _LOCK:
        if key in _SEEN:
            return contextlib.nullcontext()
        _SEEN.add(key)
    return _Probe(tel, kernel, key[1:], x.device, cost, stamp)
