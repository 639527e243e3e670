"""Device-facing telemetry helpers: call signatures and the card's memory
gauges (the counterpart of ``cdrs_tpu/obs/jaxtools.py``).

The reference's recompile detector has no counterpart here: a CUDA kernel
is compiled once per source, not per shape, and ``ops/_build`` counts
those builds itself (``kernel.builds.<source>``, ``kernel.build.seconds``).
"""

from __future__ import annotations

__all__ = ["signature", "device_memory_gauges"]


def signature(*tensors, static=()) -> tuple:
    """Hashable signature of a call: (shape, dtype) per tensor plus the
    static configuration.  Takes tensors, arrays, or anything with
    ``.shape``/``.dtype``."""
    parts = []
    for a in tensors:
        shape = tuple(getattr(a, "shape", ()))
        dtype = str(getattr(a, "dtype", type(a).__name__))
        parts.append((shape, dtype))
    return tuple(parts) + (tuple(static),)


def device_memory_gauges(tel, stage: str | None = None) -> None:
    """Gauge ``device.mem.bytes_in_use.d<i>[.<stage>]`` and
    ``device.mem.peak_bytes_in_use.d<i>[.<stage>]`` per visible card from
    ``torch.cuda.memory_stats`` (the caching allocator's current and peak
    allocated bytes).  Emits nothing on a host whose process never
    initialised CUDA (a CPU run), and never initialises it."""
    import torch

    if not torch.cuda.is_initialized():
        return
    suffix = f".{stage}" if stage else ""
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        tel.gauge(f"device.mem.bytes_in_use.d{i}{suffix}",
                  float(stats.get("allocated_bytes.all.current", 0)))
        tel.gauge(f"device.mem.peak_bytes_in_use.d{i}{suffix}",
                  float(stats.get("allocated_bytes.all.peak", 0)))
