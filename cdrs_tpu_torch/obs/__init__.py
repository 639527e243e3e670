"""Observability: one ambient instrument over one JSONL stream, and its
readers (the counterpart of ``cdrs_tpu/obs``).

* ``telemetry`` — ``Telemetry`` (spans, counters, gauges, histograms),
  activated as the process's ambient instrument so deep call sites emit
  against ``current()``; ``sink`` — the thread-safe, rotating
  ``JsonlSink`` and its readers.
* ``kprof`` — per-kernel work from the shapes and the first launch's time
  between CUDA events, against the card's peaks; ``devtools`` — call
  signatures and ``torch.cuda.memory_stats`` gauges.
* ``audit`` — the controller's per-window decision-quality audit.
* ``aggregate`` — what a stream means (span forest, counters, digests,
  roofline rows); ``metrics_cli`` (``cdrs metrics``), ``report`` (static
  HTML), ``trace`` (the daemon's decision traces and ``cdrs trace``),
  ``alerts`` (declarative alert rules), ``prom`` and ``httpz`` (the
  daemon's live HTTP plane) read it.

Event kinds and names are the reference's, except where a name describes
JAX: ``jit.calls.<k>`` is ``kernel.calls.<k>``, the recompile counter is
``kernel.builds.<source>`` (compiler runs: ``nvcc`` for a kernel, ``g++``
for the host library), ``xla.compile.seconds`` is
``kernel.build.seconds``, and ``{"kind": "xla"}`` events are
``{"kind": "kernel"}``.
"""

from .sink import JsonlSink, iter_events, read_events
from .telemetry import (HIST_BUCKETS, HIST_BULK_SAMPLE_CAP, HIST_RAW_CAP, Span, Telemetry,
                        bucket_counts, current, run_metadata)

__all__ = [
    "HIST_BUCKETS",
    "HIST_BULK_SAMPLE_CAP",
    "HIST_RAW_CAP",
    "JsonlSink",
    "Span",
    "Telemetry",
    "bucket_counts",
    "current",
    "iter_events",
    "read_events",
    "run_metadata",
]
