"""Profiler traces of a region (``cdrs_tpu/utils/profiling.py``).

``trace_region(dir)`` runs the region under ``torch.profiler`` with the
CPU activity and, when CUDA is available, the CUDA one (the card's kernels
with their device times), and writes one Chrome trace
(``trace.json``, viewable in Perfetto or ``chrome://tracing``) into
``dir``.  With ``dir=None`` it is a null context.
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["trace_region", "TRACE_FILE"]

#: The trace's file name inside the directory.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_region(trace_dir: str | None):
    """Profile the region into ``trace_dir/trace.json`` (no-op for None)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
