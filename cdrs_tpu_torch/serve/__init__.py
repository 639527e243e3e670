"""Serving: the read router with its latency SLOs (``router``), the hotspot
detector whose firing re-clusters (``hotspot``), and the read view of a
live state, a static placement or a pinned epoch (``view``).  All host
numpy: serving routes reads and runs no kernel."""

from .hotspot import HotspotDetector, HotspotResult
from .router import (POLICIES, ReadRouter, ServeConfig, SloSpec, WindowServeResult,
                     emit_window_telemetry)
from .view import ReadView, read_view

__all__ = [
    "POLICIES",
    "HotspotDetector",
    "HotspotResult",
    "ReadRouter",
    "ReadView",
    "ServeConfig",
    "SloSpec",
    "WindowServeResult",
    "emit_window_telemetry",
    "read_view",
]
