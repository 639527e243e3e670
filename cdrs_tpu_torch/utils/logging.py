"""Per-stage timing and the flat metrics record, as shims over the ambient
instrument (``cdrs_tpu/utils/logging.py``).

``StageTimer`` wall-clocks a stage and, when a ``Telemetry`` is active,
opens a span of the stage's name around it; on a CUDA ``device`` the
stage ends with a synchronise, so its queued kernels count toward it.
``MetricsLog`` is the flat record dict of the pipeline summary; its
records and increments also go to the active instrument as gauges and
counters.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

from ..obs import current as _current_telemetry

__all__ = ["StageTimer", "MetricsLog", "stage_span"]


def stage_span(name: str, device=None):
    """A ``StageTimer`` span of ``name`` (synchronised on a CUDA
    ``device``) when telemetry is active; a null context otherwise, so an
    uninstrumented run pays neither the span nor the synchronise."""
    if _current_telemetry() is None:
        return contextlib.nullcontext()
    return StageTimer(name, device=device)


class StageTimer:
    """Wall-clock a stage into ``metrics`` (as ``<name>.seconds``, when
    given), in a span when telemetry is active."""

    def __init__(self, name: str, metrics: "MetricsLog | None" = None, device=None):
        self.name = name
        self.metrics = metrics
        self.device = device
        self.elapsed = 0.0
        self._span = None

    def __enter__(self) -> "StageTimer":
        tel = _current_telemetry()
        if tel is not None:
            self._span = tel.span(self.name)
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.device is not None and self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        self.elapsed = time.perf_counter() - self._t0
        if self._span is not None:
            self._span.__exit__(*exc)
            self._span = None
        if self.metrics is not None:
            self.metrics.record(f"{self.name}.seconds", self.elapsed)


@dataclass
class MetricsLog:
    """Flat metric record dict; a repeated key turns into a list, and
    ``increment`` adds to a key."""

    records: dict[str, float | list[float]] = field(default_factory=dict)

    def record(self, key: str, value) -> None:
        value = value if value is None else float(value)
        if key in self.records:
            old = self.records[key]
            if isinstance(old, list):
                old.append(value)
            else:
                self.records[key] = [old, value]
        else:
            self.records[key] = value
        tel = _current_telemetry()
        if tel is not None and value is not None:
            tel.gauge(key, value)

    def increment(self, key: str, delta: float = 1.0) -> float:
        """Add ``delta`` to the key (0 when absent); a key holding a list of
        records cannot be incremented."""
        old = self.records.get(key, 0.0)
        if isinstance(old, list):
            raise TypeError(f"cannot increment {key!r}: it holds a list of records")
        value = float(old) + float(delta)
        self.records[key] = value
        tel = _current_telemetry()
        if tel is not None:
            tel.counter_inc(key, delta)
        return value

    def timer(self, name: str, device=None) -> StageTimer:
        """``StageTimer`` of ``name`` into this record (``device``: see the
        class)."""
        return StageTimer(name, metrics=self, device=device)

    def to_json(self) -> str:
        return json.dumps(self.records, sort_keys=True)
