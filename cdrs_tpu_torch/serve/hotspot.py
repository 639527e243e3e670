"""EWMA hotspot detector: ``cdrs_tpu/serve/hotspot.py``, host numpy.

Each file carries an EWMA baseline of its per-window read counts.  A window
in which a file's count reaches ``spike_factor`` times its baseline, and at
least ``min_reads``, fires; the controller then re-clusters in that window,
as it does when drift crosses its threshold.  Detection is judged against
the baseline before the window folds into it.  The first window only sets
the baseline and never fires.  Nothing is random; the baseline rides the
controller's checkpoint (``serve_ewma``, ``serve_ewma_init``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["HotspotResult", "HotspotDetector"]


@dataclass(frozen=True)
class HotspotResult:
    """One window's verdict."""

    #: Some file spiked past the threshold.
    fired: bool
    #: max(count / max(EWMA, 1)) over the files (1.0 on the first window).
    score: float
    #: Up to ``top_k`` spiking file ids, ratio descending, id ascending.
    files: tuple[int, ...]


class HotspotDetector:
    """Carries the per-file EWMA baseline across windows."""

    def __init__(self, n_files: int, *, alpha: float = 0.3, spike_factor: float = 4.0,
                 min_reads: int = 50, top_k: int = 8):
        self.n_files = int(n_files)
        self.alpha = float(alpha)
        self.spike_factor = float(spike_factor)
        self.min_reads = int(min_reads)
        self.top_k = int(top_k)
        self.ewma = np.zeros(self.n_files, dtype=np.float64)
        self.initialized = False

    def observe(self, counts: np.ndarray) -> HotspotResult:
        """Score one window's per-file read counts, then fold them in."""
        counts = np.asarray(counts, dtype=np.float64)
        if counts.shape != (self.n_files,):
            raise ValueError(f"counts shape {counts.shape} != ({self.n_files},)")
        if not self.initialized:
            self.ewma = counts.copy()
            self.initialized = True
            return HotspotResult(fired=False, score=1.0, files=())
        ratio = counts / np.maximum(self.ewma, 1.0)
        hot = (counts >= self.min_reads) & (ratio >= self.spike_factor)
        score = float(ratio.max()) if ratio.size else 1.0
        files: tuple[int, ...] = ()
        if hot.any():
            ids = np.flatnonzero(hot)
            order = np.lexsort((ids, -ratio[ids]))   # ratio descending, id ascending
            files = tuple(int(i) for i in ids[order][:self.top_k])
        self.ewma = self.alpha * counts + (1.0 - self.alpha) * self.ewma
        return HotspotResult(fired=bool(hot.any()), score=score, files=files)

    def state_arrays(self) -> dict[str, np.ndarray]:
        return {"serve_ewma": self.ewma.copy(),
                "serve_ewma_init": np.asarray([self.initialized])}

    def load_state_arrays(self, arrays: dict) -> None:
        ewma = np.asarray(arrays["serve_ewma"], dtype=np.float64)
        if ewma.shape != (self.n_files,):
            raise ValueError(f"checkpoint serve_ewma shape {ewma.shape} != "
                             f"({self.n_files},): stale checkpoint?")
        self.ewma = ewma.copy()
        self.initialized = bool(np.asarray(arrays["serve_ewma_init"])[0])
