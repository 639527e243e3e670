"""The per-file feature table (raw + min-max normalised, (n, 5) each)."""

from __future__ import annotations

import csv
from dataclasses import dataclass

import torch

from ..config import CLUSTERING_FEATURES, RAW_FEATURES

__all__ = ["FeatureTable"]


@dataclass
class FeatureTable:
    """Column order RAW_FEATURES / CLUSTERING_FEATURES; tensors stay on the
    device that computed them, so clustering reads ``norm`` in place."""

    paths: list[str]
    raw: torch.Tensor        # (n, 5)
    norm: torch.Tensor       # (n, 5) in [0, 1]
    writes: torch.Tensor     # (n,)
    reads: torch.Tensor      # (n,)

    raw_names: tuple[str, ...] = RAW_FEATURES
    norm_names: tuple[str, ...] = CLUSTERING_FEATURES

    def write_csv(self, path: str) -> None:
        """``part-00000-features.csv``: path, 5 raw, 5 *_norm columns."""
        raw = self.raw.cpu().double().numpy()
        norm = self.norm.cpu().double().numpy()
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["path", *self.raw_names, *self.norm_names])
            for i, p in enumerate(self.paths):
                w.writerow([p,
                            *(repr(float(v)) for v in raw[i]),
                            *(repr(float(v)) for v in norm[i])])
