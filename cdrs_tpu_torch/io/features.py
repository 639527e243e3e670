"""Feature-CSV ingestion for the decision layer: the port of
``cdrs_tpu/io/features.py``.

A directory resolves to ``part-00000*.csv`` inside it (the Spark output
convention), else to any ``*.csv`` in it; a glob is expanded; the first
match is used, with a warning when more matched.  The CSV is parsed with
the standard library (no pandas): every value is read with ``float``, so
the matrix holds the correctly rounded value of each field.
"""

from __future__ import annotations

import csv
import glob
import os
import sys

import numpy as np

from ..config import CLUSTERING_FEATURES

__all__ = ["resolve_features_path", "load_feature_matrix"]


def resolve_features_path(input_path: str) -> str:
    if os.path.isdir(input_path):
        matches = sorted(glob.glob(os.path.join(input_path, "part-00000*.csv")))
        if not matches:
            # The pipeline's own output directory: accept any csv in it.
            matches = sorted(glob.glob(os.path.join(input_path, "*.csv")))
    else:
        matches = sorted(glob.glob(input_path))
    if not matches:
        raise FileNotFoundError(f"no features CSV matching {input_path!r}")
    if len(matches) > 1:
        print(f"warning: {len(matches)} feature files matched; using {matches[0]}",
              file=sys.stderr)
    return matches[0]


def load_feature_matrix(input_path: str, features: tuple[str, ...] = CLUSTERING_FEATURES,
                        dtype=np.float64) -> tuple[np.ndarray, list[str]]:
    """(n, len(features)) matrix of the named columns and the ``path``
    column (row numbers as strings when the CSV has none)."""
    path = resolve_features_path(input_path)
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        missing = [c for c in features if c not in header]
        if missing:
            raise ValueError(f"features CSV {path} missing columns: {missing}")
        rows = [r for r in reader if r]
    columns = list(zip(*rows)) if rows else [()] * len(header)
    X = np.empty((len(rows), len(features)), dtype=np.float64)
    for j, name in enumerate(features):
        X[:, j] = np.fromiter(map(float, columns[header.index(name)]), np.float64, len(rows))
    paths = (list(columns[header.index("path")]) if "path" in header
             else [str(i) for i in range(len(rows))])
    return X.astype(dtype, copy=False), paths
