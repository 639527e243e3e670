"""Struct-of-arrays manifest and event log, and the CSV writers of the
pipeline's output directory.

Copied from ``cdrs_tpu/io/events.py`` (in-memory types and CSV emission
only): paths and client nodes are interned to int32 ids, timestamps are
float64 epoch seconds.  ``metadata.csv`` and ``access.log`` keep the byte
format of the JAX package's writers.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from datetime import datetime, timezone

import numpy as np

__all__ = ["Manifest", "EventLog", "client_vocabulary"]


def client_vocabulary(manifest: "Manifest", extra_clients=()):
    """Client-id vocabulary: manifest nodes first (so ids align with
    ``primary_node_id``), then any extra simulator clients.  Returns
    (clients list, int32 ids of ``extra_clients``)."""
    clients = list(manifest.nodes)
    for c in extra_clients:
        if c not in clients:
            clients.append(c)
    pool = np.asarray([clients.index(c) for c in extra_clients], dtype=np.int32)
    return clients, pool


@dataclass
class Manifest:
    """Interned file population (metadata.csv columns)."""

    paths: list[str]
    creation_ts: np.ndarray          # (n,) float64 epoch seconds
    primary_node_id: np.ndarray      # (n,) int32, index into ``nodes``
    size_bytes: np.ndarray           # (n,) int64
    category: list[str]              # planted ground truth, lowercase
    nodes: list[str]

    def __len__(self) -> int:
        return len(self.paths)

    def write_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["path", "creation_ts", "primary_node",
                        "size_bytes", "category"])
            for i, p in enumerate(self.paths):
                ts = datetime.fromtimestamp(float(self.creation_ts[i]),
                                            tz=timezone.utc)
                w.writerow([
                    p,
                    ts.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z",
                    self.nodes[int(self.primary_node_id[i])],
                    int(self.size_bytes[i]),
                    self.category[i],
                ])


@dataclass
class EventLog:
    """Access events; ``path_id`` is -1 for paths absent from the manifest
    (the feature pass drops them)."""

    ts: np.ndarray          # (e,) float64 epoch seconds
    path_id: np.ndarray     # (e,) int32
    op: np.ndarray          # (e,) int8, 0 = READ, 1 = WRITE
    client_id: np.ndarray   # (e,) int32 into ``clients``
    clients: list[str]

    def __len__(self) -> int:
        return len(self.ts)

    def write_csv(self, path: str, manifest: Manifest) -> None:
        """``access.log`` rows ``ts,path,op,client,pid``; rows with
        ``path_id == -1`` are skipped.  The millisecond field truncates
        ``(t - floor(t)) * 1000`` exactly as the JAX package's writers do."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            out_i = 0
            for i in range(len(self.ts)):
                if self.path_id[i] < 0:
                    continue
                t = float(self.ts[i])
                whole = int(np.floor(t))
                ms = min(int((t - whole) * 1000.0), 999)
                dt = datetime.fromtimestamp(whole, tz=timezone.utc)
                iso = dt.strftime("%Y-%m-%dT%H:%M:%S") + f".{ms:03d}Z"
                op = "WRITE" if self.op[i] else "READ"
                w.writerow([
                    iso, manifest.paths[int(self.path_id[i])], op,
                    self.clients[int(self.client_id[i])],
                    1000 + out_i % 9000,
                ])
                out_i += 1
