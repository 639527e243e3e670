"""Log-ingestion throughput: the native chunk parser against Python's csv,
the counterpart of ``cdrs_tpu/benchmarks/ingest.py``.

The 1B-event streaming config (BASELINE.md config 5) is gated on parse speed
before the fold ever runs.  This bench writes a synthetic access.log and
measures rows a second through both paths of
``EventLog.read_csv_batches``:

    python -m cdrs_tpu_torch.benchmarks.ingest [--rows 2000000] [--files 100000]

Prints one JSON line with rows a second for both paths and the speedup.
The native path is the port's host library (``runtime/native.py``), built
at first use; a failed build raises (the port runs no silent Python path).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

__all__ = ["bench_ingest"]


def _write_log(path: str, manifest, rows: int, seed: int = 0) -> None:
    from ..config import SimulatorConfig
    from ..io.events import EventLog
    from ..sim.access import simulate_access

    # Scale the simulated window until it holds at least ``rows`` events,
    # then truncate: rates are per second, so duration ~ rows / (files * rate).
    duration = max(60.0, rows / max(len(manifest), 1) * 6.0)
    events = simulate_access(manifest, SimulatorConfig(
        duration_seconds=duration, seed=seed, clients=("client0", "client1", "client2")))
    take = min(rows, len(events))
    EventLog(ts=events.ts[:take], path_id=events.path_id[:take], op=events.op[:take],
             client_id=events.client_id[:take],
             clients=events.clients).write_csv(path, manifest)


def bench_ingest(rows: int = 2_000_000, files: int = 100_000, batch_size: int = 1_000_000,
                 seed: int = 0, py_rows_cap: int = 500_000) -> dict:
    """Native against Python ingestion rows a second on one synthetic log.

    The Python path is timed on at most ``py_rows_cap`` rows (a per-row
    loop, linear in rows); the native path parses the whole file.
    """
    from ..config import GeneratorConfig
    from ..io.events import EventLog
    from ..sim.generator import generate_population

    manifest = generate_population(GeneratorConfig(n_files=files, seed=seed))
    with tempfile.TemporaryDirectory(prefix="cdrs_ingest_") as td:
        log = os.path.join(td, "access.log")
        _write_log(log, manifest, rows, seed)
        with open(log, "rb") as f:
            n_rows = sum(1 for _ in f)

        t0 = time.perf_counter()
        total = sum(len(b) for b in EventLog.read_csv_batches(
            log, manifest, batch_size=batch_size, native=True))
        native_rps = total / (time.perf_counter() - t0)
        if total != n_rows:
            raise RuntimeError(f"the native parser read {total} of {n_rows} rows")

        py_rows = 0
        t0 = time.perf_counter()
        for b in EventLog.read_csv_batches(log, manifest, batch_size=batch_size,
                                           native=False):
            py_rows += len(b)
            if py_rows >= py_rows_cap:
                break
        py_rps = py_rows / (time.perf_counter() - t0)

    return {
        "metric": f"log_ingest_rows_per_sec_rows{n_rows}_files{files}",
        "rows": n_rows,
        "python_rows_per_sec": py_rps,
        "native_rows_per_sec": native_rps,
        "unit": "row/s",
        "value": native_rps,
        "vs_python": native_rps / py_rps,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.ingest",
                                description="native against Python log ingestion rows/s")
    p.add_argument("--rows", type=int, default=2_000_000)
    p.add_argument("--files", type=int, default=100_000)
    p.add_argument("--batch_size", type=int, default=1_000_000)
    args = p.parse_args(argv)
    print(json.dumps(bench_ingest(args.rows, args.files, args.batch_size)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
