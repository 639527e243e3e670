"""The 1B-event streaming scenario end to end on real IO (BASELINE config
5), the counterpart of ``cdrs_tpu/benchmarks/stream1b.py``.

``python -m cdrs_tpu_torch.benchmarks.stream1b --events 1e9`` runs the data
plane at BASELINE.json's scale:

1. generate a manifest (default 1M files),
2. simulate the access stream with the host library's threaded engine
   (``simulate_access(engine="native")``),
3. write the access log with the native writer (CSV, ~60 GB at 1B rows;
   or the columnar ``.cdrsb`` with ``--format binary``),
4. read it back through the native chunk parser and interning,
5. fold every batch into the feature state on the card
   (``features/streaming.fold_stream``; parse and prep on a producer
   thread beside the fold),
6. finalize the feature table.

Prints one JSON line with per-stage seconds and rates and the end-to-end
events a second.  The log goes to ``--workdir`` (default: a temporary
directory, deleted afterwards).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time

__all__ = ["run_stream1b"]


def run_stream1b(events: int = 1_000_000_000, n_files: int = 1_000_000,
                 batch_size: int = 4_000_000, seed: int = 0, workdir: str | None = None,
                 keep_log: bool = False, base_dir: str | None = None,
                 log_format: str = "csv", device=None) -> dict:
    from ..config import GeneratorConfig, SimulatorConfig
    from ..device import device_name, resolve_device
    from ..features.streaming import fold_stream, stream_finalize
    from ..sim.access import simulate_access
    from ..sim.generator import generate_population
    from .harness import _sync

    if log_format not in ("csv", "binary"):
        raise ValueError(f"log_format must be 'csv' or 'binary', got {log_format!r}")
    dev = resolve_device(device)
    td = workdir or tempfile.mkdtemp(prefix="cdrs_stream1b_")
    os.makedirs(td, exist_ok=True)
    log = os.path.join(td, "access.cdrsb" if log_format == "binary" else "access.log")
    out: dict = {"events_requested": int(events), "n_files": int(n_files),
                 "batch_size": int(batch_size), "log_format": log_format,
                 "device_name": device_name(dev)}
    if keep_log:
        out["log_path"] = log
    try:
        t0 = time.perf_counter()
        gen_cfg = GeneratorConfig(n_files=n_files, seed=seed)
        if base_dir is not None:
            gen_cfg = dataclasses.replace(gen_cfg, base_dir=base_dir)
        manifest = generate_population(gen_cfg)
        out["gen_seconds"] = time.perf_counter() - t0

        # Size the simulated window so the expected event count hits the
        # target: rates are per second per file.
        probe = simulate_access(manifest, SimulatorConfig(duration_seconds=60.0,
                                                          seed=seed + 1), engine="native")
        rate = len(probe) / 60.0
        del probe
        duration = max(60.0, events / max(rate, 1.0))

        t0 = time.perf_counter()
        ev = simulate_access(manifest, SimulatorConfig(duration_seconds=duration,
                                                       seed=seed + 1), engine="native")
        out["simulate_seconds"] = time.perf_counter() - t0
        out["events_simulated"] = len(ev)
        out["simulate_events_per_sec"] = len(ev) / out["simulate_seconds"]

        t0 = time.perf_counter()
        if log_format == "binary":
            ev.write_binary(log, manifest)
        else:
            ev.write_csv(log, manifest)
        out["write_seconds"] = time.perf_counter() - t0
        out["write_rows_per_sec"] = len(ev) / out["write_seconds"]
        out["log_bytes"] = os.path.getsize(log)
        n_events = len(ev)
        del ev   # the stream must not stay resident (that is the point)

        t0 = time.perf_counter()
        stats: dict = {}
        # Crash-safe: the fold snapshots its state and log offset beside the
        # log; a rerun with the same workdir resumes.
        state = fold_stream(log, manifest, device=dev, batch_size=batch_size, stats=stats,
                            checkpoint_path=os.path.join(td, "stream.ckpt.npz"))
        table = stream_finalize(state, manifest)
        _sync(dev)
        total = time.perf_counter() - t0
        out.update({
            # Busy times of the two halves: parse and prep on the producer
            # thread, copy and fold on the calling one; the wall is about
            # the larger of the two, not their sum.
            "ingest_parse_prep_seconds": stats["parse_seconds"] + stats["prep_seconds"],
            "ingest_parse_seconds": stats["parse_seconds"],
            "ingest_prep_seconds": stats["prep_seconds"],
            "fold_seconds": stats["fold_seconds"],
            "ingest_plus_fold_seconds": total,
            "ingest_events_per_sec": n_events / total,
            "end_to_end_seconds": (out["gen_seconds"] + out["simulate_seconds"]
                                   + out["write_seconds"] + total),
            "metric": f"stream1b_events_per_sec_n{n_files}_e{n_events}",
            "value": n_events / total,
            "unit": "event/s",
            "feature_rows": int(table.raw.shape[0]),
        })
        return out
    finally:
        if not keep_log and workdir is None:
            shutil.rmtree(td, ignore_errors=True)
        elif not keep_log:
            try:
                os.unlink(log)
            except OSError:
                pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.stream1b",
                                description="the 1B-event streaming path end to end")
    p.add_argument("--events", type=float, default=1e9)
    p.add_argument("--n_files", type=int, default=1_000_000)
    p.add_argument("--batch_size", type=int, default=4_000_000)
    p.add_argument("--workdir", default=None,
                   help="where the log lands (default: a temporary directory, deleted)")
    p.add_argument("--keep_log", action="store_true")
    p.add_argument("--base_dir", default=None,
                   help="manifest path prefix (default: the generator's; shorter: a "
                        "smaller log)")
    p.add_argument("--format", choices=["csv", "binary"], default="csv",
                   help="log format: 'csv' = the reference's access.log; 'binary' = "
                        "the columnar .cdrsb")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    print(json.dumps(run_stream1b(
        events=int(args.events), n_files=args.n_files, batch_size=args.batch_size,
        workdir=args.workdir, keep_log=args.keep_log, base_dir=args.base_dir,
        log_format=args.format, device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
