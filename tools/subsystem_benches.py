#!/usr/bin/env python3
"""The thirteen subsystem benches at the reference's defaults, one after
another, on one CUDA card.

    python3 tools/subsystem_benches.py OUTDIR              # all thirteen
    python3 tools/subsystem_benches.py OUTDIR serve_bench geo_bench

Runs ``python -m cdrs_tpu_torch.benchmarks.<name>`` for each bench with its
artifacts in OUTDIR (``<name>_torch.json``; chaos's rack artifact and
storage's overhead artifact beside it) and the history disabled where the
bench appends one, and writes each one's standard output and errors to
``OUTDIR/<name>.log``.  Prints one JSON line a bench: its exit code, wall
seconds and the last line it printed (its criteria).  Exits non-zero if any
bench did.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHES = ("control_bench", "chaos_bench", "storage_bench", "integrity_bench", "serve_bench",
           "daemon_bench", "overload_bench", "geo_bench", "placement_bench", "mesh_bench",
           "search_bench", "telemetry_overhead", "plan_bench")
#: Benches whose ``main`` appends to the port's history outside --quick.
HISTORY = ("integrity_bench", "daemon_bench", "overload_bench", "geo_bench", "placement_bench",
           "mesh_bench", "search_bench", "plan_bench")


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    outdir, names = os.path.abspath(argv[0]), argv[1:] or list(BENCHES)
    os.makedirs(outdir, exist_ok=True)
    worst = 0
    for name in names:
        cmd = [sys.executable, "-m", f"cdrs_tpu_torch.benchmarks.{name}",
               "--out", os.path.join(outdir, f"{name}_torch.json")]
        if name == "chaos_bench":
            cmd += ["--rack_out", os.path.join(outdir, "chaos_rack_bench_torch.json")]
        if name == "storage_bench":
            cmd += ["--overhead_out", os.path.join(outdir, "storage_overhead_torch.json")]
        if name in HISTORY:
            cmd += ["--history", ""]
        t0 = time.perf_counter()
        with open(os.path.join(outdir, f"{name}.log"), "w") as log:
            proc = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=log, text=True,
                                  env=dict(os.environ, PYTHONPATH=ROOT))
            log.write(proc.stdout)
        lines = proc.stdout.strip().splitlines()
        print(json.dumps({"bench": name, "rc": proc.returncode,
                          "seconds": round(time.perf_counter() - t0, 1),
                          "last": lines[-1] if lines else None}), flush=True)
        worst = max(worst, proc.returncode)
    return worst


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
