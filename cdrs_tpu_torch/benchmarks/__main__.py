"""``python -m cdrs_tpu_torch.benchmarks``: the port's ``bench.py``.

Prints ONE JSON line on stdout: ``{"metric", "value", "unit",
"vs_baseline"}``.

Default (no ``--config``): BASELINE config 2 (1M x 32, k = 128), the
headline line, then on CUDA config 3 (10M x 128, k = 1024 Lloyd iter/s) and
the config-4 one-card rehearsal (bf16 points, e2e time-to-categories at
the rows the memory guard leaves) as ``config3`` and
``config4_rehearsal`` blocks of the detail JSON, which goes to stderr with
the environment stamp.  On the CPU (``--device cpu``) those two are
skipped with the reason.  ``--config N`` runs exactly one config.
``--update``/``--dtype``/``--e2e`` apply to every capture of a run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def main(argv=None) -> int:
    from .harness import CONFIGS, run_bench

    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks",
                                description=__doc__.splitlines()[0])
    p.add_argument("--config", type=int, default=None, choices=sorted(CONFIGS),
                   help="run a single BASELINE config (default: config 2 plus the "
                        "config-3/config-4-rehearsal capture)")
    p.add_argument("--backend", default=None, choices=["torch", "torch-cpu"],
                   help="torch = the device path against the plain version on the CPU; "
                        "torch-cpu = the plain version alone (default: the config's)")
    p.add_argument("--update", default=None,
                   help="the reference's Lloyd strategy option: only auto is taken (the "
                        "port's step is the CUDA kernel on a card, its plain version on "
                        "the CPU); any other value is refused")
    p.add_argument("--e2e", action="store_true",
                   help="wall-clock time-to-categories instead of iter/s")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16", "float64"])
    p.add_argument("--metrics", default=None, metavar="JSONL",
                   help="emit telemetry (spans, counters, kernel calls) here; read it "
                        "with 'metrics summarize'")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..obs import run_metadata

    def emit_line(out):
        print(json.dumps({k: out[k] for k in ("metric", "value", "unit", "vs_baseline")}),
              flush=True)

    stack = contextlib.ExitStack()
    if args.metrics:
        from ..obs import JsonlSink, Telemetry

        # kmeans_trace=False: spans and counters only, the timed loop as is.
        tel = stack.enter_context(Telemetry(JsonlSink(args.metrics), kmeans_trace=False))
        stack.enter_context(tel.span("bench"))
    try:
        with stack:   # a failing capture still closes the sink
            out = run_bench(config=2 if args.config is None else args.config,
                            backend=args.backend, update=args.update, e2e=args.e2e,
                            dtype=args.dtype, device=args.device)
            # The contract line first: the k = 1024 captures take minutes.
            emit_line(out)
            if args.config is None:
                if resolve_device(args.device).type == "cuda":
                    # Failures are recorded, not fatal: the contract line stands.
                    try:
                        out["config3"] = run_bench(config=3, quality=False,
                                                   update=args.update, e2e=args.e2e,
                                                   dtype=args.dtype, device=args.device)
                    except Exception as e:  # pragma: no cover - depends on the card
                        out["config3"] = {"error": f"{type(e).__name__}: {e}"}
                    try:
                        # The rehearsal is an e2e bf16 run by definition:
                        # --update/--dtype override it, --e2e is on.
                        out["config4_rehearsal"] = run_bench(
                            config=4, quality=False, e2e=True, update=args.update,
                            dtype=args.dtype or "bfloat16", device=args.device)
                    except Exception as e:  # pragma: no cover - depends on the card
                        out["config4_rehearsal"] = {"error": f"{type(e).__name__}: {e}"}
                else:
                    note = ("skipped: the k = 1024 captures run on CUDA only "
                            "(--config 3 or 4 runs one anyway)")
                    out["config3"] = {"skipped": note}
                    out["config4_rehearsal"] = {"skipped": note}
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # The environment stamp (versions, the card's name, count and power
    # limit) makes captures comparable across machines.
    out["run_meta"] = run_metadata()
    print(json.dumps(out), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
