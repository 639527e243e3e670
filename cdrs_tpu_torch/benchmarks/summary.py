"""One-command benchmark sweep, the counterpart of
``cdrs_tpu/benchmarks/summary.py``.

    python -m cdrs_tpu_torch.benchmarks.summary --out bench_summary_torch.json

Runs every BASELINE config through ``run_bench`` (iter/s and e2e), the
ingestion bench and the bfloat16 points of configs 2 and 4, emitting the
raw ``run_bench``/``bench_ingest`` records under ``hardware / lloyd / e2e /
streaming / ingestion``.  Each step is fault-isolated: a failing config
records its error string instead of aborting the sweep.  On the card the
reference's ``update="matmul"`` capture has no counterpart (the plain
version runs on the CPU only), so config 2's second capture is its bf16
point.  With quality on, the instrument's overhead on the pipeline, the
controller and the kernel-cost capture rides along.
"""

from __future__ import annotations

import argparse
import json
import sys


def _step(out: dict, key: str, fn):
    try:
        out[key] = fn()
    except Exception as e:  # fault-isolate: record, keep sweeping
        out[key] = {"error": f"{type(e).__name__}: {e}"}
        print(f"[summary] {key} FAILED: {e}", file=sys.stderr)


#: Telemetry overhead budget on the config-1-scale pipeline path: <= 5%
#: wall-clock against telemetry off (the reference's bound).
TELEMETRY_OVERHEAD_BUDGET = 1.05


def _paired(run_plain, run_instr, repeats: int):
    """(plain windows, instrumented windows, sorted per-round ratios) of
    ``repeats`` paired rounds whose order alternates: drift on a shared
    host moves both sides of a pair together."""
    plain, instr, ratios = [], [], []
    for r in range(max(1, repeats)):
        if r % 2 == 0:
            p, i = run_plain(), run_instr()
        else:
            i, p = run_instr(), run_plain()
        plain.append(p)
        instr.append(i)
        ratios.append(i / p)
    return plain, instr, sorted(ratios)


def telemetry_overhead(n_files: int = 10_000, duration: float = 120.0, repeats: int = 15,
                       runs_per_window: int = 2, device=None) -> dict:
    """Wall-clock cost of the instrument on the config-1-scale pipeline
    (10K files): stage spans, counters, the kmeans convergence trace, the
    kernel costs and the JSONL sink, against the same run with telemetry
    off, in interleaved pairs.  The headline compares the best window of
    each side; every window and the paired ratios are disclosed."""
    import os
    import tempfile
    import time

    from ..config import (GeneratorConfig, KMeansConfig, PipelineConfig, SimulatorConfig,
                          validated_scoring_config)
    from ..obs import JsonlSink, Telemetry
    from ..pipeline import run_pipeline

    cfg = PipelineConfig(
        device=device,
        generator=GeneratorConfig(n_files=n_files, seed=5),
        simulator=SimulatorConfig(duration_seconds=duration, seed=6),
        kmeans=KMeansConfig(k=8, seed=42),
        scoring=validated_scoring_config(),
        evaluate=False,
    )

    def timed() -> float:
        # One window = several runs: one short run is below a shared
        # host's scheduling jitter.
        t0 = time.perf_counter()
        for _ in range(max(1, runs_per_window)):
            run_pipeline(cfg)
        return time.perf_counter() - t0

    timed()  # warm-up (imports, first launches) outside both sides
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "telemetry.jsonl")

        def instr() -> float:
            with Telemetry(JsonlSink(path)):
                return timed()

        plain, inst, ratios = _paired(timed, instr, repeats)
        with open(path) as f:
            events = sum(1 for _ in f)
    ratio = min(inst) / min(plain)
    return {
        "n_files": n_files,
        "plain_seconds": min(plain),
        "telemetry_seconds": min(inst),
        "plain_windows": plain,
        "telemetry_windows": inst,
        "paired_ratios": ratios,
        "paired_ratio_median": ratios[len(ratios) // 2],
        "overhead_ratio": ratio,
        "events_emitted": events,
        "budget": TELEMETRY_OVERHEAD_BUDGET,
        "within_budget": ratio <= TELEMETRY_OVERHEAD_BUDGET,
    }


def telemetry_overhead_control(n_files: int = 20_000, duration: float = 480.0,
                               window_seconds: float = 60.0, repeats: int = 9,
                               device=None) -> dict:
    """Wall-clock cost of telemetry and the decision-quality audit on the
    controller path, with the same interleaved pairs as
    :func:`telemetry_overhead`: window records through the sink, counters,
    histograms and one audit event a window."""
    import os
    import tempfile
    import time

    from ..config import (GeneratorConfig, KMeansConfig, SimulatorConfig,
                          validated_scoring_config)
    from ..control.controller import ControllerConfig, ReplicationController
    from ..obs import JsonlSink, Telemetry, read_events
    from ..sim.access import simulate_access
    from ..sim.generator import generate_population

    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=7))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=8))
    cfg = ControllerConfig(window_seconds=window_seconds, kmeans=KMeansConfig(k=8, seed=42),
                           scoring=validated_scoring_config(), device=device)

    def run_plain() -> float:
        t0 = time.perf_counter()
        ReplicationController(manifest, cfg).run(events)
        return time.perf_counter() - t0

    run_plain()  # warm-up
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "t.jsonl")

        def run_instr() -> float:
            # A fresh stream each time: audit_events_per_run counts one run.
            if os.path.exists(path):
                os.remove(path)
            t0 = time.perf_counter()
            with Telemetry(JsonlSink(path)):
                ReplicationController(manifest, cfg).run(events, metrics_path=path)
            return time.perf_counter() - t0

        plain, inst, ratios = _paired(run_plain, run_instr, repeats)
        audit_events = sum(1 for e in read_events(path) if e.get("kind") == "audit")
    ratio = min(inst) / min(plain)
    return {
        "n_files": n_files,
        "windows_per_run": int(duration // window_seconds),
        "plain_seconds": min(plain),
        "telemetry_audit_seconds": min(inst),
        "plain_windows": plain,
        "telemetry_windows": inst,
        "paired_ratios": ratios,
        "paired_ratio_median": ratios[len(ratios) // 2],
        "overhead_ratio": ratio,
        "audit_events_per_run": audit_events,
        "budget": TELEMETRY_OVERHEAD_BUDGET,
        "within_budget": ratio <= TELEMETRY_OVERHEAD_BUDGET,
    }


def kprof_overhead(n: int = 200_000, d: int = 16, k: int = 32, calls: int = 12,
                   device=None) -> dict:
    """Steady-state cost of the kernel-cost capture (``obs/kprof.py``, the
    counterpart of the reference's XLA cost capture) on ``kmeans_full``:
    with an instrument on, each kernel call is counted and a signature's
    first launch is timed between CUDA events.  The first instrumented call
    is reported apart (``capture_seconds_one_time``); later calls are timed
    in interleaved pairs against telemetry off."""
    import time

    import numpy as np

    from ..device import resolve_device
    from ..obs import Telemetry
    from ..ops.kmeans import kmeans_full
    from .harness import _sync

    dev = resolve_device(device)
    X = np.random.default_rng(11).normal(size=(n, d)).astype(np.float32)

    def one_call() -> float:
        t0 = time.perf_counter()
        kmeans_full(X, k, seed=0, max_iter=5, device=dev)
        _sync(dev)
        return time.perf_counter() - t0

    one_call()  # first launches outside both sides
    tel = Telemetry(kmeans_trace=False)  # the kernel costs alone, no trace
    with tel:
        capture_seconds = one_call()

    def instr() -> float:
        with tel:
            return one_call()

    plain, inst, _ = _paired(one_call, instr, calls)
    ratio = min(inst) / min(plain)
    return {
        "n": n, "d": d, "k": k,
        "plain_seconds_per_call": min(plain),
        "kprof_seconds_per_call": min(inst),
        "plain_calls": plain,
        "kprof_calls": inst,
        "capture_seconds_one_time": capture_seconds,
        "overhead_ratio": ratio,
        "budget": TELEMETRY_OVERHEAD_BUDGET,
        "within_budget": ratio <= TELEMETRY_OVERHEAD_BUDGET,
    }


def run_summary(quality: bool = True, device=None) -> dict:
    from ..device import resolve_device
    from . import harness
    from .harness import _device_stamp

    out: dict = {"hardware": _device_stamp(resolve_device(device)), "lloyd": {}, "e2e": {}}

    def bench(**kw):
        return lambda: harness.run_bench(device=device, **kw)

    # Quality once, in the config-2 record (three pipeline runs).
    _step(out["lloyd"], "config1", bench(config=1, quality=False))
    _step(out["lloyd"], "config2", bench(config=2, quality=quality))
    _step(out["lloyd"], "config2_bf16", bench(config=2, dtype="bfloat16", quality=False))
    _step(out["lloyd"], "config3", bench(config=3, quality=False))
    _step(out["lloyd"], "config4", bench(config=4, quality=False))
    _step(out["lloyd"], "config4_bf16", bench(config=4, dtype="bfloat16", quality=False))
    _step(out, "streaming", bench(config=5, quality=False))
    for cfg_num in (2, 3, 4):
        _step(out["e2e"], f"config{cfg_num}", bench(config=cfg_num, e2e=True, quality=False))

    def ingest():
        from . import ingest as ingest_mod
        return ingest_mod.bench_ingest()

    _step(out, "ingestion", ingest)
    if quality:
        # Real workloads (tens of seconds each), skipped by --no_quality.
        _step(out, "telemetry_overhead", lambda: telemetry_overhead(device=device))
        _step(out, "telemetry_overhead_control",
              lambda: telemetry_overhead_control(device=device))
        _step(out, "kprof_overhead", lambda: kprof_overhead(device=device))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.summary",
                                description="every BASELINE config, e2e, streaming and "
                                            "ingestion in one sweep")
    p.add_argument("--out", default=None, metavar="JSON",
                   help="write the summary here (default: stdout only)")
    p.add_argument("--no_quality", action="store_true",
                   help="skip the decision-quality and overhead runs")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    out = run_summary(quality=not args.no_quality, device=args.device)
    text = json.dumps(out, indent=2, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"[summary] wrote {args.out}", file=sys.stderr)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
