"""Run one cell once: set-up, the window, the metrics, the check, the result.

The result is the last line of standard output, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result.  Without as many CUDA cards as the
cell asks for the run prints no result and exits with 3.  After the window
it refuses to print a result if JAX or the JAX package was imported.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time

from . import spec as spec_mod
from .readers import Context
from .trace import Capture

#: Top-level module names that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "cdrs_tpu")
#: Unit index of the warm-up unit, outside the window's 0, 1, 2, ...
WARM = 1 << 40


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (the loaded modules)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(spec, seed: int, seconds: float, trace: bool, device, system, t0: float):
    """The result of one run: its metrics, device and, last, the numbers
    compared with their limits (``checks``)."""
    import torch

    from . import reference, traffic

    reference.no_tf32()
    torch.set_num_threads(1)
    if device.type == "cuda":
        system.build()
    tr = traffic.Traffic(spec, seed, device, [])
    pool = int(traffic.param(spec, "pool", 1))
    tr.data = [traffic.points(spec, seed, p, device) for p in range(pool)]
    capture = Capture(trace, device)
    t = time.perf_counter()
    tr.unit(system, WARM, capture.span, False)
    tr.sync()
    unit_s = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    if trace:
        # A traced window of a million launches takes minutes to stop and read.
        seconds = min(seconds, float(spec.cell.get("trace_seconds", seconds)))
    # The host paces the card in the decision cells: the window runs on one
    # intra-op thread (set above) with the cycle collector off.
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        win = tr.run(system, seconds, max(1, int(seconds / max(unit_s, 1e-6))), capture)
    finally:
        gc.enable()
        gc.unfreeze()
    win.setup_s = setup_s
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

    metrics, breakdown = {}, None
    if not trace:
        for m in spec.end_to_end:
            v = spec_mod.reader("e2e", m["name"], spec.root).read(win)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        ctx = Context(window=win, trace=capture.trace, device_name=name,
                      dtype=spec.config["dtype"])
        for m in spec.per_layer:
            v = spec_mod.reader("metrics", m["name"], spec.root).read(ctx)
            if v is None:
                ctx.note(f"{m['name']}: nothing to read in this run")
            else:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if capture.trace is not None:
            breakdown = {"device_ops": capture.trace.top_ops(),
                         "idle_gaps": capture.trace.idle_gaps()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": spec.chips, "memory_peak_bytes": peak}
    if trace and capture.trace is not None:
        w0, w1 = capture.trace.window
        dev.update(busy_s=capture.trace.busy_us() / 1e6, window_s=(w1 - w0) / 1e6)

    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = tr.check(system, win)
    print(f"portbench: set-up {setup_s:.3f} s, window {win.seconds:.3f} s, trace reduced in "
          f"{capture.reduce_s:.3f} s, check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    limits = spec.cell["limits"]
    checks = {k: {"value": v if math.isfinite(v) else sys.float_info.max, "limit": limits[k]}
              for k, v in numbers.items()}
    correct = bool(win.units) and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(win.units), "failed": 0,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = _args(argv)
    spec = spec_mod.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {spec.chips} CUDA card(s), found {have}; "
              f"no result", file=sys.stderr)
        return 3
    from .system import Program

    device = torch.device("cuda", 0)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), device, Program(), t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
