"""The readings that set a cell's limits: the numbers the check compares,
for the program on many seeds and for the control on a few, at the cell's
own size, in one process.

The control is the reference put in the program's place and computed in
the nearest precision below the configuration's float32: TF32, both
operands of every product rounded to TF32.  A sound program reads under a
cell's limits and the control over one of them.  ``--fault-seeds`` adds
runs of the program with its k-means|| init replaced by k distinct rows
drawn from the seed (``RowsInit``), the fault ``init_excess`` is there to
catch.

``python3 -m portbench.control --workload c3-lloyd --seeds 12 --control-seeds 3``
prints one JSON line a seed and then the largest program reading and the
smallest control and fault readings of each number.  The benchmark's own
runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from . import keyed, reference, spec as spec_mod, traffic
from .run import WARM
from .system import Program


class RowsInit(Program):
    """The program with its k-means|| init replaced by k distinct rows drawn
    from the seed: a cheaper init of the same shape."""

    name = "rows-init"

    def solve(self, X, k, *, seed=None, init_centroids=None, **kw):
        if init_centroids is None:
            rows = keyed.rng(seed, keyed.INIT_ROWS, 0).choice(X.shape[0], k, replace=False)
            init_centroids = X[torch.from_numpy(np.sort(rows)).to(X.device)].float()
        return super().solve(X, k, seed=seed, init_centroids=init_centroids, **kw)


def readings(spec, seed: int, system, device) -> dict:
    """The check's numbers after ``samples`` units of the cell's loop, every
    one of them kept."""
    tr = traffic.Traffic(spec, seed, device, [])
    pool = int(traffic.param(spec, "pool", 1))
    tr.data = [traffic.points(spec, seed, p, device) for p in range(pool)]
    win = traffic.Window()
    win.launches["before"] = system.launches()
    for i in range(int(spec.cell.get("samples", 2))):
        rec, ans = tr.unit(system, i, lambda name: contextlib.nullcontext(), False)
        win.units.append(rec)
        win.kept[i] = ans
    win.launches["after"] = system.launches()
    out = tr.check(system, win)
    del tr
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=0)
    p.add_argument("--base", type=int, default=WARM, help="first seed's key")
    args = p.parse_args(argv)
    spec = spec_mod.load(args.workload)
    device = torch.device("cuda", 0)
    Program.build()
    reference.no_tf32()
    worst, least = {}, {"control": {}, "fault": {}}
    runs = [("program", Program(), i) for i in range(args.seeds)]
    runs += [("control", reference.Reference("tf32"), i) for i in range(args.control_seeds)]
    runs += [("fault", RowsInit(), i) for i in range(args.fault_seeds)]
    for side, system, i in runs:
        seed = keyed.derived_seed(args.base, 99, i)
        t = time.perf_counter()
        got = readings(spec, seed, system, device)
        print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                          "seconds": time.perf_counter() - t, **got}), flush=True)
        for k, v in got.items():
            if side == "program":
                worst[k] = max(worst.get(k, 0.0), v)
            else:
                least[side][k] = min(least[side].get(k, float("inf")), v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": worst,
                      "control_min": least["control"], "fault_min": least["fault"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
