#!/usr/bin/env python3
"""Where the float segment sum (``label_segment_sum``) spends its time, on one
CUDA card, launch by launch, and beside another checkout's kernel.

    python3 tools/segsum_breakdown.py                  # every row of chip_smoke.SEGSUM_ROWS
    python3 tools/segsum_breakdown.py --reps 10
    python3 tools/segsum_breakdown.py --row wide --row k20000
    python3 tools/segsum_breakdown.py --parent DIR     # ... and DIR's kernel, in turns

A call is ``passes + 3`` launches (``csrc/seg_sum.cu``): the histogram of
the labels' digits (``seg_sum_hist``), one counting-sort pass a digit
(``seg_sum_pass``), the sums of the chunks of the sorted order
(``seg_sum_rows`` or ``seg_sum_cols``: each warp also finds its chunk's
pieces and their output slots from the sorted keys, so offsets and pieces
take no launch of their own) and the fold of the clusters that span
chunks (``seg_sum_fold``).  For each row (shapes and labels as the smoke
draws them) the tool reads ``label_segment_sum`` under torch.profiler
and, over the calls it saw whole (``chip_smoke.whole_read``: each of the
call's launches, from its histogram on), gives each stage's device ms a
call and their total, beside one CUDA-event pair around back-to-back
calls (wrapper and launch gaps included), ``index_add_``'s time on the
same inputs and the plan.

``--parent DIR`` also times the ``label_segment_sum`` of the checkout in
DIR (built there by its own ``ops/_build``), in a child process before and
after this checkout's rows, on inputs drawn as here; a row's
``parent_device_ms`` is the lower of the two.  The child takes a call's
launches and first kernel from single-call reads (the one that saw the
most: the profiler drops records, never adds them) and its device time
from the calls it saw whole, as above.
``--code DIR`` is that child: the rows of DIR's kernel alone.

Prints the card's name and power limit, then one JSON line a row.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: Stage of each kernel, by the name the profiler gives it; any other
#: ``seg_sum_`` kernel (another checkout's) is "other".
STAGES = (("seg_sum_hist", "histogram"), ("seg_sum_pass", "passes"), ("seg_sum_rows", "sums"),
          ("seg_sum_cols", "sums"), ("seg_sum_fold", "fold"))


def stage_ms(smoke, fn, launches: int, first: str, reps: int) -> dict:
    """Device ms a call of each stage and in all, over the calls of ``reps``
    that torch.profiler saw whole (``launches`` records from the one named
    ``first`` on; ``chip_smoke.whole_read``); the records each read saw and
    the whole calls used."""
    calls, seen = smoke.whole_read(fn, "seg_sum_", launches, first, reps)
    row = {"launches": launches, "reads_saw": seen, "device_ms": None}
    if calls is None:
        return row
    got = {stage: 0.0 for _, stage in STAGES} | {"other": 0.0}
    for name, us in (rec for c in calls for rec in c):
        got[next((stage for key, stage in STAGES if key in name), "other")] += us
    row.update({f"{stage}_device_ms": us / len(calls) / 1e3 for stage, us in got.items() if us})
    row["device_ms"] = sum(got.values()) / len(calls) / 1e3
    row["whole_calls"] = len(calls)
    return row


def code_rows(code: str, names: list, reps: int) -> list:
    """The rows of the checkout in ``code`` from a child process (``--code``)."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--code", os.path.abspath(code),
           "--reps", str(reps)] + [a for name in names for a in ("--row", name)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.abspath(code))
    if proc.returncode != 0:
        sys.exit(f"segsum_breakdown: the child over {code} failed (rc {proc.returncode}): "
                 f"{proc.stderr[-3000:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--row", action="append", default=[],
                        help="a SEGSUM_ROWS name (repeatable); all rows by default")
    parser.add_argument("--parent", metavar="DIR", default=None,
                        help="also time the kernel of the checkout in DIR, before and after")
    parser.add_argument("--code", metavar="DIR", default=None,
                        help="time the kernel of the checkout in DIR alone (the child)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("segsum_breakdown: needs a CUDA card")
    import chip_smoke as smoke   # this checkout's rows and timers, before DIR's package

    if args.code:
        sys.path.insert(0, os.path.abspath(args.code))
    import cdrs_tpu_torch
    from cdrs_tpu_torch.ops import seg_sum
    from cdrs_tpu_torch.ops.seg_sum import label_segment_sum

    home = Path(args.code).resolve() if args.code else ROOT
    if not Path(cdrs_tpu_torch.__file__).resolve().is_relative_to(home):
        sys.exit(f"segsum_breakdown: imported {cdrs_tpu_torch.__file__}, not {home}'s")
    rows = [r for r in smoke.SEGSUM_ROWS if not args.row or r[0] in args.row]
    if not rows:
        sys.exit(f"segsum_breakdown: no row named {args.row}")
    names = [r[0] for r in rows]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    reps = max(3, args.reps // 2)
    parent = [code_rows(args.parent, names, args.reps)] if args.parent else []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = []
    for name, n, d, k, dt, kw in rows:
        y, lab = smoke.segsum_inputs(n, d, k, getattr(torch, dt), gen, **kw)

        def call():
            return label_segment_sum(lab, y, k)

        row = {"row": name, "n": n, "d": d, "k": k, "dtype": dt}
        if args.code:
            one = max((smoke.kernel_records(call, "seg_sum_", 1) for _ in range(3)), key=len)
            row.update(code=str(home), **stage_ms(smoke, call, len(one), one[0][0], reps))
        else:
            p = seg_sum.plan(d, k, n)
            row.update(plan=p._asdict(), **stage_ms(smoke, call, p.launches, "seg_sum_hist",
                                                    reps),
                       library_ms=smoke.library_segsum_ms(lab, y, k, max(2, args.reps // 2),
                                                          kw.get("chunk_rows")))
        row["event_ms"] = smoke.time_ms(call, args.reps)
        out.append(row)
        if not args.parent:
            print(json.dumps(row), flush=True)
        del y, lab
        torch.cuda.empty_cache()
    if args.parent:
        parent.append(code_rows(args.parent, names, args.reps))
        for row in out:
            times = [r["device_ms"] for runs in parent for r in runs
                     if r["row"] == row["row"] and r["device_ms"] is not None]
            row["parent_device_ms"] = min(times) if times else None
            row["parent_reads"] = [r for runs in parent for r in runs if r["row"] == row["row"]]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
