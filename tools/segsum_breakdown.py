#!/usr/bin/env python3
"""Where the float segment sum (``label_segment_sum``) spends its time, on one
CUDA card.

    python3 tools/segsum_breakdown.py            # the shapes below
    python3 tools/segsum_breakdown.py --reps 10
    python3 tools/segsum_breakdown.py --shape 1048576,128,1024,float32,skew

Builds ``cdrs_tpu_torch/csrc/seg_sum.cu`` several ways with ``nvcc`` (into
``cdrs_tpu_torch/_build/segsum_breakdown/``): as it is; without its adds
(the blocks stage their rows and labels, then write their empty tables,
and the fold runs: what the reading and the partials cost); with one row
a batch (no two rows' values in flight at once); and with 1,024 threads a
block (32 warps own the clusters).  Each build is called through its C interface with
the wrapper's plan and row groups (``ops/seg_sum.plan``, ``groups``) on the
same inputs, timed with a CUDA-event pair around back-to-back calls; the
build as is also gives each of its two kernels' device time (the block
tables, the fold) from torch.profiler, and its result is checked against
the wrapper's (the others are for timing).  Prints the card's name and
power limit, then one JSON line a shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SRC = ROOT / "cdrs_tpu_torch" / "csrc"
OUT = ROOT / "cdrs_tpu_torch" / "_build" / "segsum_breakdown"

#: Each variant: the source's exact text and what replaces it.
VARIANTS = {
    "as_is": [],
    "no_adds": [
        ("    add_rows<T>(acc, (const int*)(b + L.row_bytes), (const T*)b, list, m, s0, h, s, w,"
         " cj, t);\n", ""),
    ],
    "batch_of_one": [("constexpr int kBatch = 8;", "constexpr int kBatch = 1;")],
    "threads_1024": [("constexpr int kThreads = 512;", "constexpr int kThreads = 1024;")],
}
#: (rows, d, k, dtype, half the rows in cluster 0)
SHAPES = [(2_499_997, 5, 8, "float32", False), (1 << 20, 128, 1024, "float32", False),
          (1 << 20, 128, 1024, "bfloat16", False), (1 << 20, 128, 1024, "float32", True),
          (1_000_000, 4, 20_000, "float32", False), (17_000_000, 128, 1024, "bfloat16", False)]
ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_int] * 6 + [ctypes.c_int64]
            + [ctypes.c_void_p] * 3)


def build() -> dict:
    """Compile every variant at once; returns {name: loaded library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "tile.cuh").write_text((SRC / "tile.cuh").read_text())
    text = (SRC / "seg_sum.cu").read_text()
    sources = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                sys.exit(f"segsum_breakdown: {name}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        sources[name] = src
    jobs = {}
    for name, src in sources.items():
        (OUT / f"{name}.cu").write_text(src)
        cmd = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", str(OUT / f"lib{name}.so"),
               str(OUT / f"{name}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"segsum_breakdown: nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        for fn in ("cdrs_seg_sum_f32", "cdrs_seg_sum_bf16"):
            getattr(lib, fn).argtypes = ARGTYPES
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int) -> dict:
    """Device ms a call of each kernel whose name holds "seg_sum", by the
    name's kernel (tables or fold), from torch.profiler."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    got = {"tables": 0.0, "fold": 0.0}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and "seg_sum" in ev.name:
            got["fold" if "fold" in ev.name else "tables"] += ev.time_range.elapsed_us()
    return {f"{key}_device_ms": us / reps / 1e3 for key, us in got.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--shape", action="append", default=[],
                        help="rows,d,k,dtype[,skew] instead of the shapes above (repeatable)")
    args = parser.parse_args()
    shapes = [(int(a), int(b), int(c), t, bool(rest)) for a, b, c, t, *rest in
              (s.split(",") for s in args.shape)] or SHAPES
    import torch

    if not torch.cuda.is_available():
        sys.exit("segsum_breakdown: needs a CUDA card")
    from cdrs_tpu_torch.ops import seg_sum
    from cdrs_tpu_torch.ops.seg_sum import label_segment_sum

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    libs = build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for n, d, k, dtype_name, skew in shapes:
        dtype = getattr(torch, dtype_name)
        y = torch.empty((n, d), dtype=dtype, device="cuda")
        for i in range(0, n, 1 << 20):
            y[i:i + (1 << 20)] = torch.rand((min(n, i + (1 << 20)) - i, d), generator=gen,
                                            device="cuda")
        lab = torch.randint(-1, k, (n,), generator=gen, device="cuda", dtype=torch.int32)
        if skew:
            lab[:n // 2] = 0
        p = seg_sum.plan(d, k, y.element_size())
        g, group_rows = seg_sum.groups(n, p, seg_sum._resident(0, dtype, p))
        part = torch.empty(p.tiles * g * p.slab * p.slice, dtype=torch.float32, device="cuda")
        out = torch.empty((k, d), dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        row = {"n": n, "d": d, "k": k, "dtype": dtype_name, "skew": skew, "plan": p._asdict(),
               "groups": g, "group_rows": group_rows}
        for name, lib in libs.items():
            fn = getattr(lib, "cdrs_seg_sum_bf16" if dtype_name == "bfloat16"
                         else "cdrs_seg_sum_f32")

            def call(fn=fn):
                return fn(y.data_ptr(), lab.data_ptr(), n, d, k, p.slice, p.slab, p.rows, g,
                          group_rows, part.data_ptr(), out.data_ptr(), stream)

            err = call()
            if err:
                sys.exit(f"segsum_breakdown: {name} launch failed: cudaError {err}")
            if name == "as_is":
                want = label_segment_sum(lab, y, k)
                torch.cuda.synchronize()
                if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                    sys.exit("segsum_breakdown: the build as is differs from the wrapper")
                row.update(kernel_ms(call, max(3, args.reps // 2)))
            row[f"{name}_ms"] = time_ms(call, args.reps)
        print(json.dumps(row), flush=True)
        del y, lab, part, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
