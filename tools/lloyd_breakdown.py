#!/usr/bin/env python3
"""Where the Lloyd kernel's general path spends its time, on one CUDA card.

    python3 tools/lloyd_breakdown.py            # the shapes below
    python3 tools/lloyd_breakdown.py --reps 10

Builds ``cdrs_tpu_torch/csrc/lloyd.cu`` three ways with ``nvcc`` (into
``cdrs_tpu_torch/_build/breakdown/``): as it is, without its statistics
(no sums are added; labels and counts stay), and with one tensor-core
product instead of three for f32 points (hi.hi' alone).  Each build is
called directly through its C interface on the same inputs at B1's wide
shapes and timed with a CUDA-event pair around back-to-back calls; the
differences say what the sums and the split product cost.  Only the build
"as is" gives the kernel's results: the others are for timing.  Prints the
card's name and power limit, then one JSON line a shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "cdrs_tpu_torch" / "csrc"
OUT = ROOT / "cdrs_tpu_torch" / "_build" / "breakdown"

#: Each variant: the source's exact text and what replaces it.
VARIANTS = {
    "as_is": [],
    "no_sums": [
        ("    if (xt != nullptr)\n      add_rows(", "    if (false && xt != nullptr)\n      add_rows("),
        ("for (int s0 = 0; s0 < k; s0 += p.slab) {", "for (int s0 = 0; false && s0 < k; s0 += p.slab) {"),
    ],
    "one_product": [
        ("      mma_tf32(acc[mt][nt], al[mt], bh0, bh1);\n"
         "      mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);\n", ""),
    ],
}
SHAPES = [(1 << 20, 32, 128, "float32"), (1 << 20, 32, 128, "bfloat16"),
          (1 << 20, 128, 1024, "float32"), (1 << 20, 128, 1024, "bfloat16"),
          (2_500_000, 5, 64, "float32")]
ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def build() -> dict:
    """Compile every variant at once; returns {name: loaded library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "tile.cuh").write_text((SRC / "tile.cuh").read_text())
    text = (SRC / "lloyd.cu").read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                sys.exit(f"lloyd_breakdown: {name}: the source no longer holds {old!r}")
            src = src.replace(old, new)
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
            sys.exit(f"lloyd_breakdown: nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        for fn in ("cdrs_lloyd_f32", "cdrs_lloyd_bf16"):
            getattr(lib, fn).argtypes = ARGTYPES
            getattr(lib, fn).restype = ctypes.c_int
        lib.cdrs_lloyd_extra_scratch.argtypes = [ctypes.c_int] * 3
        lib.cdrs_lloyd_extra_scratch.restype = ctypes.c_int64
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lloyd_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nb = 2 * sms
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for n, d, k, dtype in SHAPES:
        dt = getattr(torch, dtype)
        x = torch.rand((n, d), generator=gen, device="cuda").to(dt)
        c = x[torch.randperm(n, generator=gen, device="cuda")[:k]].float()
        labels = torch.empty(n, dtype=torch.int32, device="cuda")
        sums = torch.empty((k, d), device="cuda")
        counts = torch.empty(k, device="cuda")
        bf16 = int(dt == torch.bfloat16)
        ms = {}
        for name, lib in libs.items():
            if name == "one_product" and bf16:
                continue   # one bf16 product already
            extra = lib.cdrs_lloyd_extra_scratch(d, k, bf16)
            part_sums = torch.empty(nb * k * d + extra, device="cuda")
            part_counts = torch.empty(nb * k, dtype=torch.int32, device="cuda")
            ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
            fn = lib.cdrs_lloyd_bf16 if bf16 else lib.cdrs_lloyd_f32

            def call():
                err = fn(x.data_ptr(), c.data_ptr(), n, n, d, k, labels.data_ptr(),
                         part_sums.data_ptr(), part_counts.data_ptr(), ticket.data_ptr(),
                         sums.data_ptr(), counts.data_ptr(), nb, sms, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")

            for _ in range(2):
                call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            reps = max(3, args.reps // 4) if d * k > 100_000 else args.reps
            start.record()
            for _ in range(reps):
                call()
            end.record()
            end.synchronize()
            ms[name] = round(start.elapsed_time(end) / reps, 4)
        print(json.dumps({"n": n, "d": d, "k": k, "dtype": dtype, "ms": ms}), flush=True)
        del x, labels
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
