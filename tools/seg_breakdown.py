#!/usr/bin/env python3
"""Where the threshold count's general path spends its time, on one CUDA card.

    python3 tools/seg_breakdown.py            # the shapes below
    python3 tools/seg_breakdown.py --reps 10
    python3 tools/seg_breakdown.py --shape 10485760,128,256,float32

Builds ``cdrs_tpu_torch/csrc/seg_count.cu`` several ways with ``nvcc``
(into ``cdrs_tpu_torch/_build/seg_breakdown/``): as it is; without its
counting atomics (the compares go unused, so the build only stages x and
the labels through shared memory, folds and flushes its empty tables);
with each passing compare added into a register instead of a shared atomic
(the threshold loads and compares stay); staging x by cp.async copies
where it would use tensor copies; without its flush (blocks count but add
nothing into device memory); and with paired reads (below).  Each build is
called directly through its C interface, with the wrapper's plan
(``ops/seg_count.plan``) and scratch, on the same inputs at B2's
general-path shapes and timed with a CUDA-event pair around back-to-back
calls; the differences say what the counting and the flush cost.  Only
the build "as is" gives the kernel's results (checked here against the
wrapper's): the others are for timing.  Prints the card's name and power
limit, then one JSON line a shape.
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
OUT = ROOT / "cdrs_tpu_torch" / "_build" / "seg_breakdown"

#: Each variant: the source's exact text and what replaces it.
VARIANTS = {
    "as_is": [],
    "no_count": [
        ("              if (a) atomicAdd(s_pk + j * S + fb + q, a);\n", ""),
        ("            if (a) atomicAdd(s_pk + lab * S + f, a);\n", ""),
    ],
    "count_in_registers": [
        ("              if (a) atomicAdd(s_pk + j * S + fb + q, a);\n",
         "              gc[q] += a;\n"),
        ("            if (a) atomicAdd(s_pk + lab * S + f, a);\n", "            gc[f] += a;\n"),
    ],
    "cp_async_staging": [
        ("  const bool tma = !ROWS && SMEM &&", "  const bool tma = false && !ROWS && SMEM &&"),
    ],
    "no_flush": [
        ("        atomicAdd(acc + (int64_t)j * 2 * d + r * d + col0 + f, v);\n", ""),
    ],
    # Blocks of slices 2p and 2p + 1 both stage the 64 bytes of features
    # [16p, 16p + 16) of each row (twice the tile; d a multiple of 16, and
    # a small k so that the tiles fit: else no time), each counting its
    # own half.
    "pair_reads": [
        ("  static constexpr int XBYTES = WR * S * (int)sizeof(T);",
         "  static constexpr int XBYTES = 2 * WR * S * (int)sizeof(T);"),
        ("        stage_slice(dst, xb + (r0 * d + col0) * ESZ, rows, (int64_t)d * ESZ, w * ESZ,\n"
         "                    S * ESZ, chunk);",
         "        stage_slice(dst, xb + (r0 * d + (col0 & ~(2 * S - 1))) * ESZ, rows,\n"
         "                    (int64_t)d * ESZ, 2 * S * ESZ, 2 * S * ESZ, chunk);"),
        ("            const float2 x2 = load2(tx + r * S + fb);",
         "            const float2 x2 = load2(tx + r * 2 * S + (col0 & S) + fb);"),
    ],
}
#: (rows, d, k, dtype, half the rows in cluster 0)
SHAPES = [(2_499_997, 5, 64, "float32", False), (1 << 20, 128, 1024, "float32", False),
          (1 << 20, 128, 1024, "float32", True), (10_485_760, 128, 1024, "float32", False),
          (52_428_800, 128, 1024, "bfloat16", False)]
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def build() -> dict:
    """Compile every variant at once; returns {name: loaded library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "tile.cuh").write_text((SRC / "tile.cuh").read_text())
    text = (SRC / "seg_count.cu").read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                sys.exit(f"seg_breakdown: {name}: the source no longer holds {old!r}")
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
            sys.exit(f"seg_breakdown: nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        for fn in ("cdrs_seg_count_f32", "cdrs_seg_count_bf16"):
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
        sys.exit("seg_breakdown: needs a CUDA card")
    from cdrs_tpu_torch.device import sm_count
    from cdrs_tpu_torch.ops.seg_count import (_PATH_IDS, label_threshold_count, plan,
                                              scratch_lengths)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    libs = build()
    sms = sm_count(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for n, d, k, dtype_name, skew in shapes:
        dtype = getattr(torch, dtype_name)
        x = torch.empty((n, d), dtype=dtype, device="cuda")
        for i in range(0, n, 1 << 20):
            x[i:i + (1 << 20)] = torch.rand((min(n, i + (1 << 20)) - i, d), generator=gen,
                                            device="cuda")
        labels = torch.randint(-1, k, (n,), generator=gen, device="cuda", dtype=torch.int32)
        if skew:
            labels[:n // 2] = 0
        thr = torch.rand((2, k, d), generator=gen, device="cuda")
        gthr = torch.rand((2, d), generator=gen, device="cuda")
        p = plan(d, k, x.element_size())
        nb = 2 * sms if p.path == "small" else p.nslices
        n_part, n_ticket = scratch_lengths(p, nb, d, k)
        out = torch.empty(2 * k * d + 2 * d, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        row = {"n": n, "d": d, "k": k, "dtype": dtype_name, "skew": skew, "plan": p._asdict()}
        for name, lib in libs.items():
            part = torch.zeros(n_part, dtype=torch.int32, device="cuda")
            ticket = torch.zeros(n_ticket, dtype=torch.int32, device="cuda")
            fn = getattr(lib, "cdrs_seg_count_bf16" if dtype_name == "bfloat16"
                         else "cdrs_seg_count_f32")

            def call(fn=fn, part=part, ticket=ticket):
                return fn(x.data_ptr(), labels.data_ptr(), thr.data_ptr(), gthr.data_ptr(), n,
                          d, k, out.data_ptr(), part.data_ptr(), ticket.data_ptr(), nb, sms,
                          _PATH_IDS[p.path], p.slice, stream)

            err = call()
            if err and name == "as_is":
                sys.exit(f"seg_breakdown: launch failed: cudaError {err}")
            if err:   # a variant whose tiles do not fit at this k
                row[f"{name}_ms"] = None
                continue

            if name == "as_is":
                counts, gcounts = label_threshold_count(x, labels, thr, gthr)
                torch.cuda.synchronize()
                if not (torch.equal(out[:2 * k * d], counts.flatten())
                        and torch.equal(out[2 * k * d:], gcounts.flatten())):
                    sys.exit("seg_breakdown: the build as is differs from the wrapper")
            row[f"{name}_ms"] = time_ms(call, args.reps)
            del part, ticket
        print(json.dumps(row), flush=True)
        del x, labels, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
