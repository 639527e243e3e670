#!/usr/bin/env python3
"""Where the Lloyd kernel's general paths spend their time, on one CUDA card,
and beside another checkout's kernel.

    python3 tools/lloyd_breakdown.py               # the shapes below
    python3 tools/lloyd_breakdown.py --wide        # ... and config 3's and the rehearsal's rows
    python3 tools/lloyd_breakdown.py --reps 10
    python3 tools/lloyd_breakdown.py --parent DIR  # ... and DIR's kernel, in turns

Builds ``cdrs_tpu_torch/csrc/lloyd.cu`` (with its headers) five ways with
``nvcc``, into ``cdrs_tpu_torch/_build/breakdown/``: as it is; without its
statistics (no sums are added; labels and counts stay); with one
tensor-core product instead of three for f32 points (hi.hi' alone); and,
on the wgmma path, without its products or without its ranking epilogue,
both also without the sums (the labels they leave would change the sums'
work): the loads, waits and ranking of whatever the accumulators hold, or
the products alone.  Each build is
called through its C interface with the plan ``ops/lloyd.plan`` gives the
shape, on the same inputs (``with_labels`` off, as the Lloyd loop calls
it).  A row's ``device_ms`` are torch.profiler's kernel
time a launch (from the first of up to four reads that saw a launch;
``reads`` lists the records each read saw), ``event_ms`` one CUDA-event pair around back-to-back calls of
the wrapper (host included), ``library_ms`` the product ``x @ c.T`` alone
(1M-row chunks at the wide rows) and ``bound_ms`` ``obs/kprof``'s bound.
Only the build as it is gives the kernel's results: the others are for
timing.

``--parent DIR`` also times ``lloyd_assign_reduce`` of the checkout in DIR
(built there by its own ``ops/_build``) in a child process before and after
this checkout's rows, on inputs drawn as here, with the same formula
(torch.profiler's device time a launch); a row's ``parent_device_ms`` is
the lower of the two.  ``--code DIR`` is that child.

Prints the card's name and power limit, the ptxas lines of the wgmma
instances, then one JSON line a shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SRC = ROOT / "cdrs_tpu_torch" / "csrc"
OUT = ROOT / "cdrs_tpu_torch" / "_build" / "breakdown"

#: Each variant: (file, the source's exact text, what replaces it).
NO_SUMS = [
    ("lloyd_wgmma.cuh", "  sorted_sums<T>(p, smem, g_cnt,", "  if (false) sorted_sums<T>(p, smem, g_cnt,"),
    ("lloyd.cu", "      add_rows<kWarps>(s_acc", "      if (false) add_rows<kWarps>(s_acc"),
    ("lloyd.cu", "    stat_passes<T, kThreads>(", "    if (false) stat_passes<T, kThreads>("),
]
#: Each variant: (file, the source's exact text, what replaces it).
VARIANTS = {
    "as_is": [],
    "no_sums": NO_SUMS,
    "one_product": [
        ("lloyd_wgmma.cuh",
         "    mma_tf32(acc[m], al[S][m], bh, sd);\n"
         "    mma_tf32(acc[m], ah[S][m], bl, 1);\n"
         "    mma_tf32(acc[m], ah[S][m], bh, 1);\n",
         "    mma_tf32(acc[m], ah[S][m], bh, sd);\n"),
        ("lloyd.cu", "      mma_tf32(acc[mt][nt], al[mt], bh0, bh1);\n"
                     "      mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);\n", ""),
    ],
    # Without the sums too: the labels these leave would change the sums' work.
    "no_products": NO_SUMS + [
        ("lloyd_wgmma.cuh",
         "    mma_tf32(acc[m], al[S][m], bh, sd);\n"
         "    mma_tf32(acc[m], ah[S][m], bl, 1);\n"
         "    mma_tf32(acc[m], ah[S][m], bh, 1);\n", ""),
        ("lloyd_wgmma.cuh",
         "          mma_bf16(acc[0], a0 + 2 * ks, b + 2 * ks, sd);\n"
         "          mma_bf16(acc[1], a1 + 2 * ks, b + 2 * ks, sd);\n", ""),
    ],
    "no_rank": NO_SUMS + [
        ("lloyd_wgmma.cuh", "  auto rank = [&](int m, int jt) {\n", "  auto rank = [&](int m, int jt) {\n    return;\n"),
    ],
}
SHAPES = [(1 << 20, 32, 128, "float32"), (1 << 20, 32, 128, "bfloat16"),
          (1 << 20, 128, 1024, "float32"), (1 << 20, 128, 1024, "bfloat16"),
          (2_500_000, 5, 64, "float32")]
CONFIG3_ROWS = 10_485_760
CHUNK_ROWS = 1 << 20
#: torch.profiler reads a row may take before its device time is null.
READS = 4
ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)


def build() -> tuple[dict, str]:
    """Compile every variant at once; ({name: loaded library}, the ptxas
    lines of the build as it is that name a wgmma instance)."""
    sources = {p.name: p.read_text() for p in [SRC / "lloyd.cu", *sorted(SRC.glob("*.cuh"))]}
    jobs = {}
    for name, subs in VARIANTS.items():
        out = OUT / name
        out.mkdir(parents=True, exist_ok=True)
        texts = dict(sources)
        for fname, old, new in subs:
            if old not in texts[fname]:
                sys.exit(f"lloyd_breakdown: {name}: {fname} no longer holds {old!r}")
            texts[fname] = texts[fname].replace(old, new)
        for fname, text in texts.items():
            (out / fname).write_text(text)
        cmd = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
               str(out / "liblloyd.so"), str(out / "lloyd.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs, ptxas = {}, ""
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"lloyd_breakdown: nvcc failed on {name}:\n{log}")
        if name == "as_is":
            ptxas = wgmma_ptxas(log)
        lib = ctypes.CDLL(str(OUT / name / "liblloyd.so"))
        for fn in ("cdrs_lloyd_f32", "cdrs_lloyd_bf16"):
            getattr(lib, fn).argtypes = ARGTYPES
            getattr(lib, fn).restype = ctypes.c_int
        lib.cdrs_lloyd_plan_info.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        lib.cdrs_lloyd_plan_info.restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def wgmma_ptxas(log: str) -> str:
    """The ptxas lines (registers, spills, warnings) of the wgmma instances."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "lloyd_wgmma_kernel" in line
        if keep or ("wgmma" in line and "warning" in line):
            out.append(line.strip())
    return "\n".join(out)


def inputs(n, d, k, dtype, gen):
    """x (n, d) uniform in ``dtype`` (drawn in 1M-row chunks) and k of its
    rows as the centroids, as ``chip_smoke.check_lloyd`` draws them."""
    import torch

    import chip_smoke as smoke

    x = smoke.rand_rows(n, d, dtype, n, gen, CHUNK_ROWS if n > CHUNK_ROWS else None)
    c = x[torch.randperm(n, generator=gen, device="cuda")[:k]].float()
    return x, c


def shapes(wide: bool) -> list:
    out = list(SHAPES)
    if wide:
        import chip_smoke as smoke

        out += [(CONFIG3_ROWS, 128, 1024, "float32"),
                (smoke.rehearsal_rows(), 128, 1024, "bfloat16")]
    return out


def code_rows(code: str, wide: bool, reps: int) -> list:
    """The rows of the checkout in ``code`` from a child process (``--code``)."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--code", os.path.abspath(code),
           "--reps", str(reps)] + (["--wide"] if wide else [])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1500,
                          cwd=os.path.abspath(code))
    if proc.returncode != 0:
        sys.exit(f"lloyd_breakdown: the child over {code} failed (rc {proc.returncode}): "
                 f"{proc.stderr[-3000:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]


def child(code: str, wide: bool, reps: int) -> int:
    """Times ``lloyd_assign_reduce`` of the checkout in ``code`` alone."""
    import torch

    import chip_smoke as smoke   # this checkout's timers, before DIR's package

    sys.path.insert(0, code)
    import cdrs_tpu_torch
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce

    if not Path(cdrs_tpu_torch.__file__).resolve().is_relative_to(Path(code).resolve()):
        sys.exit(f"lloyd_breakdown: imported {cdrs_tpu_torch.__file__}, not {code}'s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for n, d, k, dt in shapes(wide):
        x, c = inputs(n, d, k, getattr(torch, dt), gen)
        call = lambda: lloyd_assign_reduce(x, c, n, with_labels=False)  # noqa: E731
        reads = []
        dev, seen = smoke.device_ms(call, "lloyd_", max(3, reps // 2), tries=READS, reads=reads)
        print(json.dumps({"n": n, "d": d, "k": k, "dtype": dt, "device_ms": dev,
                          "launches_seen": seen, "reads": reads}), flush=True)
        del x, c
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--wide", action="store_true",
                    help="also config 3's 10,485,760 x 128 f32 and the rehearsal's bf16 rows")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="also time the kernel of the checkout in DIR, before and after")
    ap.add_argument("--code", metavar="DIR", default=None,
                    help="time the kernel of the checkout in DIR alone (the child)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lloyd_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    if args.code:
        return child(os.path.abspath(args.code), args.wide, args.reps)
    import chip_smoke as smoke
    from cdrs_tpu_torch.obs import kprof
    from cdrs_tpu_torch.ops import lloyd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    parent = [code_rows(args.parent, args.wide, args.reps)] if args.parent else []
    libs, ptxas = build()
    print(ptxas, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nb = 2 * sms
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for n, d, k, dtype in shapes(args.wide):
        dt = getattr(torch, dtype)
        x, c = inputs(n, d, k, dt, gen)
        bf16 = int(dt == torch.bfloat16)
        p = lloyd.plan(d, k, dt)
        sums = torch.empty((k, d), device="cuda")
        counts = torch.empty(k, device="cuda")
        labels = torch.empty(n, dtype=torch.int32, device="cuda")
        order = torch.empty(n, dtype=torch.int32, device="cuda")
        reps = max(3, args.reps // 4) if n * k * d > 1e10 else args.reps
        runs = [(name, p) for name in libs
                if not (name == "one_product" and bf16)          # one bf16 product already
                and not (name in ("no_rank", "no_products") and p.path != "wgmma")]
        dev, reads = {}, {}
        for name, plan in runs:
            lib = libs.get(name, libs["as_is"])
            arg = (ctypes.c_int * len(plan.as_ints()))(*plan.as_ints())
            info = (ctypes.c_int64 * 3)()
            if lib.cdrs_lloyd_plan_info(d, k, bf16, arg, info) != 0:
                sys.exit(f"lloyd_breakdown: no layout for {plan} at d={d}, k={k}")
            part_sums = torch.empty(nb * k * d + info[0], device="cuda")
            part_counts = torch.empty(nb * k, dtype=torch.int32, device="cuda")
            ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
            fn = lib.cdrs_lloyd_bf16 if bf16 else lib.cdrs_lloyd_f32

            def call():
                err = fn(x.data_ptr(), c.data_ptr(), n, n, d, k,
                         labels.data_ptr() if info[1] else None, part_sums.data_ptr(),
                         part_counts.data_ptr(), ticket.data_ptr(), sums.data_ptr(),
                         counts.data_ptr(), nb, sms, stream, arg,
                         order.data_ptr() if plan.path == "wgmma" else None)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")

            reads[name] = []
            dev[name] = smoke.device_ms(call, "lloyd_", reps, tries=READS, reads=reads[name])[0]
            del part_sums, part_counts
        wrapper = lambda: lloyd.lloyd_assign_reduce(x, c, n, with_labels=False)  # noqa: E731
        c_op = lloyd.centroid_operands(c, dt)[0].to(dt)
        lib_ms = (smoke.chunked_product_ms(x, c_op, reps, CHUNK_ROWS) if n > CHUNK_ROWS
                  else smoke.time_ms(lambda: x @ c_op.T, reps))
        b_ms, b_by = smoke.bound_ms(kprof.kernel_cost(
            "lloyd_assign_reduce", n=n, d=d, k=k, n_valid=n, dtype=dtype, with_labels=False))
        rows.append({"n": n, "d": d, "k": k, "dtype": dtype, "plan": p._asdict(),
                     "device_ms": dev, "reads": reads,
                     "event_ms": smoke.time_ms(wrapper, reps),
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
        if not args.parent:
            print(json.dumps(rows[-1]), flush=True)
        del x, c, labels, order
        torch.cuda.empty_cache()
    if args.parent:
        parent.append(code_rows(args.parent, args.wide, args.reps))
        for row in rows:
            times = [r["device_ms"] for runs in parent for r in runs
                     if (r["n"], r["d"], r["k"], r["dtype"]) ==
                     (row["n"], row["d"], row["k"], row["dtype"]) and r["device_ms"] is not None]
            row["parent_device_ms"] = min(times) if times else None
            row["parent_reads"] = [r["device_ms"] for runs in parent for r in runs
                                   if (r["n"], r["d"], r["k"]) == (row["n"], row["d"], row["k"])
                                   and r["dtype"] == row["dtype"]]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
