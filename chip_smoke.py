#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cdrs_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel checks only (no ok line)
    python3 chip_smoke.py --phase 10 # build, kernel checks and one phase (9,
                                     # 10, 11, 12, 13 or 14) alone; no ok line

Phases, each of which exits non-zero when a check fails:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the build of every CUDA kernel from
   ``cdrs_tpu_torch/csrc`` (one nvcc per source, all at once).
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes and at wider ones: labels (every row), sums and counts of
   the Lloyd kernel, both as the full-batch loop calls it and as the
   stream path does (labels written, non-zero rows past ``n_valid``), and
   two calls on the same inputs giving the same bits; exact per-cluster
   and global tables of the fused threshold count, and its k = 1 form
   without a global table; one whole bisection on the card (12 launches)
   against the same on the CPU.  Each kernel's time per call is one pair
   of CUDA events around back-to-back calls (wrapper included), its
   ``device_ms`` the kernel's own time per launch from torch.profiler,
   which also shows one launch per call.
3. The main path: ``run_pipeline`` on CUDA over 2,500,000 files (seed 10,
   60 s of simulated traffic, k = 8, validated scoring with medians from
   the data).  The Lloyd kernel must run ``kmeans.n_iter + 1`` times and
   the threshold count 12 times, and the planted-category accuracy must
   exceed 0.5.  A profiled second clustering pass shows the device idle
   share, no separate reduction kernel and the NaN fills left.
4. The card against the CPU: the pipeline at 20,000 files from one carried
   init on both devices; labels agree on >= 99.9% of files and the
   per-cluster categories are identical.
5. The stream path on CUDA over phase 3's population and events: the log
   written as ``.cdrsb``; ``fold_stream`` in 4M-event batches, whose
   finalized table must equal phase 3's batch table bit for bit;
   mini-batch KMeans (``batch_size`` 262,144) through
   ``ReplicationPolicyModel.run``, whose Lloyd launches must be one per
   update plus one per predict chunk; ``detect_drift_torch`` on the first
   half of the log against phase 3's model, one launch, held against the
   host oracle (centroid shift within 1e-4, fractions within 1e-6); and
   mini-batch on the card against the CPU at 20,000 files from one init.
6. The controller on CUDA over phase 5's population and events, inside
   ``deterministic()``: ``ReplicationController.run`` with 10 s windows,
   drift threshold 0 (every window after the cold start re-clusters warm),
   at most 250,000 migrated files per window and a checkpoint every
   window.  Window 0 must be a cold full re-cluster and every later one a
   warm drift re-cluster; the Lloyd kernel must run sum(n_iter + 1) times
   and the threshold count 12 times per re-cluster; the final counters
   must give phase 3's batch table bit for bit.  A run killed after 3
   windows and resumed (one window of it under torch.profiler, for the
   device idle share) must give the full run's plan hash in every window
   and its final plan.  At 20,000 files (phase 4's workload), the
   controller on the card and on the CPU, from one carried init, must make
   the same re-clusters with the same per-cluster categories, and final
   per-file categories agreeing on >= 99.9% of files.
7. The streaming daemon on CUDA over phase 5's ``.cdrsb`` log, with phase
   6's settings: (a) a full run with mini-batch tracking, decision tracing
   and a checkpoint every window, whose records must equal phase 6's, with
   one published epoch per window, the pinned epoch the final plan,
   B1 = sum(n_iter + 1) and B2 = 12 per re-cluster by the counters, B3 one
   launch per window (the mini-batch step), and every decision trace's
   segments summing to its total; (b) a stop after 3 windows, one profiled
   resumed decision (device idle share) and a second resume, whose joined
   records must equal (a)'s after reading fewer events than the log holds,
   with continuing epoch ids; (c) 1,000,000 seeded reads resolved from the
   pinned epoch, equal to the CPU placement, with rf distinct nodes and the
   primary first; (d) at 20,000 files (phase 4's workload) a follow-mode
   daemon at the default drift threshold over a log written in 4 parts,
   stopped by a SIGTERM request, whose records must be a prefix of a
   non-follow run's, with at least one window that skips the re-cluster;
   then brownout runs over the whole log, which must coalesce windows,
   fold every event once, replay byte-identically apart from the
   wall-clock fields, and give the CPU's plan hashes.
8. The chaos controller (the fault, repair and scrub path) on CUDA over
   phase 5's population and events, with phase 6's settings (the 250,000
   files a window shared by repairs, scrub and migrations), rf >= 2 from
   the start, dn2 crashed over windows 2-3, 5% of dn1's copies rotten at
   window 1, a 50 GB scrub budget a window and repair seed 0: (a) B1 =
   sum(n_iter + 1) and B2 = 12 per re-cluster by the counters, dn2 down and
   repairs in windows 2-3, durability and integrity in every window, no
   file lost while two nodes live beyond the rotten copies the scrubber
   had quarantined, and a kill after window 3 (the run's snapshot then,
   copied aside) resumed in a new controller (its first window, dn2's
   recovery, profiled for the idle share) giving every later record but ``seconds``
   and the final ``ClusterState.state_arrays()`` of the uninterrupted run;
   (b) phase 4's workload on 12 nodes in 4 racks with a
   whole-rack kill, a partition and a straggler, whose plan hashes,
   durability tiers, repair counts and final state arrays on the card
   equal the CPU's from one init; (c) phase 4's workload with decay 0.7,
   whose float64 accumulators and plan hashes on the card equal the CPU's.
9. The scenario matrix (``cdrs_tpu_torch.scenarios.run_cell``) on CUDA:
   (a) every cell of the ``full`` suite at suite seed 0 but the mesh cell
   (phase 14c): the twenty-one other ``ci-smoke`` cells, ``control-shift``,
   the serving ``random-s0-3`` and the replicate-storage ``random-s0-2``, each
   ``ok`` from the card's own cold init (the rows its D² init picked are
   logged; a cell of ``SCENARIO_QUEUE_C`` must fail exactly its recorded
   invariants there), with B1 = sum(n_iter + 1) over the cell's
   re-clusters and no B2 launch (300-400 files sort their medians); then
   each cell on the card and on the CPU from cold inits computed on
   the CPU, whose invariants, metrics and coverage bits must be equal;
   (b) ``gradual-drift`` at 2,500,000 files in 10 windows over 30 s (cuts:
   files, windows and span, no alert gating), ``ok`` to its end, with B1 = sum(n_iter + 1) and B2 =
   12 per re-cluster (2.5M rows resolve to bisection), its mean seconds a
   window by stage and the idle share of one profiled window.
10. The read path: (a) the serving controller (``ServeConfig(policy=
   "p2c")``) on CUDA over phase 3's population and a flash crowd (phase 3's
   traffic plus a seeded 1% cohort of hot files, 25,000, boosted 40x over
   [30 s, 36 s)), with phase 6's settings and a drift threshold above any
   drift score, so that only the cold start and the hotspot re-cluster: at
   least one ``hotspot`` re-cluster, B1 = sum(n_iter + 1) and B2 = 12 per
   re-cluster by the counters, the ``serve`` digest, seconds a window by
   stage (``hotspot`` and ``serve`` among them), the idle share of the
   profiled hotspot window, and a kill after window 3 resumed in a new
   controller giving the uninterrupted records and hotspot baseline; (b)
   ``python -m cdrs_tpu_torch serve`` over 10a's manifest and log (p2c,
   host only: it runs with no card visible), its digest and routed reads a
   second; (c) at 20,000 files on 6 nodes in 3 racks the serving chaos
   controller with a partition and a straggler, and with rot and verified
   reads, on the card and on the CPU from one init: every record (drift
   scalars within 1e-6), ``state_arrays()`` and the hotspot baseline
   equal, and reads detecting rot; (d) at 20,000 files the daemon with
   serving and the brownout ladder forced to ``shed_reads`` (burn trip
   wire 0): reads shed in the shed windows and every record equal to a
   controller's fed the same windows under the same ``serve_shed``.
11. Storage strategies, HDFS's RS-6-3-1024k policy (``ec_archival``:
   EC(6,3) Archival on the cold tier) on 12 DataNodes in 4 racks of 3,
   rack r1 crashed for good: (a) 2,500,000 files generated on dn1..dn12
   (seed 10, 40 s of traffic, 4 windows of 10 s, the crash from window 2)
   with phase 8's settings (rf >= 2, 250,000 files a window): no file lost
   in any window, a ``storage`` record in each, B1 = sum(n_iter + 1) and
   B2 = 12 per re-cluster by the counters, seconds a window by stage, the
   crash window's idle share, and a kill after window 2 resumed to the same
   records and ``state_arrays()``; (b) 20,000 files over 720 s (6 windows
   of 120 s, the crash from window 3)
   with no storage, ``replicate`` and ``ec_archival`` on the card:
   ``replicate`` equal to no storage in every record and in
   ``state_arrays()``, EC losing no file with Archival stored at most half
   replicate's bytes, the EC run equal to the CPU's from one init and to
   its own kill/resume; with p2c serving, EC stripes whose primary shard
   is down after the crash, and latencies above the same run's without
   the storage penalty.
12. Functional placement, the reference's ``region-loss`` preset (3
   regions x 2 racks x 2 nodes with priced WAN edges, ``placement_mode=
   "functional"``, ``ec_archival``, p2c serving) with region eu crashed for
   good from window 2: (a) 10,000,000 files generated on dn1..dn12 (seed
   10) over 20 s of traffic, 4 windows of 5 s, phase 8's settings (rf >= 2,
   250,000 files a window, drift threshold 0) and a checkpoint every
   window: first B1 (with and without labels), B2 and one bisection
   against their plain versions on a 10,000,000 x 5, k = 8 table, the
   re-clusters' shape; then the run: the state holds no array of n_files
   x n_nodes elements, no file is lost in any window, B1 = sum(n_iter + 1)
   and B2 = 12 per re-cluster by the counters, seconds a window by stage,
   exceptions and the sparse checkpoint's bytes against the dense map's,
   the peak host RSS, the crash window's idle share, and a kill after
   window 2 resumed to the same records and sparse ``state_arrays()``; (b)
   phase 4's workload on
   the same topology and settings: functional equal to its oracle
   (``materialized_hash``) in every record and in the sparse
   ``state_arrays()``, and the card equal to the CPU from one init; (c)
   ``EpochMap.diff`` over 12a's population: the same epoch moves nothing,
   dn5's removal pruned equals the full compare, and appending a standby
   node to each region moves exactly what the full compare finds
   (``addition_moved``), with the host seconds of each.  12a and 12c run in
   a child process (about one core of the host and 13 GiB of its memory,
   almost none of the card) started before phase 3, beside phases 3-11 and
   12b: run in turn they would take the whole smoke past its time limit.
   ``--phase 12`` starts the same child beside 12b alone, after (d): 12a's
   run at 5,000 files with the functional state's single-row memo on and
   off (``placement_fn.state._MEMO_MAX = 0``), the same records either way,
   and the host seconds of the repair and schedule stages.
13. The staged batch commands, the checkpointed Lloyd loop and the
   failure-space search, each through ``cdrs_tpu_torch.cli.main`` in
   process on the card: (a) over phase 5's manifest, written as CSV before
   phase 6, and its ``.cdrsb`` log: ``features``, ``cluster --k 8 --seed 10
   --medians_from_data --scoring_config validated --assignments_csv`` and
   ``evaluate --emit_plan --emit_setrep``, each stage's seconds; B1 =
   n_iter + 1 and B2 = 12 in ``cluster``, whose categories and per-file
   categories equal ``ReplicationPolicyModel.run``'s on the matrix
   ``load_feature_matrix`` returns, and ``evaluate``'s JSON equal to
   ``compare_policies`` in process; ``pipeline --evaluate`` at 20,000 files
   giving the same evaluation on the card and on the CPU from one init;
   (b) ``kmeans_checkpointed`` on (a)'s 2,500,000 x 5 matrix, k = 8, blocks
   of 5 iterations, killed after two blocks and resumed, equal bit for bit
   to one uninterrupted ``kmeans_full`` under both label modes, B1 = the
   iterations + one per block (+ 1 for the final labels), and the same on
   three distinct rows whose empty clusters reseed in every iteration,
   across both block edges; (c) ``scenarios search --seed 0
   --budget-cells 8`` over a copy of ``data/search_corpus`` (exit 0 with
   findings banked), then ``scenarios triage`` over the copy: each
   committed violation green (or one of ``SEARCH_QUEUE_C``), each of this
   run's findings still red, the exit code 1 exactly when a cell is red,
   the committed corpus untouched, B1 = sum(n_iter + 1) over the cells'
   re-clusters and no B2 (their medians sort).  In the whole smoke phase 13
   runs in a child process started after phase 5, beside phases 6-12:
   its CSV stages are host-bound.  ``--phase 13`` runs it alone, in
   process, after making phase 5's workload.

14. The mesh (``parallel/mesh.py``; shards share card 0 by the placement
   rule), run after phase 8 on phase 5's workload: (a) ``run_pipeline`` at
   ``{"data": 4}``, whose features equal phase 3's bit for bit, whose
   categories equal phase 3's, whose labels and per-file rf agree with
   phase 3's on >= ``MESH_AGREE`` of the files and whose centroids lie
   within ``MESH_TOL`` of phase 3's, with B1 = 4 x (n_iter + 1) and
   B2 = 4 x 12; the cold D²
   init at data = 1, 2 and 4 bit-identical; features and clustering
   seconds at data = 1, 2, 4, 4, 2, 1 (each run's table and labels held
   against phase 3's); mini-batch KMeans (4 updates) and drift at data = 4
   against one device (labels exact, centroids within ``MESH_TOL``, B3 one
   launch a shard); (b) ``{"data": 2, "model": 2}`` from phase 3's cold
   init: phase 3's categories, labels on >= ``MESH_AGREE``, centroids
   within ``MESH_TOL``, no Lloyd-kernel launch, B2 = 2 x 12; (c) the
   ``scale-mesh`` cell on the card and on the CPU from the CPU-computed
   cold init: green, ``mesh_engaged``, invariants, metrics and coverage
   equal, B1 = 8 x (sum(n_iter + 1) + drift calls), B2 = 8 x 12 a
   re-cluster; (d) beside (c), child processes on card 0: NCCL at world
   size 1 running a data = 2 mesh and gloo with 2 ranks of one shard each,
   each ``kmeans_full`` on phase 3's feature table bit-identical to the
   in-process data = 2 mesh.  No speedup is claimed: the shards share one
   card.  ``--phase 14`` runs phase 3's pipeline and makes phase 5's
   workload first.

It then prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  It imports nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}   # IEEE f32 CUDA cores; bf16 dense
MAIN_FILES = 2_500_000
MAIN_SEED = 10
MAIN_DURATION = 60.0
K = 8
STREAM_BATCH = 4_000_000     # events per fold batch
MB_BATCH = 262_144           # rows per mini-batch update
CONTROL_WINDOW = 10.0        # seconds per controller window
CONTROL_MAX_FILES = 250_000  # migrated files per window
CONTROL_KILL_AFTER = 3       # windows before the simulated kill
CHAOS_KILL = "dn2@2-3"       # crash at window 2, recover at 4
CHAOS_CORRUPT = "dn1@1:0.05"  # 5% of dn1's copies rot at window 1
CHAOS_SCRUB_BYTES = 50_000_000_000   # scrub verification reads a window
CHAOS_RACKS = "r0=dn1,dn2,dn3;r1=dn4,dn5,dn6;r2=dn7,dn8,dn9;r3=dn10,dn11,dn12"
#: The cells of 9a: the full suite's ported cells at suite seed 0.
SCENARIO_CELLS = ("control-shift", "chaos-kill", "rack-kill", "rack-partition", "cascade",
                  "rolling-decommission", "integrity-scrub", "daemon-stream",
                  "adversarial-drift", "gradual-drift", "random-s0-0", "serve-chaos",
                  "flash-crowd", "slo-burn", "integrity-read", "diurnal", "random-s0-1",
                  "random-s0-3", "storage-ec", "random-s0-2", "scale-placement",
                  "region-loss", "wan-partition", "black-friday")
#: 9b's cuts: 2.5M files, 10 windows of 3 s (a 30 s span), no alert gating.
SCENARIO_SCALE = {"n_files": MAIN_FILES, "duration": 30.0, "n_windows": 10, "alerts": None}
#: Cells red on the card's own cold init, with the reference red on that
#: init too (ROADMAP Queue C): the entry and the invariants that fail.
#: 9a judges them from the CPU-computed init.
SCENARIO_QUEUE_C = {"rack-kill": ("ROADMAP Queue C2 (repair_backlog holds 2 windows, its "
                                  "rule needs 3)", ["alerts_expected"])}
SCENARIO_PROFILED_WINDOW = 5
SERVE_COHORT_FRAC = 0.01     # 10a: flash-crowd cohort, a share of all files (hot ones)
SERVE_BURST = (30.0, 6.0)    # 10a: burst start and length in seconds of the span
SERVE_BOOST = 40.0
#: 10a: above any drift score (a max of an RMS shift of [0, 1] features and a
#: total-variation distance), so only the cold start and hotspots re-cluster.
SERVE_DRIFT_THRESHOLD = 100.0
SERVE_PROFILED_WINDOW = 3    # the window [30 s, 40 s) the burst lands in
SERVE_RACKS = "r0=dn1,dn2;r1=dn3,dn4;r2=dn5,dn6"
SERVE_STAGES = ("fold", "hotspot", "drift", "recluster", "plan", "schedule", "serve",
                "evaluate", "total")
#: Phase 11: HDFS's RS-6-3-1024k policy (EC(6,3) Archival, cold tier) on 12
#: DataNodes in 4 racks of 3, rack r1 crashed for good (11b: from window 3).
STORAGE_NODES = tuple(f"dn{i}" for i in range(1, 13))
STORAGE_CRASH = "crash:rack:r1@3"
STORAGE_KILL_AFTER = 4       # windows before the simulated kill (11b)
#: 11a: 4 windows of 10 s, rack r1 crashed from window 2, a kill after window 2.
STORAGE_SPAN_A = 40.0
STORAGE_CRASH_A = "crash:rack:r1@2"
STORAGE_KILL_AFTER_A = 2
#: 11b's span and windows: at phase 4's 60 s no cluster scores Archival, so
#: the span is 720 s (6 windows of 120 s; the cold start sees 120 s).
STORAGE_SPAN_B = 720.0
STORAGE_WINDOW_B = 120.0
#: Phase 12: the reference's region-loss preset (geo topology of 3 regions x
#: 2 racks x 2 nodes, functional placement, ec_archival, p2c serving) at
#: 10,000,000 files, region eu crashed for good from window 2.
PLACEMENT_FILES = 10_000_000
PLACEMENT_SPAN = 20.0
PLACEMENT_WINDOW = 5.0
PLACEMENT_CRASH = "crash:region:eu@2"
PLACEMENT_KILL_AFTER = 2     # windows before the simulated kill
PLACEMENT_PROFILED_WINDOW = 2   # the crash window
PLACEMENT_MEMO_FILES = 5_000    # 12d: 12a's run with the memo on and off
PLACEMENT_REMOVED = "dn5"       # 12c: the node an epoch removes
#: 12c: the standby nodes an epoch appends, one per region.
PLACEMENT_POOL = ({"name": "sb1", "domains": ("rs0", "eu")},
                  {"name": "sb2", "domains": ("rs1", "us")},
                  {"name": "sb3", "domains": ("rs2", "ap")})
PLACEMENT_STAGES = ("fold", "hotspot", "drift", "recluster", "faults", "repair", "plan",
                    "schedule", "serve", "evaluate", "total")
#: Phase 13: 13b's Lloyd blocks and the blocks written before the kill; 13a's
#: card-against-CPU pipeline size; 13c's search budget (seed 0).
BATCH_BLOCK_ITERS = 5
BATCH_KILL_BLOCKS = 2
BATCH_EVAL_FILES = 20_000
SEARCH_BUDGET_CELLS = 8
#: Banked violations of the committed corpus that reproduce on the card's
#: own init, with the ROADMAP Queue C entry that says why (none so far).
SEARCH_QUEUE_C: dict[str, str] = {}
#: Phase 14: the main path's mesh (14a), the shard counts of its stage
#: seconds, the model-axis mesh (14b), the share of labels that must agree
#: with one device (phase 4's rule: float32 sums added in another order
#: move centroids by ULPs, which can flip near-tied points and part the
#: runs), the largest centroid difference from one device (measured on an
#: H100: 2.62e-6 at data = 4, 2.74e-6 on the model axis, 6.0e-8 for the
#: mini-batch; a shard's statistics lost from a psum moves a centroid by
#: about 1e-3), and 14d's Lloyd budget and child time limit.
MESH_MAIN = {"data": 4}
MESH_DATA = (1, 2, 4)
MESH_MODEL = {"data": 2, "model": 2}
MESH_AGREE = 0.999
MESH_TOL = 1e-4
MESH_CHILD_ITERS = 100
MESH_CHILD_TIMEOUT = 300


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call, wrapper included: one pair of CUDA events
    around ``reps`` back-to-back calls, divided by ``reps``."""
    import torch

    for _ in range(warmup):
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


def device_ms(fn, kernel: str, reps: int = 10):
    """(device ms per launch, launches seen per call) of the kernels whose
    name holds ``kernel``, from torch.profiler over ``reps`` calls; (None,
    None) when the profiler sees no device time.  The profiler may miss
    some of a run of short kernels, so the launches seen are at most one
    per call, not exactly one."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and kernel in ev.name:
            total_us += ev.time_range.elapsed_us()
            count += 1
    if not count:
        return None, None
    return total_us / count / 1e3, count / reps


def l2_note(dev_ms, b_ms) -> str:
    """The device time against the HBM bound, as a share only when it is
    one: under the bound, the 50 MB L2 held part of x between calls."""
    if dev_ms is None:
        return "device not measured"
    if dev_ms < b_ms:
        return (f"device {dev_ms:.4f} ms, under the HBM bound: the 50 MB L2 held part "
                f"of the inputs between back-to-back calls")
    return f"device {dev_ms:.4f} ms ({b_ms / dev_ms:.1%} of the bound)"


def bound_ms(n_bytes: float, n_ops: float, dtype_name: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_environment():
    import torch

    from cdrs_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s for {', '.join(_build.SOURCES)}")
    for name, text in sorted(_build.ptxas_info.items()):
        for line in ptxas_summary(text):
            log(f"ptxas {name}: {line}")


def ptxas_summary(text: str) -> list[str]:
    """One line per kernel instantiation that spills or serves d = 5 (the
    main path's width), then the largest register count of the library."""
    import re

    rows, entry, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)I(\w*?)EEv", m.group(1))
            entry = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)[:60]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            rows.append((entry, regs, spill))
    clean = "0 bytes stack frame, 0 bytes spill stores"
    out = [f"{e}: {r} registers, {s}" for e, r, s in rows
           if "Li5E" in e or not s.startswith(clean)]
    if rows:
        busy = sum(not s.startswith(clean) for _, _, s in rows)
        out.append(f"{len(rows)} kernels, at most {max(r for _, r, _ in rows)} registers, "
                   f"{busy} with a stack frame or spills")
    return out


def _distances64(x, c, rows, labs):
    """Squared distances of x[rows] to c[labs] in float64."""
    return ((x[rows].double() - c[labs].double()) ** 2).sum(dim=1)


def check_lloyd(name, n, d, k, dtype, n_valid, reps, gen, with_labels=False):
    """The Lloyd kernel against its plain version; returns a result row.

    Labels are compared on every row, rows past ``n_valid`` included,
    which hold values far outside the data (they must add nothing).  The
    times are of calls with ``with_labels`` as the path makes them."""
    import torch

    from cdrs_tpu_torch.ops.lloyd import (centroid_operands, lloyd_assign_reduce,
                                          lloyd_assign_reduce_plain)

    x = torch.rand((n, d), generator=gen, device="cuda")
    x[n_valid:] += 50.0
    x = x.to(dtype)
    c = x[torch.randperm(n_valid, generator=gen, device="cuda")[:k]].float()
    lab_k, sums_k, cnt_k = lloyd_assign_reduce(x, c, n_valid, with_labels=True)
    lab_2, sums_2, cnt_2 = lloyd_assign_reduce(x, c, n_valid, with_labels=with_labels)
    lab_p, sums_p, cnt_p = lloyd_assign_reduce_plain(x, c, n_valid, with_labels=True)
    torch.cuda.synchronize()
    # The kernel adds in a fixed order: a second call gives the same bits.
    check(torch.equal(sums_k, sums_2) and torch.equal(cnt_k, cnt_2)
          and (lab_2 is None or torch.equal(lab_k, lab_2)),
          f"lloyd {name}: two calls on the same inputs differ")

    c_used, _ = centroid_operands(c, dtype)
    diff = torch.nonzero(lab_k != lab_p).flatten()
    agree = 1.0 - diff.numel() / n
    check(agree >= 0.9999, f"lloyd {name}: labels agree on {agree:.6f} < 0.9999")
    if diff.numel():
        # A disagreement must be a tie: both centroids equally near, within
        # 1e-5 of the scale of the terms |x|^2 + |c|^2 the f32 formula adds.
        dk = _distances64(x, c_used, diff, lab_k[diff].long())
        dp = _distances64(x, c_used, diff, lab_p[diff].long())
        scale = (x[diff].double() ** 2).sum(1) + (c_used.double() ** 2).sum(1).max()
        worst = float(((dk - dp).abs() / scale).max())
        check(worst <= 1e-5, f"lloyd {name}: label disagreement not a tie ({worst:.3e})")
    lv = lab_k[:n_valid].long()
    ref = torch.zeros((k, d), dtype=torch.float64, device="cuda")
    ref.index_add_(0, lv, x[:n_valid].double())
    rel = float(((sums_k.double() - ref).abs() / ref.abs().clamp(min=1.0)).max())
    check(rel <= 1e-4, f"lloyd {name}: sums off the f64 recomputation by {rel:.3e} rel")
    cnt_ref = torch.bincount(lv, minlength=k)
    check(torch.equal(cnt_k.long(), cnt_ref), f"lloyd {name}: counts not exact")
    max_abs = float((sums_k - sums_p).abs().max())
    if diff.numel() == 0:
        # Same labels: the same sums, taken in another order (f32, 1e-4 rel).
        check(torch.equal(cnt_k, cnt_p), f"lloyd {name}: counts differ from plain")
        rel_p = float(((sums_k - sums_p).abs() / sums_p.abs().clamp(min=1.0)).max())
        check(rel_p <= 1e-4, f"lloyd {name}: sums off the plain version by {rel_p:.3e} rel")

    call = lambda: lloyd_assign_reduce(x, c, n_valid, with_labels=with_labels)  # noqa: E731
    ms = time_ms(call, reps)
    dev_ms, per_call = device_ms(call, "lloyd_", max(3, min(reps, 10)))
    check(per_call is None or 0 < per_call <= 1.0,
          f"lloyd {name}: {per_call} kernel launches per call")
    plain_ms = time_ms(
        lambda: lloyd_assign_reduce_plain(x, c, n_valid, with_labels=with_labels),
        max(2, reps // 4))
    # Bytes: x read once, labels written once when asked, centroids and
    # |c|^2 read, sums and counts written.
    n_bytes = (n * d * x.element_size() + (n * 4 if with_labels else 0)
               + k * d * 8 + k * 8)
    n_ops = 2.0 * n * k * d + n_valid * d
    b_ms, b_by = bound_ms(n_bytes, n_ops, str(dtype).replace("torch.", ""))
    log(f"lloyd {name}: n={n} d={d} k={k} {dtype} n_valid={n_valid} "
        f"with_labels={with_labels} labels agree "
        f"{agree:.6f} ({diff.numel()} ties) sums rel {rel:.2e} |kernel-plain| {max_abs:.3e} "
        f"two calls bit-identical; kernel {ms:.4f} ms per call ({l2_note(dev_ms, b_ms)}, "
        f"{per_call} launches seen per call) plain {plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    del x, lab_k, lab_2, lab_p, ref
    torch.cuda.empty_cache()
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": max_abs}


def check_seg(name, n, d, k, reps, gen, with_global=True):
    """The threshold-count kernel against its plain version (exact), in
    its fused form (per-cluster and global tables from one call) unless
    ``with_global`` is false.  Labels are uniform in [-1, k)."""
    import torch

    from cdrs_tpu_torch.ops.seg_count import (label_threshold_count,
                                              label_threshold_count_plain)

    x = torch.rand((n, d), generator=gen, device="cuda")
    labels = torch.randint(-1, k, (n,), generator=gen, device="cuda", dtype=torch.int32)
    thr = torch.rand((2, k, d), generator=gen, device="cuda")
    gthr = torch.rand((2, d), generator=gen, device="cuda") if with_global else None
    got = label_threshold_count(x, labels, thr, gthr)
    want = label_threshold_count_plain(x, labels, thr, gthr)
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if with_global else [(got, want)]
    max_abs = max(float((g.long() - w.long()).abs().max()) for g, w in pairs)
    check(max_abs == 0, f"seg_count {name}: counts differ from plain by {max_abs}")
    call = lambda: label_threshold_count(x, labels, thr, gthr)  # noqa: E731
    ms = time_ms(call, reps)
    dev_ms, per_call = device_ms(call, "seg_", max(3, min(reps, 10)))
    check(per_call is None or 0 < per_call <= 1.0,
          f"seg_count {name}: {per_call} kernel launches per call")
    plain_ms = time_ms(lambda: label_threshold_count_plain(x, labels, thr, gthr),
                       max(2, reps // 4))
    # Bytes: x and the labels read once, both threshold tables read, both
    # count tables written; operations: the four compares per element.
    g_cells = 2 * d if with_global else 0
    n_bytes = n * d * 4 + n * 4 + (2 * k * d + g_cells) * 4 * 2
    b_ms, b_by = bound_ms(n_bytes, (4.0 if with_global else 2.0) * n * d, "float32")
    log(f"seg_count {name}: n={n} d={d} k={k} global={with_global} exact; kernel "
        f"{ms:.4f} ms per call ({l2_note(dev_ms, b_ms)}, {per_call} launches seen per "
        f"call) plain "
        f"{plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    del x, labels, got, want
    torch.cuda.empty_cache()
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": max_abs}


def check_bisect(n, d, k, gen, plain_on="cpu"):
    """One bisection as the main path makes it (one fused count of the
    per-cluster and global ranks per iteration) on the card against the
    same bisection where every count comes from the plain version: on the
    CPU, or on the card with ``plain_on="cuda"``.  The thresholds are
    halvings of exact min/max values and the counts are integers, so the
    medians must agree bit for bit."""
    import torch

    from cdrs_tpu_torch.ops import scoring
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count_plain

    x = torch.rand((n, d), generator=gen, device="cuda")
    labels = torch.randint(0, k, (n,), generator=gen, device="cuda", dtype=torch.int32)
    before = label_launches()
    med, gm = scoring.bisect_medians(x, labels, k, 2048, True)
    launched = label_launches() - before
    if plain_on == "cpu":
        med_p, gm_p = scoring.bisect_medians(x.cpu(), labels.cpu(), k, 2048, True)
    else:
        kernel = scoring.label_threshold_count
        scoring.label_threshold_count = label_threshold_count_plain
        try:
            med_p, gm_p = (t.cpu() for t in scoring.bisect_medians(x, labels, k, 2048, True))
        finally:
            scoring.label_threshold_count = kernel
    check(launched == 12, f"bisect: {launched} kernel launches, expected 12")
    check(torch.equal(med.cpu(), med_p) and torch.equal(gm.cpu(), gm_p),
          "bisect: card medians differ from the plain version's")
    log(f"bisect n={n} d={d} k={k}: {launched} launches (per-cluster and global fused), "
        f"medians identical to the plain version's on the {plain_on}")
    del x, labels
    torch.cuda.empty_cache()


def label_launches() -> int:
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count

    return label_threshold_count.launches


def phase_kernels(reps):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n_main = MAIN_FILES - 3
    rows = {
        "lloyd": check_lloyd("pipeline", n_main, 5, K, torch.float32, n_main, reps, gen),
        "seg_count": check_seg("pipeline", n_main, 5, K, reps, gen),
        # The stream path's shape: one mini-batch update, labels written,
        # the valid rows short of the buffer.
        "lloyd_rowmajor": check_lloyd("minibatch", MB_BATCH, 5, K, torch.float32,
                                      MB_BATCH - 1000, reps, gen, with_labels=True),
    }
    # The drift and predict shape: every file, labels written.
    lloyd_drift = check_lloyd("drift", n_main, 5, K, torch.float32, n_main - 3, reps, gen,
                              with_labels=True)
    rows["lloyd_rowmajor"]["max_abs_err"] = max(rows["lloyd_rowmajor"]["max_abs_err"],
                                                lloyd_drift["max_abs_err"])
    # The main path's bisection makes one fused call per iteration (the
    # row above); the k = 1 form without a global table still works.  The
    # row's error covers both.
    seg_k1 = check_seg("pipeline-k1", n_main, 5, 1, reps, gen, with_global=False)
    rows["seg_count"]["max_abs_err"] = max(rows["seg_count"]["max_abs_err"],
                                           seg_k1["max_abs_err"])
    check_bisect(n_main, 5, K, gen)
    wide = {
        "seg_count 2.5Mx5 k1": seg_k1,
        "lloyd 2.5Mx5 k8 labels": lloyd_drift,
        "lloyd 1Mx32 k128 f32": check_lloyd("config2-f32", 1 << 20, 32, 128, torch.float32,
                                            (1 << 20) - 5, reps, gen),
        "lloyd 1Mx32 k128 bf16": check_lloyd("config2-bf16", 1 << 20, 32, 128,
                                             torch.bfloat16, (1 << 20) - 5, reps, gen),
        "lloyd 1Mx128 k1024 f32": check_lloyd("ktiled", 1 << 20, 128, 1024, torch.float32,
                                              1 << 20, max(3, reps // 4), gen),
        "seg_count 1Mx128 k1024": check_seg("wide", 1 << 20, 128, 1024,
                                            max(3, reps // 4), gen),
    }
    log("kernel_shapes " + json.dumps(wide))
    return rows


def main_config():
    """Phase 3's pipeline configuration."""
    from cdrs_tpu_torch import (GeneratorConfig, KMeansConfig, PipelineConfig,
                                SimulatorConfig, validated_scoring_config)

    return PipelineConfig(
        device="cuda",
        generator=GeneratorConfig(n_files=MAIN_FILES, seed=MAIN_SEED),
        simulator=SimulatorConfig(duration_seconds=MAIN_DURATION, seed=MAIN_SEED + 1),
        kmeans=KMeansConfig(k=K, seed=MAIN_SEED),
        scoring=validated_scoring_config(),
    )


def phase_main_path():
    import torch

    from cdrs_tpu_torch import run_pipeline
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count

    cfg = main_config()
    torch.cuda.reset_peak_memory_stats()
    lloyd_assign_reduce.launches = 0
    label_threshold_count.launches = 0
    t0 = time.perf_counter()
    result = run_pipeline(cfg)
    wall = time.perf_counter() - t0
    launches = {"lloyd": lloyd_assign_reduce.launches,
                "seg_count": label_threshold_count.launches}
    peak = torch.cuda.max_memory_allocated()
    dec = result.decision
    log(f"main path: {result.n_files} files, {result.n_events} events, wall {wall:.3f} s, "
        f"peak device memory {peak / 2**20:.1f} MiB, launches {launches}")
    log("main path stages " + json.dumps(result.summary()))
    n_iter = int(result.summary()["kmeans.n_iter"])
    check(launches["lloyd"] == n_iter + 1,
          f"main path made {launches['lloyd']} Lloyd launches, expected {n_iter} "
          f"iterations + 1 label pass")
    check(launches["seg_count"] == 12,
          f"main path made {launches['seg_count']} threshold-count launches, expected 12")
    check(dec.labels.shape == (MAIN_FILES,), f"labels shape {dec.labels.shape}")
    check(dec.centroids.shape == (K, 5), f"centroids shape {dec.centroids.shape}")
    import numpy as np

    check(bool(np.isfinite(dec.centroids).all()), "non-finite centroids")
    check(bool(np.isfinite(dec.scores).all()), "non-finite scores")
    check(int(dec.labels.min()) >= 0 and int(dec.labels.max()) < K, "labels out of range")
    acc = result.planted_accuracy
    check(acc is not None and acc > 0.5, f"planted_accuracy {acc} <= 0.5")
    profile_cluster(cfg, result.table.norm)
    return launches, cfg, result


def profile_cluster(cfg, norm):
    """One more clustering + scoring pass over the main path's feature
    table under torch.profiler — device busy time, the device's idle share
    of the stage's wall time, time by kernel and the NaN fills of
    deterministic mode.  Checks one kernel launch per wrapper call."""
    import torch
    from torch.autograd import DeviceType

    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.models.replication import ReplicationPolicyModel

    model = ReplicationPolicyModel(cfg.kmeans, cfg.scoring)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with deterministic(), torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.run(norm)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    try:
        by_name: dict[str, list] = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                row = by_name.setdefault(ev.name, [0, 0.0])
                row[0] += 1
                row[1] += ev.time_range.elapsed_us()
    except Exception as exc:  # reading the events is informational; the run above is not
        log(f"profile cluster: not measured ({type(exc).__name__}: {exc})")
        return
    busy_us = sum(us for _, us in by_name.values())
    if not busy_us:
        log("profile cluster: not measured (the profiler saw no device time)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    fills = sum(cnt for name, (cnt, _) in by_name.items() if "FillFunctor" in name)
    lloyd = sum(cnt for name, (cnt, _) in by_name.items() if "lloyd_" in name)
    seg = sum(cnt for name, (cnt, _) in by_name.items() if "seg_" in name)
    log(f"profile cluster: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
        f"idle share {1 - busy_us / wall_us:.4f}, iterations {model.n_iter}, Lloyd kernel "
        f"launches {lloyd}, threshold-count launches {seg}, NaN-fill launches {fills}")
    for name, (count, us) in top:
        log(f"profile cluster kernel: {us / 1e3:.3f} ms in {count} launches: {name[:90]}")
    check(not any("lloyd_reduce_kernel" in name for name in by_name),
          "profile: a separate Lloyd reduction kernel ran")
    # The wrappers' counters hold the exact counts (phase 3); the profiler
    # may miss a few short kernels, but never sees more than one per call.
    check(lloyd <= model.n_iter + 1 and seg <= 12,
          f"profile: {lloyd} Lloyd and {seg} threshold-count launches, more than "
          f"{model.n_iter + 1} and 12 (one launch per call)")


def phase_card_vs_cpu():
    import numpy as np

    from cdrs_tpu_torch import (GeneratorConfig, KMeansConfig, PipelineConfig,
                                SimulatorConfig, run_pipeline, validated_scoring_config)
    from cdrs_tpu_torch.features.batch import compute_features_torch
    from cdrs_tpu_torch.ops.kmeans import kmeans_full
    from cdrs_tpu_torch.sim.access import simulate_access
    from cdrs_tpu_torch.sim.generator import generate_population

    n = 20_000
    gcfg = GeneratorConfig(n_files=n, seed=MAIN_SEED)
    scfg = SimulatorConfig(duration_seconds=MAIN_DURATION, seed=MAIN_SEED + 1)
    manifest = generate_population(gcfg)
    table = compute_features_torch(manifest, simulate_access(manifest, scfg), device="cpu")
    init, _, _, _ = kmeans_full(table.norm, K, seed=MAIN_SEED, max_iter=0, tol=0.0)
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg = PipelineConfig(device=dev, generator=gcfg, simulator=scfg,
                             kmeans=KMeansConfig(k=K, seed=MAIN_SEED),
                             scoring=validated_scoring_config())
        runs[dev] = run_pipeline(cfg, init_centroids=init).decision
    agree = float((runs["cuda"].labels == runs["cpu"].labels).mean())
    cmax = float(np.abs(runs["cuda"].centroids - runs["cpu"].centroids).max())
    log(f"card vs cpu at {n} files: labels agree {agree:.6f}, categories "
        f"{runs['cuda'].categories} vs {runs['cpu'].categories}, centroid |diff| {cmax:.3e}")
    check(agree >= 0.999, f"card and CPU labels agree on {agree:.6f} < 0.999")
    check(runs["cuda"].categories == runs["cpu"].categories,
          "card and CPU per-cluster categories differ")
    return table.norm, init


def phase_stream_path(cfg, main_result, work):
    """Phase 5: the stream path on the card over phase 3's workload.  Its
    ``.cdrsb`` log stays in ``work`` for phase 7.  Returns the Lloyd
    kernel's launches on the path, the path's times, the workload and the
    log's path."""
    import numpy as np
    import torch

    from cdrs_tpu_torch import KMeansConfig, validated_scoring_config
    from cdrs_tpu_torch.config import CATEGORIES
    from cdrs_tpu_torch.control.drift import assign_labels, detect_drift, detect_drift_torch
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.features.streaming import fold_stream, stream_finalize
    from cdrs_tpu_torch.io.events import EventLog
    from cdrs_tpu_torch.models.replication import ReplicationPolicyModel
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count
    from cdrs_tpu_torch.pipeline import recovery_accuracy
    from cdrs_tpu_torch.sim.access import simulate_access
    from cdrs_tpu_torch.sim.generator import generate_population

    manifest = generate_population(cfg.generator)
    events = simulate_access(manifest, cfg.simulator)
    n, n_events = len(manifest), len(events)
    check(n_events == main_result.n_events, "phase 3's workload did not regenerate alike")
    check(bool((events.path_id >= 0).all()),
          "the simulator emitted unknown paths; pass observation_end to stream_finalize")
    dec3 = main_result.decision
    times = {}
    log_path = os.path.join(work, "access.cdrsb")
    with deterministic():
        t0 = time.perf_counter()
        events.write_binary(log_path, manifest)
        times["write_seconds"] = time.perf_counter() - t0
        log_bytes = os.path.getsize(log_path)

        lloyd_assign_reduce.launches = 0
        label_threshold_count.launches = 0
        stats: dict = {}
        t0 = time.perf_counter()
        state = fold_stream(log_path, manifest, device="cuda", batch_size=STREAM_BATCH,
                            stats=stats)
        table = stream_finalize(state, manifest)
        torch.cuda.synchronize()
        times["fold_wall_seconds"] = time.perf_counter() - t0
        times.update({key: stats[key] for key in ("parse_seconds", "prep_seconds",
                                                  "fold_seconds", "batches")})
        times["events_per_second"] = state.n_events / times["fold_wall_seconds"]
        log(f"stream fold: {state.n_events} events from {log_bytes} B of .cdrsb in "
            f"{stats['batches']} batches; wall {times['fold_wall_seconds']:.3f} s "
            f"({times['events_per_second']:.0f} events/s), parse "
            f"{stats['parse_seconds']:.3f} s, prep {stats['prep_seconds']:.3f} s, "
            f"fold {stats['fold_seconds']:.3f} s (the producer thread overlaps the fold); "
            f"log write {times['write_seconds']:.3f} s")
        check(state.n_events == n_events, f"folded {state.n_events} of {n_events} events")
        check(torch.equal(table.raw, main_result.table.raw)
              and torch.equal(table.norm, main_result.table.norm),
              "the streamed table differs from the batch table")
        log(f"stream features: {n} x 5 raw and norm bit-identical to phase 3's batch table")

        model = ReplicationPolicyModel(
            KMeansConfig(k=K, seed=MAIN_SEED, batch_size=MB_BATCH), validated_scoring_config())
        t0 = time.perf_counter()
        dec = model.run(table.norm)
        torch.cuda.synchronize()
        times["minibatch_seconds"] = time.perf_counter() - t0
        chunks = -(-n // MB_BATCH)
        epochs = model.kmeans_cfg.batch_epochs
        mb_launches = lloyd_assign_reduce.launches
        check(mb_launches == chunks * epochs + chunks,
              f"mini-batch made {mb_launches} Lloyd launches, expected {chunks} updates x "
              f"{epochs} epochs + {chunks} predict chunks")
        check(bool(np.isfinite(dec.centroids).all()), "mini-batch: non-finite centroids")
        check(bool(np.isfinite(dec.scores).all()), "mini-batch: non-finite scores")
        check(int(dec.labels.min()) >= 0 and int(dec.labels.max()) < K,
              "mini-batch: labels out of range")
        log(f"stream mini-batch: k={K} batch {MB_BATCH}, {model.n_iter} updates, "
            f"{mb_launches} Lloyd launches, {label_threshold_count.launches} threshold-count "
            f"launches, {times['minibatch_seconds']:.3f} s, categories {dec.categories}, "
            f"planted accuracy {recovery_accuracy(dec, manifest.category):.4f}")

    half = n_events // 2
    parts = [EventLog(ts=events.ts[lo:min(lo + STREAM_BATCH, half)],
                      path_id=events.path_id[lo:min(lo + STREAM_BATCH, half)],
                      op=events.op[lo:min(lo + STREAM_BATCH, half)],
                      client_id=events.client_id[lo:min(lo + STREAM_BATCH, half)],
                      clients=events.clients)
             for lo in range(0, half, STREAM_BATCH)]
    with deterministic():
        half_norm = stream_finalize(fold_stream(parts, manifest, device="cuda"),
                                    manifest).norm
        frac3 = np.bincount(dec3.category_idx[dec3.labels], minlength=len(CATEGORIES)) / n
        args = (dec3.centroids, dec3.category_idx, frac3, len(CATEGORIES))
        before = lloyd_assign_reduce.launches
        rep = detect_drift_torch(half_norm, *args)
        drift_launches = lloyd_assign_reduce.launches - before
        launches = lloyd_assign_reduce.launches
        check(drift_launches == 1, f"drift made {drift_launches} Lloyd launches, expected 1")
        x64 = half_norm.cpu().double().numpy()
        oracle = detect_drift(x64, *args)
        d_shift = abs(rep.centroid_shift - oracle.centroid_shift)
        d_frac = float(np.abs(rep.fractions - oracle.fractions).max())
        c32 = torch.as_tensor(dec3.centroids, dtype=torch.float32, device="cuda")
        lab = lloyd_assign_reduce(half_norm, c32, with_labels=True)[0].cpu().numpy()
        flips = int((lab != assign_labels(x64, dec3.centroids.astype(np.float64))).sum())
        times["drift_ms"] = time_ms(lambda: detect_drift_torch(half_norm, *args), 10)
    log(f"stream drift: first {half} events, 1 launch, shift {rep.centroid_shift:.6f} "
        f"(oracle {oracle.centroid_shift:.6f}, diff {d_shift:.2e}), population delta "
        f"{rep.population_delta:.6f} (oracle {oracle.population_delta:.6f}), fractions "
        f"diff {d_frac:.2e}, label flips against the oracle {flips}, "
        f"{times['drift_ms']:.4f} ms per call")
    check(d_shift <= 1e-4, f"drift centroid shift off the oracle by {d_shift:.3e}")
    check(d_frac <= 1e-6, f"drift fractions off the oracle by {d_frac:.3e}")
    return launches, times, manifest, events, log_path


def phase_minibatch_card_vs_cpu(norm_cpu, init):
    """Mini-batch on the card against the CPU at 20,000 files, one init."""
    from cdrs_tpu_torch import KMeansConfig, validated_scoring_config
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.models.replication import ReplicationPolicyModel

    runs = {}
    with deterministic():
        for dev in ("cuda", "cpu"):
            model = ReplicationPolicyModel(
                KMeansConfig(k=K, seed=MAIN_SEED, batch_size=2048), validated_scoring_config())
            runs[dev] = model.run(norm_cpu.to(dev), init_centroids=init)
    agree = float((runs["cuda"].labels == runs["cpu"].labels).mean())
    log(f"mini-batch card vs cpu at {norm_cpu.shape[0]} files: labels agree {agree:.6f}, "
        f"categories {runs['cuda'].categories} vs {runs['cpu'].categories}")
    check(agree >= 0.999, f"mini-batch card and CPU labels agree on {agree:.6f} < 0.999")
    check(runs["cuda"].categories == runs["cpu"].categories,
          "mini-batch card and CPU per-cluster categories differ")


def watch_reclusters(ctl, init_fn=None):
    """Wrap the controller's two models so each re-cluster appends (warm,
    n_iter, per-cluster categories) to the returned list; ``init_fn(X)``
    gives the init of a full re-cluster."""
    seen = []
    for warm, model in ((False, ctl._model_full), (True, ctl._model_warm)):
        def run(X, init_centroids=None, _run=model.run, _model=model, _warm=warm, **kw):
            if init_centroids is None and init_fn is not None:
                init_centroids = init_fn(X)
            dec = _run(X, init_centroids=init_centroids, **kw)
            seen.append({"warm": _warm, "n_iter": _model.n_iter, "categories": dec.categories})
            return dec
        model.run = run
    return seen


def time_methods(obj, names):
    """Wrap the named methods of ``obj`` so each call adds its host seconds
    to the returned dict."""
    spent = dict.fromkeys(names, 0.0)
    for name in names:
        def timed(*args, _fn=getattr(obj, name), _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                spent[_name] += time.perf_counter() - t0
        setattr(obj, name, timed)
    return spent


def control_config(device: str):
    from cdrs_tpu_torch import KMeansConfig, validated_scoring_config
    from cdrs_tpu_torch.control.controller import ControllerConfig

    return ControllerConfig(
        window_seconds=CONTROL_WINDOW, drift_threshold=0.0,
        max_files_per_window=CONTROL_MAX_FILES, kmeans=KMeansConfig(k=K, seed=MAIN_SEED),
        scoring=validated_scoring_config(), device=device)


def profile_window(ctl, events):
    """One window of a resumed controller under torch.profiler: its host
    wall time (the record's ``seconds.total``), the device busy time and
    the idle share, and the launches of each kernel."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = ctl.run(events, max_windows=1)
        torch.cuda.synchronize()
    rec = res.records[0]
    busy_us, lloyd, seg = 0.0, 0, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            busy_us += ev.time_range.elapsed_us()
            lloyd += "lloyd_" in ev.name
            seg += "seg_" in ev.name
    wall = rec["seconds"]["total"]
    out = {"window": rec["window"], "mode": rec["recluster_mode"], "wall_s": wall,
           "device_busy_s": busy_us / 1e6,
           "idle_share": 1 - busy_us / 1e6 / wall if busy_us else None,
           "lloyd_launches_seen": lloyd, "seg_launches_seen": seg, "seconds": rec["seconds"]}
    return res, out


def phase_controller(manifest, events, main_result):
    """Phase 6: the controller on the card over phase 5's workload, then at
    20,000 files on the card against the CPU.  Returns the kernels'
    launches on the control path and the full run's records."""
    import numpy as np
    import torch

    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.features.streaming import stream_finalize
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count

    with tempfile.TemporaryDirectory() as tmp, deterministic():
        ctl = ReplicationController(manifest, control_config("cuda"))
        seen = watch_reclusters(ctl)
        split = time_methods(ctl, ("_feature_snapshot", "_ensure_accepted", "_accept_plan",
                                   "_placement_for"))
        lloyd_assign_reduce.launches = 0
        label_threshold_count.launches = 0
        t0 = time.perf_counter()
        full = ctl.run(events, checkpoint_path=os.path.join(tmp, "full.npz"))
        wall = time.perf_counter() - t0
        launches = {"lloyd": lloyd_assign_reduce.launches,
                    "seg_count": label_threshold_count.launches}
        recs = full.records
        modes = [(r["recluster_trigger"], r["recluster_mode"]) for r in recs]
        log(f"control: {len(manifest)} files, {sum(r['n_events'] for r in recs)} events in "
            f"{len(recs)} windows of {CONTROL_WINDOW:g} s; wall {wall:.3f} s "
            f"({len(recs) / wall:.4f} windows/s, checkpoints included), re-clusters {modes}, "
            f"Lloyd iterations {[c['n_iter'] for c in seen]}, launches {launches}")
        for r in recs:
            log("control window " + json.dumps(
                {k: r[k] for k in ("window", "n_events", "drift", "recluster_mode",
                                   "plan_moves_pending", "moves_applied", "backlog_files",
                                   "locality_before", "locality_after", "plan_hash",
                                   "seconds")}))
        stages = ("fold", "drift", "recluster", "plan", "schedule", "evaluate", "total")
        per_stage = {st: sum(r["seconds"].get(st, 0.0) for r in recs) / len(recs)
                     for st in stages}
        log("control stages mean seconds per window " + json.dumps(per_stage))
        # Inside the stages: the snapshot (drift and re-cluster), the model
        # acceptance and plan diff (plan), and the placement of each new rf
        # vector (evaluate; the rest of evaluate replays the window's events).
        log("control host split, seconds per window " + json.dumps(
            {name: t / len(recs) for name, t in split.items()}))
        log("control summary " + json.dumps(full.summary()))
        check(modes[0] == ("cold", "full"), f"window 0 re-clustered as {modes[0]}")
        check(len(recs) >= 2 and all(m == ("drift", "warm") for m in modes[1:]),
              f"later windows re-clustered as {modes[1:]}, expected drift/warm")
        check(len(seen) == len(recs), f"{len(seen)} re-clusters for {len(recs)} windows")
        want_lloyd = sum(c["n_iter"] + 1 for c in seen)
        check(launches["lloyd"] == want_lloyd,
              f"control made {launches['lloyd']} Lloyd launches, expected {want_lloyd}")
        check(launches["seg_count"] == 12 * len(seen),
              f"control made {launches['seg_count']} threshold-count launches, expected "
              f"{12 * len(seen)}")
        check(all(r["moves_applied"] <= CONTROL_MAX_FILES for r in recs),
              "a window admitted more moves than the file cap")
        check(recs[0]["backlog_files"] > 0, "the backlog does not span windows")
        table = stream_finalize(ctl._state, manifest)
        check(torch.equal(table.raw, main_result.table.raw)
              and torch.equal(table.norm, main_result.table.norm),
              "the controller's final snapshot differs from phase 3's batch table")
        log(f"control snapshot: {len(manifest)} x 5 raw and norm bit-identical to phase 3's "
            f"batch table")

        ck = os.path.join(tmp, "killed.npz")
        killed = ReplicationController(manifest, control_config("cuda")).run(
            events, checkpoint_path=ck, max_windows=CONTROL_KILL_AFTER)
        resumed = ReplicationController(manifest, control_config("cuda"))
        resumed.load_checkpoint(ck)
        one, prof = profile_window(resumed, events)
        resumed.save_checkpoint(ck)
        rest = ReplicationController(manifest, control_config("cuda")).run(
            events, checkpoint_path=ck)
        got = [r["plan_hash"] for r in killed.records + one.records + rest.records]
        want = [r["plan_hash"] for r in recs]
        check(got == want, f"kill/resume plan hashes {got} differ from the full run's {want}")
        check(np.array_equal(rest.rf, full.rf)
              and np.array_equal(rest.category_idx, full.category_idx),
              "kill/resume final plan differs from the full run's")
        log(f"control kill/resume: killed after {CONTROL_KILL_AFTER} windows, resumed; "
            f"plan hashes identical in all {len(want)} windows, final rf/categories identical")
        log("control profile " + json.dumps(prof))

    card_cpu_control()
    return launches, recs


def _phase4_workload(nodes=None):
    """Phase 4's workload (20,000 files, seed 10, 60 s), on ``nodes``."""
    from cdrs_tpu_torch import GeneratorConfig, SimulatorConfig
    from cdrs_tpu_torch.sim.access import simulate_access
    from cdrs_tpu_torch.sim.generator import generate_population

    kw = {} if nodes is None else {"nodes": nodes}
    manifest = generate_population(GeneratorConfig(n_files=20_000, seed=MAIN_SEED, **kw))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=MAIN_DURATION,
                                                       seed=MAIN_SEED + 1))
    return manifest, events


def cpu_init(X):
    from cdrs_tpu_torch.ops.kmeans import kmeans_full

    return kmeans_full(X.cpu(), K, seed=MAIN_SEED, max_iter=0, tol=0.0)[0]


def card_cpu_control():
    """The controller at 20,000 files (phase 4's workload) on the card and on
    the CPU, full re-clusters from one init computed on the CPU."""
    import numpy as np

    from cdrs_tpu_torch.control.controller import ReplicationController

    manifest, events = _phase4_workload()
    runs = {}
    for dev in ("cuda", "cpu"):
        ctl = ReplicationController(manifest, control_config(dev))
        seen = watch_reclusters(ctl, cpu_init)
        runs[dev] = (ctl.run(events), seen)
    (res_c, seen_c), (res_p, seen_p) = runs["cuda"], runs["cpu"]
    modes = [[r["recluster_mode"] for r in res.records] for res in (res_c, res_p)]
    cats = [[s["categories"] for s in seen] for seen in (seen_c, seen_p)]
    agree = float((res_c.category_idx == res_p.category_idx).mean())
    log(f"control card vs cpu at {len(manifest)} files: re-clusters {modes[0]} vs {modes[1]}, "
        f"per-file categories agree {agree:.6f}; plan hashes card "
        f"{[r['plan_hash'] for r in res_c.records]} cpu "
        f"{[r['plan_hash'] for r in res_p.records]}")
    check(modes[0] == modes[1], "card and CPU controllers re-clustered differently")
    check(cats[0] == cats[1], f"per-cluster categories differ: {cats[0]} vs {cats[1]}")
    check(agree >= 0.999, f"card and CPU final categories agree on {agree:.6f} < 0.999")
    check(bool(np.all(res_c.category_idx >= 0)), "files left unplanned on the card")

def strip_seconds(records):
    return [{k: v for k, v in r.items() if k != "seconds"} for r in records]


def timed_tailer(spent):
    """Route the daemon's tailer through a wrapper that adds the seconds
    spent reading and parsing blocks to ``spent``; returns the original."""
    from cdrs_tpu_torch.daemon import core

    orig = core.tail_binary_log

    def tail(*args, **kw):
        blocks = orig(*args, **kw)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(blocks)
            except StopIteration:
                return
            finally:
                spent["parse_seconds"] += time.perf_counter() - t0
            spent["blocks"] += 1
            yield item

    core.tail_binary_log = tail
    return orig


def count_minibatch(daemon, spent):
    """Wrap the daemon's mini-batch step: its Lloyd launches (B3) and host
    seconds go to ``spent``."""
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce

    step = daemon._minibatch_step

    def counted():
        before = lloyd_assign_reduce.launches
        t0 = time.perf_counter()
        step()
        spent["seconds"] += time.perf_counter() - t0
        spent["launches"] += lloyd_assign_reduce.launches - before

    daemon._minibatch_step = counted


def profile_decision(daemon, log_path, ck):
    """One decision of a resumed daemon under torch.profiler: its host wall
    time (the daemon's decision seconds), the device busy time of the
    profiled run (the checkpoint restore's copies included) and the idle
    share, and the launches of each kernel."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        daemon.run(log_path, checkpoint_path=ck)
        torch.cuda.synchronize()
    busy_us, lloyd, seg = 0.0, 0, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            busy_us += ev.time_range.elapsed_us()
            lloyd += "lloyd_" in ev.name
            seg += "seg_" in ev.name
    rec = daemon.records[0]
    wall = daemon.decision_seconds[0]
    return {"window": rec["window"], "mode": rec["recluster_mode"], "decision_s": wall,
            "device_busy_s": busy_us / 1e6,
            "idle_share": 1 - busy_us / 1e6 / wall if busy_us else None,
            "lloyd_launches_seen": lloyd, "seg_launches_seen": seg,
            "seconds": rec["seconds"]}


def phase_daemon(manifest, events, log_path, control_records, work):
    """Phase 7: the streaming daemon on the card over phase 5's ``.cdrsb``
    log (7a-7c), then follow mode and the brownout ladder at 20,000 files
    (7d).  Returns the kernels' launches in 7a."""
    import numpy as np
    import torch

    from cdrs_tpu_torch.cluster.placement import ClusterTopology, primary_on_topology
    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.daemon import DaemonConfig, StreamDaemon, core
    from cdrs_tpu_torch.obs.sink import read_events
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count
    from cdrs_tpu_torch.placement_fn import EpochMap

    n_windows = len(control_records)
    # 7a: the full run, mini-batch tracking on, a checkpoint every window.
    ctl = ReplicationController(manifest, control_config("cuda"))
    seen = watch_reclusters(ctl)
    daemon = StreamDaemon(ctl, DaemonConfig(recluster="minibatch", checkpoint_every=1))
    mb = {"seconds": 0.0, "launches": 0}
    count_minibatch(daemon, mb)
    tail = {"parse_seconds": 0.0, "blocks": 0}
    orig_tailer = timed_tailer(tail)
    metrics = os.path.join(work, "daemon.jsonl")
    lloyd_assign_reduce.launches = 0
    label_threshold_count.launches = 0
    t0 = time.perf_counter()
    try:
        dig = daemon.run(log_path, metrics_path=metrics,
                         checkpoint_path=os.path.join(work, "daemon.npz"))
    finally:
        core.tail_binary_log = orig_tailer
    wall = time.perf_counter() - t0
    launches = {"lloyd": lloyd_assign_reduce.launches - mb["launches"],
                "seg_count": label_threshold_count.launches, "lloyd_rowmajor": mb["launches"]}
    recs = daemon.records
    traces = [e for e in read_events(metrics) if e["kind"] == "decision_trace"]
    for r, t, dec in zip(recs, traces, daemon.decision_seconds):
        log("daemon window " + json.dumps(
            {"window": r["window"], "n_events": r["n_events"], "drift": r["drift"],
             "recluster_mode": r["recluster_mode"], "decision_s": dec,
             "segments_s": {k: v / 1e9 for k, v in t["segments_ns"].items()},
             "controller_total_s": r["seconds"]["total"], "plan_hash": r["plan_hash"]}))
    ckpts = ctl.checkpoint_log
    log(f"daemon: {len(manifest)} files, {dig['events_ingested']} events from "
        f"{os.path.getsize(log_path)} B of .cdrsb in {len(recs)} windows; wall {wall:.3f} s; "
        f"decision p50 {dig['decision_p50_seconds']} s p99 {dig['decision_p99_seconds']} s; "
        f"tailer {tail['blocks']} blocks, parse {tail['parse_seconds']:.3f} s; mini-batch "
        f"{mb['seconds']:.3f} s in {mb['launches']} launches; checkpoints {len(ckpts)}, "
        f"{sum(c['seconds'] for c in ckpts) / max(len(ckpts), 1):.3f} s and "
        f"{ckpts[-1]['bytes'] if ckpts else 0} B each; launches {launches}")
    stages = ("fold", "drift", "recluster", "plan", "schedule", "evaluate", "total")
    log("daemon stages mean seconds per window " + json.dumps(
        {st: sum(r["seconds"].get(st, 0.0) for r in recs) / len(recs) for st in stages}))
    log("daemon digest " + json.dumps(dig))
    check(strip_seconds(recs) == strip_seconds(control_records),
          "daemon records differ from phase 6's controller records")
    check(dig["epochs_published"] == len(recs) == n_windows,
          f"{dig['epochs_published']} epochs for {len(recs)} windows (phase 6: {n_windows})")
    ep = daemon.publisher.pin()
    check(ep.plan_hash == recs[-1]["plan_hash"]
          and np.array_equal(ep.rf, ctl.current_rf)
          and np.array_equal(ep.category_idx, ctl.current_cat),
          "the pinned epoch is not the controller's final plan")
    want_lloyd = sum(c["n_iter"] + 1 for c in seen)
    check(launches["lloyd"] == want_lloyd,
          f"daemon made {launches['lloyd']} Lloyd launches in re-clusters, expected {want_lloyd}")
    check(launches["seg_count"] == 12 * len(seen),
          f"daemon made {launches['seg_count']} threshold-count launches, expected "
          f"{12 * len(seen)}")
    check(launches["lloyd_rowmajor"] == dig["windows_processed"] == dig["minibatch"]["n_batches"],
          f"daemon made {launches['lloyd_rowmajor']} mini-batch launches for "
          f"{dig['windows_processed']} windows")
    check(len(traces) == len(recs)
          and all(sum(t["segments_ns"].values()) == t["total_ns"] for t in traces),
          "decision_trace segments do not sum to their totals")
    check(bool(np.isfinite(dig["minibatch"]["inertia"])), "non-finite mini-batch inertia")

    # 7b: stop after 3 windows, one profiled decision, then the rest.
    ck = os.path.join(work, "stop.npz")
    first = StreamDaemon(ReplicationController(manifest, control_config("cuda")),
                         DaemonConfig(recluster="minibatch", max_windows=CONTROL_KILL_AFTER))
    first.run(log_path, checkpoint_path=ck)
    one = StreamDaemon(ReplicationController(manifest, control_config("cuda")),
                       DaemonConfig(recluster="minibatch", max_windows=1))
    prof = profile_decision(one, log_path, ck)
    rest = StreamDaemon(ReplicationController(manifest, control_config("cuda")),
                        DaemonConfig(recluster="minibatch"))
    dig_rest = rest.run(log_path, checkpoint_path=ck)
    joined = first.records + one.records + rest.records
    check(strip_seconds(joined) == strip_seconds(recs),
          "stop/resume records differ from the full run's")
    check(one.events_ingested + rest.events_ingested < len(events),
          f"the resumes read {one.events_ingested + rest.events_ingested} events, not fewer "
          f"than the log's {len(events)}")
    check(first.publisher.peek().epoch_id == CONTROL_KILL_AFTER
          and one.publisher.peek().epoch_id == CONTROL_KILL_AFTER + 1
          and rest.publisher.peek().epoch_id == dig_rest["epochs_published"] == len(recs),
          "epoch ids do not continue across the resumes")
    check(np.array_equal(rest.controller.current_rf, ctl.current_rf)
          and np.array_equal(rest.controller.current_cat, ctl.current_cat),
          "stop/resume final plan differs from the full run's")
    log(f"daemon stop/resume: stopped after {CONTROL_KILL_AFTER} windows, resumed twice; "
        f"records identical in all {len(recs)} windows, resumes read "
        f"{one.events_ingested} + {rest.events_ingested} of {len(events)} events, epoch ids "
        f"continue, final rf/categories identical")
    log("daemon profile " + json.dumps(prof))

    # 7c: reads served from the pinned final epoch.
    ids = np.random.default_rng(MAIN_SEED).integers(0, len(manifest), size=1_000_000)
    t0 = time.perf_counter()
    view = ep.read_view(ids)
    view_s = time.perf_counter() - t0
    rows = view.replica_map[view.pid]
    topo = ClusterTopology(nodes=tuple(manifest.nodes))
    want, rf = EpochMap(manifest.nodes, topo).placement(0, ids, ep.rf[ids],
                                                        manifest.primary_node_id[ids])
    check(np.array_equal(rows, want), "pinned-epoch reads differ from the CPU placement")
    prim = primary_on_topology(manifest.nodes, manifest.primary_node_id[ids], topo)
    srt = np.sort(np.where(rows >= 0, rows, len(topo.nodes) + np.arange(rows.shape[1])), axis=1)
    check(bool((rows[:, 0] == prim).all()) and bool(((rows >= 0).sum(1) == rf).all())
          and bool((np.diff(srt, axis=1) > 0).all()),
          "a served row lacks rf distinct nodes with the primary first")
    log(f"daemon serve: {len(ids)} reads of {view.replica_map.shape[0]} unique files resolved "
        f"from epoch {ep.epoch_id} in {view_s:.3f} s, rows equal to the CPU placement, rf "
        f"distinct nodes each, primary first")
    del view, rows, want, srt
    daemon_small()
    return launches


def daemon_small():
    """7d: at 20,000 files (phase 4's workload) a follow-mode daemon at the
    default drift threshold tails a log written in 4 parts and stops on a
    SIGTERM request; then brownout runs over the whole log on the card
    (twice) and on the CPU, full re-clusters from one CPU init."""
    import dataclasses
    import threading

    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.daemon import BrownoutConfig, DaemonConfig, StreamDaemon
    from cdrs_tpu_torch.io.events import EventLog

    manifest, events = _phase4_workload()
    n = len(events)
    cuts = [0, n // 4, n // 2, 3 * n // 4, n]
    parts = [EventLog(ts=events.ts[a:b], path_id=events.path_id[a:b], op=events.op[a:b],
                      client_id=events.client_id[a:b], clients=events.clients)
             for a, b in zip(cuts, cuts[1:])]

    def config(dev):
        return dataclasses.replace(control_config(dev), drift_threshold=0.05)

    with tempfile.TemporaryDirectory() as tmp:
        full_log = os.path.join(tmp, "full.cdrsb")
        events.write_binary(full_log, manifest)
        live = os.path.join(tmp, "live.cdrsb")
        parts[0].write_binary(live, manifest)
        follow = StreamDaemon(ReplicationController(manifest, config("cuda")),
                              DaemonConfig(follow=True, poll=0.05))

        def writer():
            for part in parts[1:]:
                time.sleep(0.3)
                part.write_binary(live, manifest, append=True)
            time.sleep(3.0)
            follow.request_stop("SIGTERM")

        thread = threading.Thread(target=writer)
        thread.start()
        dig_f = follow.run(live)
        thread.join(timeout=60)
        check(not thread.is_alive(), "the log writer did not finish")
        batch = StreamDaemon(ReplicationController(manifest, config("cuda")))
        batch.run(full_log)
        k = len(follow.records)
        skipped = sum(not r["recluster"] for r in batch.records)
        log(f"daemon follow at {len(manifest)} files: {k} of {len(batch.records)} windows "
            f"decided before the SIGTERM ({dig_f['stop_reason']}), {dig_f['epochs_published']} "
            f"epochs; re-clusters {[r['recluster_mode'] for r in batch.records]}, drift "
            f"{[r['drift'] for r in batch.records]}, {skipped} windows skip the re-cluster")
        check(dig_f["stop_reason"] == "SIGTERM" and k >= 2 and dig_f["epochs_published"] == k,
              f"follow mode decided {k} windows, {dig_f['epochs_published']} epochs")
        check(strip_seconds(follow.records) == strip_seconds(batch.records)[:k],
              "follow-mode records are not a prefix of the non-follow run's")
        check(skipped >= 1, "no window skipped the re-cluster at the default threshold")

        runs = []
        for dev in ("cuda", "cuda", "cpu"):
            ctl = ReplicationController(manifest, config(dev))
            watch_reclusters(ctl, cpu_init)
            d = StreamDaemon(ctl, DaemonConfig(brownout=BrownoutConfig(
                engage=(0.5, 1.0, 1.5, 2.0, 3.0), release=(0.2, 0.4, 0.6, 0.8, 1.0))))
            runs.append((d, d.run(full_log)))
    (d1, dig1), (d2, _), (dc, _) = runs

    def canon(records):
        out = []
        for r in strip_seconds(records):
            r = dict(r, daemon={k: v for k, v in r["daemon"].items() if k != "lag_seconds"})
            out.append(json.dumps(r, sort_keys=True))
        return out

    hashes = [[r["plan_hash"] for r in d.records] for d in (d1, dc)]
    log(f"daemon brownout at {len(manifest)} files: {len(d1.records)} decisions, coalesced "
        f"{[r['daemon']['coalesced'] for r in d1.records]}, levels "
        f"{[r['daemon']['brownout_level'] for r in d1.records]}, windows_coalesced "
        f"{dig1['brownout']['windows_coalesced']}; plan hashes card {hashes[0]} cpu {hashes[1]}")
    check(dig1["brownout"]["windows_coalesced"] > 0, "brownout coalesced no window")
    check(sum(r["n_events"] for r in d1.records) == d1.events_ingested == n,
          "brownout decisions do not fold every event once")
    check(canon(d1.records) == canon(d2.records) and d1.brownout_log == d2.brownout_log,
          "two brownout runs differ beyond the wall-clock fields")
    check(hashes[0] == hashes[1], "brownout plan hashes differ between the card and the CPU")


def rf2_scoring():
    """The validated scoring table with every category at rf >= 2."""
    import dataclasses

    from cdrs_tpu_torch import validated_scoring_config

    base = validated_scoring_config()
    return dataclasses.replace(base, replication_factors={
        c: max(2, r) for c, r in base.replication_factors.items()})


def chaos_config(device: str, specs, **kw):
    """Phase 6's settings on the fault path: the schedule ``specs``, rf >= 2
    from the start, repair seed 0."""
    import dataclasses

    from cdrs_tpu_torch.faults import FaultSchedule

    return dataclasses.replace(control_config(device), default_rf=2, scoring=rf2_scoring(),
                               fault_schedule=FaultSchedule.from_specs(specs), repair_seed=0,
                               **kw)


CHAOS_STAGES = ("fold", "drift", "recluster", "faults", "repair", "scrub", "plan", "schedule",
                "evaluate", "total")


def phase_chaos(manifest, events):
    """Phase 8: the chaos controller on the card over phase 5's workload
    (8a), then at 20,000 files on 12 nodes in 4 racks (8b) and with decay
    0.7 (8c), each on the card against the CPU.  Returns the kernels'
    launches in 8a."""
    import numpy as np

    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.faults import ScrubConfig
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count

    specs = [f"crash:{CHAOS_KILL}", f"corrupt:{CHAOS_CORRUPT}"]

    def config():
        return chaos_config("cuda", specs, scrub=ScrubConfig(bytes_per_window=CHAOS_SCRUB_BYTES))

    with tempfile.TemporaryDirectory() as tmp, deterministic():
        ctl = ReplicationController(manifest, config())
        seen = watch_reclusters(ctl)
        # The kill: the snapshot after window 3, copied aside as the run goes
        # on (re-running windows 0-3 would double the smoke's longest part).
        ck = os.path.join(tmp, "killed.npz")
        save = ctl.save_checkpoint

        def save_and_keep(path, *args, **kw):
            save(path, *args, **kw)
            if ctl.window_index == CONTROL_KILL_AFTER + 1:
                shutil.copyfile(path, ck)

        ctl.save_checkpoint = save_and_keep
        lloyd_assign_reduce.launches = 0
        label_threshold_count.launches = 0
        t0 = time.perf_counter()
        full = ctl.run(events, checkpoint_path=os.path.join(tmp, "full.npz"))
        wall = time.perf_counter() - t0
        launches = {"lloyd": lloyd_assign_reduce.launches,
                    "seg_count": label_threshold_count.launches}
        recs = full.records
        log(f"chaos: {len(manifest)} files, {len(recs)} windows of {CONTROL_WINDOW:g} s, "
            f"faults {specs}, scrub {CHAOS_SCRUB_BYTES} B a window; wall {wall:.3f} s "
            f"(checkpoints included), re-clusters {[r['recluster_mode'] for r in recs]}, "
            f"Lloyd iterations {[c['n_iter'] for c in seen]}, launches {launches}")
        for r in recs:
            log("chaos window " + json.dumps(
                {k: r.get(k) for k in ("window", "fault_events", "nodes_up", "moves_applied",
                                       "repair_moves", "repair_bytes", "repair_backlog",
                                       "repair_deferred_budget", "repair_deferred_no_source",
                                       "scrub", "durability", "integrity", "unavailable_reads",
                                       "plan_hash", "seconds")}))
        per_stage = {st: sum(r["seconds"].get(st, 0.0) for r in recs) / len(recs)
                     for st in CHAOS_STAGES}
        log("chaos stages mean seconds per window " + json.dumps(per_stage))
        log("chaos summary " + json.dumps(full.summary()))
        want_lloyd = sum(c["n_iter"] + 1 for c in seen)
        check(len(seen) == len(recs), f"chaos: {len(seen)} re-clusters for {len(recs)} windows")
        check(launches["lloyd"] == want_lloyd,
              f"chaos made {launches['lloyd']} Lloyd launches, expected {want_lloyd}")
        check(launches["seg_count"] == 12 * len(seen),
              f"chaos made {launches['seg_count']} threshold-count launches, expected "
              f"{12 * len(seen)}")
        check(len(recs) >= 5, f"chaos ran {len(recs)} windows, the kill spans windows 2-3 "
              f"and the recovery window 4")
        check(recs[2]["fault_events"] == [f"crash:{CHAOS_KILL.split('-')[0]}"],
              f"window 2's fault events are {recs[2]['fault_events']}")
        for r in recs[2:4]:
            check(r["nodes_up"] == 2 and r["durability"]["nodes_up"] == 2
                  and r["repair_moves"] > 0,
                  f"window {r['window']}: nodes up {r['nodes_up']}, repairs "
                  f"{r['repair_moves']} while dn2 is down")
        check(all("integrity" in r and "durability" in r for r in recs),
              "a chaos window lacks its integrity or durability record")
        # rf >= 2 everywhere: while two of three nodes are live, a file can
        # lose every live copy only if a rotten one was quarantined (by the
        # scrubber or a repair's source check) and not yet replaced.
        detected = np.cumsum([r["integrity"]["detected_scrub"]
                              + r["integrity"]["detected_repair"] for r in recs])
        for r, det in zip(recs, detected):
            check(r["durability"]["lost"] <= r["integrity"]["true_lost"],
                  f"window {r['window']}: the lost tier overstates the ground truth")
            if r["nodes_up"] >= 2:
                check(r["durability"]["lost"] <= det,
                      f"window {r['window']}: {r['durability']['lost']} files lost with "
                      f"{r['nodes_up']} nodes live and {det} rotten copies quarantined")
        check(all(r["durability"]["lost"] == 0 for r in recs[:2]),
              "files lost before the kill")
        check(sum(r["integrity"]["detected_scrub"] for r in recs) > 0,
              "the scrubber found none of the rot")

        check(os.path.exists(ck), "no snapshot after window 3")
        resumed = ReplicationController(manifest, config())
        resumed.load_checkpoint(ck)
        one, prof = profile_window(resumed, events)
        resumed.save_checkpoint(ck)
        rest_ctl = ReplicationController(manifest, config())
        rest = rest_ctl.run(events, checkpoint_path=ck)
        joined = one.records + rest.records
        check(strip_seconds(joined) == strip_seconds(recs[CONTROL_KILL_AFTER + 1:]),
              "chaos kill/resume records differ from the uninterrupted run's")
        got, want = rest_ctl._cluster_state.state_arrays(), ctl._cluster_state.state_arrays()
        check(set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want),
              "chaos kill/resume ClusterState.state_arrays() differ from the full run's")
        log(f"chaos kill/resume: killed after window {CONTROL_KILL_AFTER} (dn2 down), "
            f"resumed; records identical apart from seconds in windows "
            f"{[r['window'] for r in joined]}, "
            f"state_arrays identical ({', '.join(sorted(want))})")
        log("chaos profile " + json.dumps(prof))
        check(prof["window"] in (2, 3, 4), f"the profiled window {prof['window']} is not faulted")

    chaos_racks_card_cpu()
    decay_card_cpu()
    return launches


def chaos_racks_card_cpu():
    """8b: phase 4's workload on 12 nodes in 4 racks, a whole-rack kill, a
    partition and a straggler, on the card and on the CPU from one init."""
    import numpy as np

    from cdrs_tpu_torch.cluster.placement import ClusterTopology
    from cdrs_tpu_torch.control.controller import ReplicationController

    nodes = tuple(f"dn{i}" for i in range(1, 13))
    manifest, events = _phase4_workload(nodes)
    topo = ClusterTopology.from_rack_spec(nodes, CHAOS_RACKS)
    specs = ["crash:rack:r1@2-3", "partition:dn7+dn8@1-2", "degrade:dn9@1-3:0.25"]
    runs = {}
    for dev in ("cuda", "cpu"):
        ctl = ReplicationController(manifest, chaos_config(dev, specs, topology=topo))
        watch_reclusters(ctl, cpu_init)
        runs[dev] = (ctl, ctl.run(events))
    keys = ("repair_moves", "repair_bytes", "repair_failed", "repair_rebalanced",
            "repair_deferred_partition", "repair_deferred_no_source")
    per = {dev: [(r["plan_hash"], r["durability"], [r[k] for k in keys]) for r in res.records]
           for dev, (_, res) in runs.items()}
    (ctl_c, res_c), (ctl_p, _) = runs["cuda"], runs["cpu"]
    log(f"chaos racks at {len(manifest)} files on 12 nodes, {specs}: plan hashes "
        f"{[p[0] for p in per['cuda']]}; lost {[p[1]['lost'] for p in per['cuda']]}, "
        f"unreachable {[p[1]['unreachable'] for p in per['cuda']]}, correlated_risk "
        f"{[p[1]['correlated_risk'] for p in per['cuda']]}, repairs "
        f"{[p[2][0] for p in per['cuda']]}")
    check([p[0] for p in per["cuda"]] == [p[0] for p in per["cpu"]],
          "8b plan hashes differ between the card and the CPU")
    check([p[1] for p in per["cuda"]] == [p[1] for p in per["cpu"]],
          "8b durability tiers differ between the card and the CPU")
    check([p[2] for p in per["cuda"]] == [p[2] for p in per["cpu"]],
          "8b repair counts differ between the card and the CPU")
    got, want = ctl_c._cluster_state.state_arrays(), ctl_p._cluster_state.state_arrays()
    check(all(np.array_equal(got[k], want[k]) for k in want),
          "8b final state_arrays differ between the card and the CPU")
    check(sum(p[2][0] for p in per["cuda"]) > 0, "8b made no repair")
    check(all(p[1]["lost"] == 0 for p in per["cuda"]), "8b lost files in a rack kill at rf >= 2")
    log(f"chaos racks card vs cpu: plan hashes, durability tiers, repair counts and final "
        f"state_arrays identical in all {len(res_c.records)} windows")


def decay_card_cpu():
    """8c: phase 4's workload with decay 0.7 on the card and on the CPU."""
    import dataclasses

    import numpy as np

    from cdrs_tpu_torch.control.controller import ReplicationController

    manifest, events = _phase4_workload()
    runs = {}
    for dev in ("cuda", "cpu"):
        ctl = ReplicationController(manifest, dataclasses.replace(control_config(dev),
                                                                  decay=0.7))
        watch_reclusters(ctl, cpu_init)
        runs[dev] = (ctl, ctl.run(events))
    (ctl_c, res_c), (ctl_p, res_p) = runs["cuda"], runs["cpu"]
    hashes = [[r["plan_hash"] for r in res.records] for res in (res_c, res_p)]
    dec_c, dec_p = ctl_c.decayed_counters(), ctl_p.decayed_counters()
    log(f"decay 0.7 at {len(manifest)} files: plan hashes card {hashes[0]} cpu {hashes[1]}; "
        f"accumulator sums " + json.dumps({k: float(v.sum()) for k, v in dec_c.items()}))
    check(all(v.dtype == np.float64 and np.array_equal(v, dec_p[k]) for k, v in dec_c.items()),
          "8c decayed accumulators differ between the card and the CPU")
    check(ctl_c._dec_obs_end == ctl_p._dec_obs_end, "8c observation ends differ")
    check(hashes[0] == hashes[1], "8c plan hashes differ between the card and the CPU")
    log("decay card vs cpu: float64 accumulators bit-equal, plan hashes identical")


def model_runs():
    """Wrap ``ReplicationPolicyModel.run`` class-wide so each re-cluster of
    any controller appends its Lloyd iterations to the returned list;
    ``init_fn(X, model)``, when set in ``hooks``, gives the cold init."""
    from cdrs_tpu_torch.models.replication import ReplicationPolicyModel

    seen, hooks = [], {"init_fn": None}
    run = ReplicationPolicyModel.run

    def counted(self, X, feature_names=None, init_centroids=None, **kw):
        if init_centroids is None and hooks["init_fn"] is not None:
            init_centroids = hooks["init_fn"](X, self)
        dec = run(self, X, feature_names, init_centroids=init_centroids, **kw)
        seen.append(self.n_iter)
        return dec

    ReplicationPolicyModel.run = counted
    return seen, hooks, lambda: setattr(ReplicationPolicyModel, "run", run)


def cpu_model_init(X, model):
    """The D² init of the model's k and seed, computed on the CPU."""
    from cdrs_tpu_torch.ops.kmeans import kmeans_full

    cfg = model.kmeans_cfg
    return kmeans_full(X.cpu(), cfg.k, seed=cfg.seed, max_iter=0, tol=0.0)[0]


def phase_scenarios():
    """Phase 9: the scenario matrix on the card (9a), then one cell at the
    main path's scale (9b).  Returns the kernels' launches in the cells'
    runs on the card's own init."""
    import torch

    import cdrs_tpu_torch.ops.kmeans as kmeans_mod
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count
    from cdrs_tpu_torch.scenarios import run_cell, suite_cells

    # The mesh cell, scale-mesh, runs in phase 14c.
    cells = [c for c in suite_cells("full", 0) if c.mesh is None]
    check(sorted(c.name for c in cells) == sorted(SCENARIO_CELLS),
          f"the ported cells at suite seed 0 are {[c.name for c in cells]}")
    seen, hooks, restore = model_runs()
    launches = {"lloyd": 0, "seg_count": 0}
    # The rows each D² init on the card picks: its centroids are those rows,
    # so the init carries to any device (ROADMAP Queue C's protocol).
    init_rows, d2 = [], kmeans_mod._d2_init

    def d2_rows(x, k, seed):
        c = d2(x, k, seed)
        rows = torch.argmin(((x[:, None, :] - c[None, :, :]) ** 2).sum(-1), dim=0)
        check(torch.equal(x[rows], c), "a D² centroid is not a row of its points")
        init_rows.append(rows.cpu().tolist())
        return c

    kmeans_mod._d2_init = d2_rows
    try:
        for spec in cells:
            seen.clear()
            init_rows.clear()
            lloyd_assign_reduce.launches = 0
            label_threshold_count.launches = 0
            cell = run_cell(spec, device="cuda")
            got = {"lloyd": lloyd_assign_reduce.launches,
                   "seg_count": label_threshold_count.launches}
            for k in launches:
                launches[k] += got[k]
            failed = sorted(k for k, v in cell["invariants"].items() if not v)
            log("scenario cell " + json.dumps(
                {"cell": spec.name, "ok": cell["ok"], "seconds": cell["seconds"],
                 "windows": cell["metrics"]["windows"],
                 "reclusters": cell["metrics"]["reclusters"], "model_runs": len(seen),
                 "b1_launches": got["lloyd"], "b2_launches": got["seg_count"],
                 "alerts_fired": cell["metrics"]["alerts_fired"], "failed": failed,
                 "init_rows": init_rows}))
            if spec.name in SCENARIO_QUEUE_C:
                entry, want = SCENARIO_QUEUE_C[spec.name]
                check(failed == want, f"scenario {spec.name} on the card's own init fails "
                      f"{failed}, {entry} records {want}")
                log(f"scenario {spec.name}: red on the card's own init as {entry} records; "
                    f"judged from the CPU-computed init below")
            else:
                check(cell["ok"], f"scenario {spec.name} is red on the card's own init: "
                      f"{cell['invariants']}")
            check(got["lloyd"] == sum(n + 1 for n in seen),
                  f"scenario {spec.name}: {got['lloyd']} Lloyd launches, expected "
                  f"{sum(n + 1 for n in seen)}")
            check(got["seg_count"] == 0, f"scenario {spec.name}: {got['seg_count']} "
                  f"threshold-count launches at {spec.n_files} files")
        kmeans_mod._d2_init = d2
        # The card against the CPU, both from cold inits computed on the CPU.
        hooks["init_fn"] = cpu_model_init
        for spec in cells:
            card, cpu = (run_cell(spec, device=d) for d in ("cuda", "cpu"))
            for key in ("invariants", "metrics", "coverage", "fingerprint"):
                check(card[key] == cpu[key], f"scenario {spec.name}: {key} differ between "
                      f"the card and the CPU: {card[key]} vs {cpu[key]}")
            check(card["ok"], f"scenario {spec.name} is red from the CPU init")
        log(f"scenario card vs cpu: invariants, metrics, coverage bits equal in all "
            f"{len(cells)} cells from CPU-computed inits")
        hooks["init_fn"] = None
        scale = scenario_at_scale(seen)
    finally:
        kmeans_mod._d2_init = d2
        restore()
    for k in launches:
        launches[k] += scale[k]
    return launches


def scenario_at_scale(seen):
    """9b: ``gradual-drift`` at the main path's scale; returns its launches."""
    import torch
    from torch.autograd import DeviceType

    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count
    from cdrs_tpu_torch.scenarios import preset, run_cell

    spec = preset("gradual-drift").replace(**SCENARIO_SCALE)
    results, prof = [], {}
    run, phase_a, phase_b = (ReplicationController.run, ReplicationController._window_phase_a,
                             ReplicationController._window_phase_b)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def keep(self, *a, **kw):
        res = run(self, *a, **kw)
        results.append(res)
        return res

    def profiled_a(self, w, events):
        if w == SCENARIO_PROFILED_WINDOW:
            prof["p"] = torch.profiler.profile(activities=acts)
            prof["p"].__enter__()
        return phase_a(self, w, events)

    def profiled_b(self, ctx):
        rec = phase_b(self, ctx)
        if ctx["w"] == SCENARIO_PROFILED_WINDOW:
            torch.cuda.synchronize()
            prof["p"].__exit__(None, None, None)
            busy = sum(ev.time_range.elapsed_us() for ev in prof["p"].events()
                       if ev.device_type == DeviceType.CUDA) / 1e6
            wall = rec["seconds"]["total"]
            del prof["p"]
            prof.update(window=rec["window"], mode=rec["recluster_mode"], wall_s=wall,
                        device_busy_s=busy, idle_share=1 - busy / wall if busy else None)
        return rec

    seen.clear()
    lloyd_assign_reduce.launches = 0
    label_threshold_count.launches = 0
    (ReplicationController.run, ReplicationController._window_phase_a,
     ReplicationController._window_phase_b) = keep, profiled_a, profiled_b
    try:
        cell = run_cell(spec, device="cuda")
    finally:
        (ReplicationController.run, ReplicationController._window_phase_a,
         ReplicationController._window_phase_b) = run, phase_a, phase_b
    launches = {"lloyd": lloyd_assign_reduce.launches, "seg_count": label_threshold_count.launches}
    recs = results[0].records
    stages = ("fold", "drift", "recluster", "plan", "schedule", "evaluate", "total")
    per_stage = {st: sum(r["seconds"].get(st, 0.0) for r in recs) / len(recs) for st in stages}
    log(f"scenario at scale: gradual-drift, cuts {json.dumps(SCENARIO_SCALE)} (preset: 300 "
        f"files, 2400 s, alerts {{expect: [], forbid: others}}); {cell['metrics']['events']} "
        f"events in {len(recs)} windows of {spec.window_seconds:g} s; cell {cell['seconds']} s; "
        f"re-clusters {[r['recluster_mode'] for r in recs]}, Lloyd iterations {list(seen)}, "
        f"launches {launches}")
    log("scenario at scale cell " + json.dumps({k: cell[k] for k in ("ok", "invariants",
                                                                      "metrics", "coverage")}))
    log("scenario at scale stages mean seconds per window " + json.dumps(per_stage))
    log("scenario at scale profile " + json.dumps(prof))
    check(cell["ok"], f"gradual-drift at scale is red: {cell['invariants']}")
    check(set(cell["invariants"]) == {"budget_conserved", "drift_engaged"},
          f"gradual-drift at scale checked {sorted(cell['invariants'])}")
    check(len(seen) == cell["metrics"]["reclusters"] > 0,
          f"{len(seen)} model runs for {cell['metrics']['reclusters']} re-clusters")
    check(launches["lloyd"] == sum(n + 1 for n in seen),
          f"at scale: {launches['lloyd']} Lloyd launches, expected {sum(n + 1 for n in seen)}")
    check(launches["seg_count"] == 12 * len(seen),
          f"at scale: {launches['seg_count']} threshold-count launches, expected "
          f"{12 * len(seen)}")
    check(prof.get("window") == SCENARIO_PROFILED_WINDOW, "the profiled window did not run")
    return launches


def serve_config(device: str, **kw):
    """Phase 6's settings with the read path (p2c, defaults)."""
    import dataclasses

    from cdrs_tpu_torch.serve import ServeConfig

    return dataclasses.replace(control_config(device), serve=ServeConfig(policy="p2c"), **kw)


def flash_crowd_events(manifest):
    """Phase 3's traffic plus the flash crowd of 10a; returns the log and the
    cohort's size."""
    import numpy as np

    from cdrs_tpu_torch import SimulatorConfig
    from cdrs_tpu_torch.sim.access import simulate_flash_crowd

    hot = np.flatnonzero(np.asarray(manifest.category) == "hot")
    n = int(SERVE_COHORT_FRAC * len(manifest))
    cohort = np.zeros(len(manifest), dtype=bool)
    cohort[np.random.default_rng(MAIN_SEED).choice(hot, n, replace=False)] = True
    events, _ = simulate_flash_crowd(
        manifest, SimulatorConfig(duration_seconds=MAIN_DURATION, seed=MAIN_SEED + 1),
        cohort=cohort, start=SERVE_BURST[0], duration=SERVE_BURST[1], boost=SERVE_BOOST)
    return events, n


def profile_phases(ctl, window, prof):
    """Profile window ``window`` of ``ctl``'s run (its phase A through its
    phase B) with torch.profiler; fills ``prof`` with the host wall time,
    device busy time, idle share and the kernels' launches seen."""
    import torch
    from torch.autograd import DeviceType

    phase_a, phase_b = ctl._window_phase_a, ctl._window_phase_b
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def profiled_a(w, events):
        if w == window:
            prof["p"] = torch.profiler.profile(activities=acts)
            prof["p"].__enter__()
        return phase_a(w, events)

    def profiled_b(ctx):
        rec = phase_b(ctx)
        if ctx["w"] == window:
            torch.cuda.synchronize()
            p = prof.pop("p")
            p.__exit__(None, None, None)
            busy_us, lloyd, seg = 0.0, 0, 0
            for ev in p.events():
                if ev.device_type == DeviceType.CUDA:
                    busy_us += ev.time_range.elapsed_us()
                    lloyd += "lloyd_" in ev.name
                    seg += "seg_" in ev.name
            wall = rec["seconds"]["total"]
            prof.update(window=rec["window"], trigger=rec["recluster_trigger"],
                        mode=rec["recluster_mode"], wall_s=wall, device_busy_s=busy_us / 1e6,
                        idle_share=1 - busy_us / 1e6 / wall if busy_us else None,
                        lloyd_launches_seen=lloyd, seg_launches_seen=seg,
                        seconds=rec["seconds"])
        return rec

    ctl._window_phase_a, ctl._window_phase_b = profiled_a, profiled_b


def storage_config(device: str, storage: str | None, window: float = CONTROL_WINDOW,
                   crash: str = STORAGE_CRASH, **kw):
    """Phase 8's settings on 12 nodes in 4 racks with rack r1 crashed from
    window 3, and the storage config ``storage`` (None, "replicate" or
    "ec_archival") resolved against phase 8's scoring."""
    import dataclasses

    from cdrs_tpu_torch.cluster.placement import ClusterTopology
    from cdrs_tpu_torch.storage import resolve_storage_config

    topo = ClusterTopology.from_rack_spec(STORAGE_NODES, CHAOS_RACKS)
    cfg = chaos_config(device, [crash], topology=topo, **kw)
    return dataclasses.replace(cfg, window_seconds=window,
                               storage=resolve_storage_config(storage, cfg.scoring))


STORAGE_RECORD_KEYS = ("bytes_stored", "bytes_raw", "overhead_ratio", "ec_files", "cost_units")


def phase_storage():
    """Phase 11: storage strategies, EC(6,3) Archival on 12 nodes in 4 racks
    with a rack crashed for good, at the main path's scale (11a) and at
    20,000 files against no storage, replicate and the CPU (11b).  Returns
    the kernels' launches in 11a."""
    import numpy as np

    from cdrs_tpu_torch import GeneratorConfig, SimulatorConfig
    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count
    from cdrs_tpu_torch.sim.access import simulate_access
    from cdrs_tpu_torch.sim.generator import generate_population

    t0 = time.perf_counter()
    manifest = generate_population(GeneratorConfig(n_files=MAIN_FILES, seed=MAIN_SEED,
                                                   nodes=STORAGE_NODES))
    t_gen = time.perf_counter() - t0
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=STORAGE_SPAN_A,
                                                       seed=MAIN_SEED + 1))
    log(f"storage workload: {len(manifest)} files on {len(STORAGE_NODES)} nodes, "
        f"{len(events)} events over {STORAGE_SPAN_A:g} s; gen {t_gen:.3f} s, simulate "
        f"{time.perf_counter() - t0 - t_gen:.3f} s")

    def config():
        return storage_config("cuda", "ec_archival", crash=STORAGE_CRASH_A)

    with tempfile.TemporaryDirectory() as tmp, deterministic():
        ctl = ReplicationController(manifest, config())
        seen = watch_reclusters(ctl)
        prof: dict = {}
        profile_phases(ctl, 2, prof)   # the crash window
        ck = os.path.join(tmp, "killed.npz")
        save = ctl.save_checkpoint

        def save_and_keep(path, *args, **kw):
            save(path, *args, **kw)
            if ctl.window_index == STORAGE_KILL_AFTER_A + 1:
                shutil.copyfile(path, ck)

        ctl.save_checkpoint = save_and_keep
        lloyd_assign_reduce.launches = 0
        label_threshold_count.launches = 0
        t0 = time.perf_counter()
        full = ctl.run(events, checkpoint_path=os.path.join(tmp, "full.npz"))
        wall = time.perf_counter() - t0
        launches = {"lloyd": lloyd_assign_reduce.launches,
                    "seg_count": label_threshold_count.launches}
        recs = full.records
        log(f"storage: ec_archival, {len(recs)} windows of {CONTROL_WINDOW:g} s, "
            f"{STORAGE_CRASH_A}; wall {wall:.3f} s (checkpoints included), re-clusters "
            f"{[r['recluster_mode'] for r in recs]}, Lloyd iterations "
            f"{[c['n_iter'] for c in seen]}, launches {launches}")
        for r in recs:
            log("storage window " + json.dumps(
                {"window": r["window"], "fault_events": r["fault_events"],
                 "nodes_up": r["nodes_up"], "moves_applied": r["moves_applied"],
                 "repair_moves": r["repair_moves"], "repair_bytes": r["repair_bytes"],
                 "repair_backlog": r["repair_backlog"],
                 "conversions_retried": r["storage_conversions_retried"],
                 "lost": r["durability"]["lost"], "at_risk": r["durability"]["at_risk"],
                 "under_replicated": r["durability"]["under_replicated"],
                 "storage": {k: r["storage"][k] for k in STORAGE_RECORD_KEYS},
                 "per_tier_bytes": r["storage"]["per_tier_bytes"],
                 "causes": r.get("causes"), "seconds": r["seconds"]}))
        per_stage = {st: sum(r["seconds"].get(st, 0.0) for r in recs) / len(recs)
                     for st in CHAOS_STAGES}
        log("storage stages mean seconds per window " + json.dumps(per_stage))
        log("storage summary " + json.dumps(full.summary()))
        log("storage profile " + json.dumps(prof))
        want_lloyd = sum(c["n_iter"] + 1 for c in seen)
        check(len(recs) == 4, f"storage ran {len(recs)} windows, wants 4")
        check(len(seen) == len(recs), f"storage: {len(seen)} re-clusters for {len(recs)} "
              f"windows")
        check(launches["lloyd"] == want_lloyd, f"storage made {launches['lloyd']} Lloyd "
              f"launches, expected {want_lloyd}")
        check(launches["seg_count"] == 12 * len(seen), f"storage made "
              f"{launches['seg_count']} threshold-count launches, expected {12 * len(seen)}")
        check(recs[2]["fault_events"] == ["crash:dn4@2", "crash:dn5@2", "crash:dn6@2"],
              f"window 2's fault events are {recs[2]['fault_events']}")
        check(all(r["nodes_up"] == 9 and r["repair_moves"] > 0 for r in recs[2:]),
              "storage: rack r1 not down, or no repair, from window 2")
        check(all(r["durability"]["lost"] == 0 for r in recs), "storage lost files")
        check(all(r["storage"]["bytes_raw"] == int(np.asarray(manifest.size_bytes).sum())
                  and r["storage"]["bytes_stored"] > r["storage"]["bytes_raw"] for r in recs),
              "storage records miss the stored bytes")
        check(prof.get("window") == 2 and prof.get("lloyd_launches_seen", 0) > 0,
              f"storage profile of the crash window: {prof}")

        check(os.path.exists(ck), f"no snapshot after window {STORAGE_KILL_AFTER_A}")
        rest_ctl = ReplicationController(manifest, config())
        rest = rest_ctl.run(events, checkpoint_path=ck)
        check(strip_seconds(rest.records) == strip_seconds(recs[STORAGE_KILL_AFTER_A + 1:]),
              "storage kill/resume records differ from the uninterrupted run's")
        got, want = rest_ctl._cluster_state.state_arrays(), ctl._cluster_state.state_arrays()
        check(set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want),
              "storage kill/resume ClusterState.state_arrays() differ from the full run's")
        check(np.array_equal(rest_ctl._installed_cat, ctl._installed_cat),
              "storage kill/resume installed categories differ")
        log(f"storage kill/resume: killed after window {STORAGE_KILL_AFTER_A}, resumed; records "
            f"identical apart from seconds in windows {[r['window'] for r in rest.records]}, "
            f"state_arrays identical")
    del events
    storage_small()
    return launches


def storage_small():
    """11b: 20,000 files on the same 12 nodes and racks over 720 s, with no
    storage, replicate and ec_archival on the card, the EC run on the CPU
    from the same init, the EC run's kill and resume, and EC with serving."""
    import numpy as np

    from cdrs_tpu_torch import GeneratorConfig, SimulatorConfig
    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.serve import ServeConfig
    from cdrs_tpu_torch.sim.access import simulate_access
    from cdrs_tpu_torch.sim.generator import generate_population

    manifest = generate_population(GeneratorConfig(n_files=20_000, seed=MAIN_SEED,
                                                   nodes=STORAGE_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=STORAGE_SPAN_B,
                                                       seed=MAIN_SEED + 1))
    drop = ("seconds", "storage", "storage_conversions_retried")

    def run(dev, storage, ck=None, **kw):
        ctl = ReplicationController(manifest, storage_config(dev, storage, STORAGE_WINDOW_B,
                                                             **kw))
        watch_reclusters(ctl, cpu_init)
        return ctl, ctl.run(events, checkpoint_path=ck)

    def arrays_equal(a, b):
        x, y = a._cluster_state.state_arrays(), b._cluster_state.state_arrays()
        return set(x) == set(y) and all(np.array_equal(x[k], y[k]) for k in y)

    runs = {name: run("cuda", name) for name in (None, "replicate")}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ec.npz")
        ctl_ec, res_ec = run("cuda", "ec_archival", ck)
        killed = os.path.join(tmp, "killed.npz")
        ctl_a = ReplicationController(manifest, storage_config("cuda", "ec_archival",
                                                               STORAGE_WINDOW_B))
        watch_reclusters(ctl_a, cpu_init)
        part = ctl_a.run(events, checkpoint_path=killed, max_windows=STORAGE_KILL_AFTER + 1)
        ctl_b = ReplicationController(manifest, storage_config("cuda", "ec_archival",
                                                               STORAGE_WINDOW_B))
        watch_reclusters(ctl_b, cpu_init)
        rest = ctl_b.run(events, checkpoint_path=killed)
    runs["ec_archival"] = (ctl_ec, res_ec)
    ctl_cpu, res_cpu = run("cpu", "ec_archival")
    (ctl_n, res_n), (ctl_r, res_r) = runs[None], runs["replicate"]
    for name, (_, res) in runs.items():
        last = res.records[-1]
        log(f"storage 20k {name}: plan hashes {[r['plan_hash'] for r in res.records]}, lost "
            f"{[r['durability']['lost'] for r in res.records]}, repairs "
            f"{[r['repair_moves'] for r in res.records]}, storage "
            + json.dumps(last.get("storage")))
    check(strip_seconds([{k: v for k, v in r.items() if k not in drop}
                         for r in res_r.records]) == strip_seconds(res_n.records),
          "11b: replicate's records differ from no storage's")
    check(arrays_equal(ctl_r, ctl_n) and np.array_equal(res_r.rf, res_n.rf),
          "11b: replicate's state_arrays or plan differ from no storage's")
    check(all(r["durability"]["lost"] == 0 for r in res_ec.records), "11b: EC lost files")
    st_ec, st_rep = res_ec.records[-1]["storage"], res_r.records[-1]["storage"]
    arch_ec = st_ec["per_category_bytes"].get("Archival", 0)
    arch_rep = st_rep["per_category_bytes"].get("Archival", 0)
    check(st_ec["ec_files"] > 0 and arch_ec > 0 and arch_rep >= 2 * arch_ec,
          f"11b: Archival bytes {arch_rep} under replicate vs {arch_ec} under EC "
          f"({st_ec['ec_files']} EC files)")
    log(f"storage 20k: replicate = no storage in every record and state_arrays; EC lost 0; "
        f"Archival bytes replicate {arch_rep} / EC {arch_ec} = {arch_rep / arch_ec:.4f}; "
        f"overhead {st_rep['overhead_ratio']} -> {st_ec['overhead_ratio']}, cost units "
        f"{st_rep['cost_units']} -> {st_ec['cost_units']}")
    _records_match(res_ec.records, res_cpu.records, "11b EC card vs cpu")
    check(arrays_equal(ctl_ec, ctl_cpu), "11b EC state_arrays differ between the card and "
          "the CPU")
    check(strip_seconds(part.records + rest.records) == strip_seconds(res_ec.records)
          and arrays_equal(ctl_b, ctl_ec), "11b EC kill/resume differs from the full run")
    log(f"storage 20k EC card vs cpu: every record (drift within 1e-6) and state_arrays "
        f"equal; kill after window {STORAGE_KILL_AFTER} and resume bit-identical")

    # Serving: the penalties of each window (degraded EC files: a cold
    # stripe whose primary shard is down gathers k shards), then the same
    # run with the storage penalty removed, whose latencies must be lower.
    serve = ServeConfig(policy="p2c")
    ctl_s = ReplicationController(manifest, storage_config("cuda", "ec_archival",
                                                           STORAGE_WINDOW_B, serve=serve))
    watch_reclusters(ctl_s, cpu_init)
    penalty = ctl_s._serve_penalty_ms
    gather = serve.service_ms * 5 * 4.0     # (k - 1) shards at the cold tier's 1/0.25
    degraded = []

    def counted(slot_ok):
        pen = penalty(slot_ok)
        degraded.append(int((pen >= gather).sum()))
        return pen

    ctl_s._serve_penalty_ms = counted
    res_s = ctl_s.run(events)
    ctl_z = ReplicationController(manifest, storage_config("cuda", "ec_archival",
                                                           STORAGE_WINDOW_B, serve=serve))
    watch_reclusters(ctl_z, cpu_init)
    ctl_z._serve_penalty_ms = lambda slot_ok: np.zeros(slot_ok.shape[0])
    res_z = ctl_z.run(events)
    for r, z, d in zip(res_s.records, res_z.records, degraded):
        log("storage serve window " + json.dumps(
            {"window": r["window"], "degraded_ec_files": d, "reads": r["n_reads"],
             "reads_unavailable": r["reads_unavailable"],
             "p50_ms": r["latency_p50_ms"], "p99_ms": r["latency_p99_ms"],
             "p50_ms_without_penalty": z["latency_p50_ms"],
             "p99_ms_without_penalty": z["latency_p99_ms"]}))
    check(len(degraded) == len(res_s.records), "11b serve: a window routed no read")
    check(all(d == 0 for d in degraded[:3]) and all(d > 0 for d in degraded[3:]),
          f"11b serve: degraded EC files per window {degraded}, want 0 before the crash")
    check(all(r["latency_p99_ms"] >= z["latency_p99_ms"] and r["latency_p50_ms"]
              >= z["latency_p50_ms"] for r, z in zip(res_s.records, res_z.records))
          and any(r["latency_p99_ms"] > z["latency_p99_ms"]
                  for r, z in zip(res_s.records[3:], res_z.records[3:])),
          "11b serve: the storage penalty does not show in the latency records")


def phase_serve(manifest, work):
    """Phase 10: the serving controller at the main path's scale (10a), the
    ``serve`` command over its log (10b, in a child process from the
    start), and the card against the CPU at 20,000 files (10c, 10d).
    Returns the kernels' launches in 10a."""
    # 10b runs in a child from the start: it writes 10a's manifest and log
    # (the same seeded generation) and runs the serve command over them.
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    child_log = os.path.join(work, "serve_child.log")
    with open(child_log, "w") as out:
        child = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
                 f"sys.exit(chip_smoke.serve_cli_child({work!r}))")
        cli = subprocess.Popen([sys.executable, "-c", child], cwd=work, env=env, stdout=out,
                               stderr=subprocess.STDOUT, start_new_session=True)
    try:
        launches, n_reads = serve_at_scale(manifest, work)
        serve_card_cpu()
        daemon_shed()
        rc = cli.wait(timeout=900)
    finally:
        if cli.poll() is None:
            os.killpg(cli.pid, signal.SIGKILL)
            cli.wait()
    with open(child_log) as f:
        child_text = f.read()
    for line in child_text.splitlines():
        if line.startswith("serve cli"):
            log(line)
    check(rc == 0, f"the serve command's child exited {rc}: {child_text[-2000:]}")
    with open(os.path.join(work, "serve_cli.json")) as f:
        cli_out = json.load(f)
    log("serve cli " + json.dumps(cli_out))
    log(f"serve cli: host only (CUDA_VISIBLE_DEVICES empty; the command takes no --device and "
        f"runs no kernel), {cli_out.get('reads_routed')} reads routed in "
        f"{cli_out.get('seconds')} s of routing ({cli_out.get('routed_reads_per_sec')} reads/s)")
    check(cli_out.get("reads_routed", 0) + cli_out.get("reads_unavailable", 0) == n_reads,
          f"the serve command routed {cli_out.get('reads_routed')} + refused "
          f"{cli_out.get('reads_unavailable')} reads; 10a saw {n_reads}")
    check(cli_out.get("latency_p99_ms_last") is not None
          and cli_out.get("hotspot_windows", 0) >= 1, f"the serve command's digest {cli_out}")
    return launches


def serve_cli_child(work) -> int:
    """10b's child process: 10a's manifest and flash-crowd log written as a
    CSV manifest and a ``.cdrsb`` log, then ``python -m cdrs_tpu_torch
    serve`` over them, its JSON digest into ``serve_cli.json``."""
    from cdrs_tpu_torch import GeneratorConfig
    from cdrs_tpu_torch.sim.generator import generate_population

    t0 = time.perf_counter()
    manifest = generate_population(GeneratorConfig(n_files=MAIN_FILES, seed=MAIN_SEED))
    events, _ = flash_crowd_events(manifest)
    man_path, log_path = os.path.join(work, "serve_m.csv"), os.path.join(work, "serve.cdrsb")
    manifest.write_csv(man_path)
    events.write_binary(log_path, manifest)
    log(f"serve cli inputs: manifest csv {os.path.getsize(man_path)} B, log "
        f"{os.path.getsize(log_path)} B, generated and written in "
        f"{time.perf_counter() - t0:.3f} s")
    del manifest, events
    t0 = time.perf_counter()
    with open(os.path.join(work, "serve_cli.json"), "w") as out:
        rc = subprocess.run([sys.executable, "-m", "cdrs_tpu_torch", "serve", "--manifest",
                             man_path, "--access_log", log_path, "--window_seconds",
                             str(CONTROL_WINDOW), "--policy", "p2c"], cwd=work, stdout=out,
                            timeout=900).returncode
    log(f"serve cli command: exit {rc}, {time.perf_counter() - t0:.3f} s with start-up and "
        f"the manifest parse, alongside 10a, 10c and 10d")
    return rc


def serve_at_scale(manifest, work):
    """10a; returns the kernels' launches and the reads the windows saw."""
    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count

    t0 = time.perf_counter()
    events, n_cohort = flash_crowd_events(manifest)
    sim_s = time.perf_counter() - t0
    log(f"serve workload: {len(manifest)} files, {len(events)} events with a flash crowd of "
        f"{n_cohort} hot files x{SERVE_BOOST:g} over [{SERVE_BURST[0]:g} s, "
        f"{SERVE_BURST[0] + SERVE_BURST[1]:g} s); simulate {sim_s:.3f} s")
    config = lambda: serve_config("cuda", drift_threshold=SERVE_DRIFT_THRESHOLD)  # noqa: E731
    ck = os.path.join(work, "serve_killed.npz")
    with deterministic():
        ctl = ReplicationController(manifest, config())
        seen = watch_reclusters(ctl)
        save = ctl.save_checkpoint

        def save_and_keep(path, *args, **kw):
            save(path, *args, **kw)
            if ctl.window_index == CONTROL_KILL_AFTER + 1:
                shutil.copyfile(path, ck)

        ctl.save_checkpoint = save_and_keep
        prof: dict = {}
        profile_phases(ctl, SERVE_PROFILED_WINDOW, prof)
        lloyd_assign_reduce.launches = 0
        label_threshold_count.launches = 0
        t0 = time.perf_counter()
        full = ctl.run(events, checkpoint_path=os.path.join(work, "serve_full.npz"))
        wall = time.perf_counter() - t0
        launches = {"lloyd": lloyd_assign_reduce.launches,
                    "seg_count": label_threshold_count.launches}
    recs = full.records
    triggers = [r["recluster_trigger"] for r in recs]
    drifts = [r["drift"] for r in recs]
    log(f"serve control: {len(recs)} windows of {CONTROL_WINDOW:g} s; wall {wall:.3f} s "
        f"(checkpoints included); re-cluster triggers {triggers}, modes "
        f"{[r['recluster_mode'] for r in recs]}, drift scores {drifts} (threshold "
        f"{SERVE_DRIFT_THRESHOLD:g}), Lloyd iterations {[c['n_iter'] for c in seen]}, "
        f"launches {launches}")
    for r in recs:
        log("serve window " + json.dumps(
            {k: r.get(k) for k in ("window", "n_events", "n_reads", "drift", "hotspot_score",
                                   "recluster_trigger", "recluster_mode", "reads_routed",
                                   "reads_unavailable", "serve_locality", "latency_p50_ms",
                                   "latency_p95_ms", "latency_p99_ms", "utilization_max",
                                   "slo_burn", "moves_applied", "causes", "plan_hash",
                                   "seconds")}
            | {"hotspot_files_head": (r.get("hotspot_files") or [])[:3]}))
    per_stage = {st: sum(r["seconds"].get(st, 0.0) for r in recs) / len(recs)
                 for st in SERVE_STAGES}
    log("serve stages mean seconds per window " + json.dumps(per_stage))
    summary = full.summary()
    log("serve summary " + json.dumps(summary))
    log("serve profile " + json.dumps(prof))
    check("hotspot" in triggers, f"no hotspot re-cluster in 10a: triggers {triggers}")
    check(triggers[0] == "cold" and all(t in (None, "hotspot") for t in triggers[1:]),
          f"10a re-clustered on {triggers}, expected the cold start and hotspots only")
    check(max((d for d in drifts if d is not None), default=0.0) < SERVE_DRIFT_THRESHOLD,
          "a drift score reached 10a's threshold")
    check(len(seen) == sum(t is not None for t in triggers),
          f"10a: {len(seen)} model runs for {sum(t is not None for t in triggers)} re-clusters")
    want_lloyd = sum(c["n_iter"] + 1 for c in seen)
    check(launches["lloyd"] == want_lloyd,
          f"10a made {launches['lloyd']} Lloyd launches, expected {want_lloyd}")
    check(launches["seg_count"] == 12 * len(seen),
          f"10a made {launches['seg_count']} threshold-count launches, expected "
          f"{12 * len(seen)}")
    sd = summary.get("serve") or {}
    check(sd.get("windows") == len(recs) and sd.get("reads_routed", 0) > 0
          and sd.get("hotspot_reclusters", 0) >= 1 and sd.get("latency_p99_ms_max") is not None
          and math.isfinite(sd["latency_p99_ms_max"]), f"10a serve digest {sd}")
    check(all({"hotspot", "serve"} <= set(r["seconds"]) for r in recs if r["n_events"]),
          "a 10a window lacks its hotspot or serve seconds")
    check(all(r["reads_routed"] + r["reads_unavailable"] == r["n_reads"] for r in recs),
          "10a routed and refused reads do not add up to the window's reads")
    check(prof.get("window") == SERVE_PROFILED_WINDOW and prof.get("trigger") == "hotspot",
          f"the profiled window is not the hotspot window: {prof.get('window')} "
          f"{prof.get('trigger')}")

    check(os.path.exists(ck), "no snapshot after window 3")
    with deterministic():
        rest_ctl = ReplicationController(manifest, config())
        rest_ctl.load_checkpoint(ck)
        rest = rest_ctl.run(events)
    check(strip_seconds(rest.records) == strip_seconds(recs[CONTROL_KILL_AFTER + 1:]),
          "10a kill/resume records differ from the uninterrupted run's")
    check(rest_ctl._hotspot.ewma.tobytes() == ctl._hotspot.ewma.tobytes(),
          "10a kill/resume hotspot baseline differs from the uninterrupted run's")
    log(f"serve kill/resume: killed after window {CONTROL_KILL_AFTER}, resumed; records "
        f"identical apart from seconds in windows {[r['window'] for r in rest.records]}, "
        f"serve_ewma identical ({len(manifest)} float64)")
    return launches, sum(r["n_reads"] for r in recs)


def _records_match(got, want, what):
    """Every record equal but ``seconds``, drift scalars within 1e-6."""
    check(len(got) == len(want) > 0, f"{what}: {len(got)} vs {len(want)} records")
    drift_keys = ("drift", "centroid_shift", "population_delta")
    for g, w in zip(got, want):
        check(set(g) == set(w), f"{what} window {w['window']}: keys {set(g) ^ set(w)}")
        for key in w:
            if key == "seconds":
                continue
            if key in drift_keys and w[key] is not None:
                check(abs(g[key] - w[key]) <= 1e-6, f"{what} window {w['window']}: {key} "
                      f"{g[key]} vs {w[key]}")
            else:
                check(g[key] == w[key], f"{what} window {w['window']}: {key} {g[key]} vs "
                      f"{w[key]}")


def serve_card_cpu():
    """10c: phase 4's workload on 6 nodes in 3 racks, the serving chaos
    controller on the card and on the CPU from one init."""
    import numpy as np

    from cdrs_tpu_torch.cluster.placement import ClusterTopology
    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.serve import ServeConfig

    nodes = tuple(f"dn{i}" for i in range(1, 7))
    manifest, events = _phase4_workload(nodes)
    topo = ClusterTopology.from_rack_spec(nodes, SERVE_RACKS)
    for shape, specs in (("serve-chaos", ["partition:dn2@1-3", "degrade:dn3@1-4:0.25"]),
                         ("integrity-read", ["corrupt:dn2@1:0.5"])):
        runs = {}
        for dev in ("cuda", "cpu"):
            ctl = ReplicationController(manifest, chaos_config(
                dev, specs, topology=topo, serve=ServeConfig(policy="p2c", verify_reads=True)))
            watch_reclusters(ctl, cpu_init)
            runs[dev] = (ctl, ctl.run(events))
        (ctl_c, res_c), (ctl_p, res_p) = runs["cuda"], runs["cpu"]
        recs = res_c.records
        log(f"serve {shape} at {len(manifest)} files on 6 nodes in 3 racks, {specs}: p99 ms "
            f"{[r['latency_p99_ms'] for r in recs]}, unavailable "
            f"{[r['reads_unavailable'] for r in recs]}, detected_read "
            f"{[r['integrity']['detected_read'] for r in recs if 'integrity' in r]}, "
            f"plan hashes {[r['plan_hash'] for r in recs]}")
        _records_match(recs, res_p.records, f"10c {shape} card vs cpu")
        got, want = ctl_c._cluster_state.state_arrays(), ctl_p._cluster_state.state_arrays()
        check(set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want),
              f"10c {shape}: final state_arrays differ between the card and the CPU")
        check(ctl_c._hotspot.ewma.tobytes() == ctl_p._hotspot.ewma.tobytes(),
              f"10c {shape}: serve_ewma differs between the card and the CPU")
        if shape == "integrity-read":
            check(sum(r["integrity"]["detected_read"] for r in recs) > 0,
                  "10c: the reads detected no rot")
        else:
            p99 = [r["latency_p99_ms"] for r in recs]
            check(recs[1]["fault_events"] and max(p99[1:5]) > p99[0],
                  f"10c: the partition and the straggler changed nothing (p99 ms {p99})")
        log(f"serve {shape} card vs cpu: every record (drift within 1e-6), state_arrays and "
            f"serve_ewma equal in all {len(recs)} windows")


def daemon_shed():
    """10d: phase 4's workload through the serving daemon with the brownout
    ladder forced up (burn trip wire 0), then the same windows through a
    controller under the same ``serve_shed``."""
    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.daemon import BrownoutConfig, DaemonConfig, StreamDaemon
    from cdrs_tpu_torch.daemon.brownout import RUNGS
    from cdrs_tpu_torch.device import deterministic

    manifest, events = _phase4_workload()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "shed.cdrsb")
        events.write_binary(path, manifest)
        ctl = ReplicationController(manifest, serve_config("cuda"))
        watch_reclusters(ctl, cpu_init)
        calls = []
        decide = ctl.process_window

        def captured(w, ev):
            calls.append((w, ev, ctl.serve_shed))
            return decide(w, ev)

        ctl.process_window = captured
        daemon = StreamDaemon(ctl, DaemonConfig(brownout=BrownoutConfig(burn_engage=0.0)))
        dig = daemon.run(path)
    recs = daemon.records
    replay = ReplicationController(manifest, serve_config("cuda"))
    watch_reclusters(replay, cpu_init)
    want = []
    with deterministic():
        for w, ev, shed in calls:
            replay.serve_shed = shed
            want.append(replay.process_window(w, ev))
    shed_recs = [r for r in recs if r["daemon"]["brownout_level"] == len(RUNGS)]
    log(f"serve daemon shed at {len(manifest)} files: {len(recs)} decisions, levels "
        f"{[r['daemon']['brownout_level'] for r in recs]}, coalesced "
        f"{[r['daemon']['coalesced'] for r in recs]}, reads {[r['n_reads'] for r in recs]}, "
        f"shed {[r.get('reads_shed') for r in recs]}, digest reads_shed "
        f"{dig['brownout']['reads_shed']}")
    check(len(shed_recs) >= 1, "the ladder never reached shed_reads")
    check(all("reads_shed" in r for r in recs[1:]), "a window after the first lacks reads_shed")
    check(all(0 < r["reads_shed"] < r["n_reads"] for r in recs[1:] if r["n_reads"] > 100),
          "a shed window shed no read or every read")
    check(dig["brownout"]["reads_shed"] == sum(r.get("reads_shed", 0) for r in recs) > 0,
          "the digest's reads_shed is not the records' sum")
    _records_match([{k: v for k, v in r.items() if k != "daemon"} for r in recs], want,
                   "10d daemon vs controller")
    log(f"serve daemon shed: every record equal to a controller's over the same "
        f"{len(calls)} windows under the same serve_shed")


def placement_config(device: str, mode: str = "functional", window: float = PLACEMENT_WINDOW):
    """Phase 8's settings (rf >= 2, 250,000 files a window, drift threshold
    0) on the region-loss preset's geo topology, its storage
    (``ec_archival``) and p2c serving, with placement ``mode`` and region eu
    crashed from window 2."""
    import dataclasses

    from cdrs_tpu_torch.cluster.placement import ClusterTopology
    from cdrs_tpu_torch.scenarios import preset
    from cdrs_tpu_torch.serve import ServeConfig
    from cdrs_tpu_torch.storage import resolve_storage_config

    spec = preset("region-loss")
    cfg = chaos_config(device, [PLACEMENT_CRASH],
                       topology=ClusterTopology.from_hierarchy(spec.topology),
                       placement_mode=mode, serve=ServeConfig(policy="p2c"),
                       window_seconds=window)
    return dataclasses.replace(cfg, storage=resolve_storage_config(spec.storage, cfg.scoring))


def rss_gib() -> float:
    """This process's resident set (VmRSS) in GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


class PeakRss:
    """The largest VmRSS sampled every ``interval`` seconds by a thread while
    the ``with`` block runs (``peak``, GiB)."""

    def __init__(self, interval: float = 0.25):
        import threading

        self.interval = interval
        self.peak = rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self):
        while not self._stop.wait(self.interval):
            self.peak = max(self.peak, rss_gib())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_gib())


def dense_arrays(state, n_files: int) -> list:
    """Attributes of ``state`` holding n_files x n_nodes elements or more."""
    import numpy as np

    big = n_files * len(state.nodes)
    return [k for k, v in vars(state).items() if isinstance(v, np.ndarray) and v.size >= big]


def start_child(work, name: str):
    """Start ``chip_smoke.<name>_child(work)`` in a child process, one
    thread per math library so that it shares the host with this one.
    Returns the child, its log's path and its start time."""
    threads = {k: "1" for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")}
    child_log = os.path.join(work, f"{name}_child.log")
    with open(child_log, "w") as out:
        child = subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
             f"sys.exit(chip_smoke.{name}_child({work!r}))"],
            cwd=work, env=dict(os.environ, PYTHONPATH=ROOT, **threads), stdout=out,
            stderr=subprocess.STDOUT, start_new_session=True)
    return child, child_log, time.perf_counter()


def stop_child(child) -> None:
    """Kill the child's process group if it still runs."""
    if child is not None and child.poll() is None:
        os.killpg(child.pid, signal.SIGKILL)
        child.wait()


def placement_child(work) -> int:
    """The child's body: 12a and 12c, whose result goes to
    ``placement.json`` in ``work``."""
    result = placement_at_scale()
    with open(os.path.join(work, "placement.json"), "w") as f:
        json.dump(result, f)
    return 0


def join_child(child, child_log, t_child, work, name: str, phases: str):
    """Wait for the child, relay its log and return its result (the JSON it
    wrote to ``<name>.json`` in ``work``)."""
    rc = child.wait(timeout=1200)
    with open(child_log) as f:
        child_text = f.read()
    for line in child_text.splitlines():
        log(line)
    check(rc == 0, f"phase {phases}'s child exited {rc}: {child_text[-3000:]}")
    with open(os.path.join(work, f"{name}.json")) as f:
        result = json.load(f)
    log(f"phase {phases}: {time.perf_counter() - t_child:.1f} s in the child")
    return result


def placement_kernels():
    """B1 (as the Lloyd loop and the label pass call it), B2 and one whole
    bisection against their plain versions at 12a's re-cluster shape: a
    10,000,000 x 5 table, k = 8, every row valid.  Returns the largest
    error of each kernel."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    n = PLACEMENT_FILES
    lloyd = [check_lloyd(name, n, 5, K, torch.float32, n, 3, gen, with_labels=labels)
             for name, labels in (("placement", False), ("placement-labels", True))]
    seg = check_seg("placement", n, 5, K, 3, gen)
    # The child runs one thread a math library: the plain counts run on the card.
    check_bisect(n, 5, K, gen, plain_on="cuda")
    return {"lloyd": max(r["max_abs_err"] for r in lloyd), "seg_count": seg["max_abs_err"]}


def placement_at_scale():
    """Phase 12a, functional placement at 10,000,000 files, then 12c, the
    epoch diff over its population.  Returns the kernels' launches in 12a
    and their errors at its shape."""
    import gc

    import numpy as np
    import torch

    from cdrs_tpu_torch import GeneratorConfig, SimulatorConfig
    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count
    from cdrs_tpu_torch.sim.access import simulate_access
    from cdrs_tpu_torch.sim.generator import generate_population

    errors = placement_kernels()
    t0 = time.perf_counter()
    manifest = generate_population(GeneratorConfig(n_files=PLACEMENT_FILES, seed=MAIN_SEED,
                                                   nodes=STORAGE_NODES))
    t_gen = time.perf_counter() - t0
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=PLACEMENT_SPAN,
                                                       seed=MAIN_SEED + 1))
    n = len(manifest)
    log(f"placement workload: {n} files on {len(STORAGE_NODES)} nodes in 3 regions, "
        f"{len(events)} events over {PLACEMENT_SPAN:g} s; gen {t_gen:.3f} s, simulate "
        f"{time.perf_counter() - t0 - t_gen:.3f} s; host RSS {rss_gib():.3f} GiB")

    with tempfile.TemporaryDirectory() as tmp, deterministic(), PeakRss() as rss:
        t0 = time.perf_counter()
        ctl = ReplicationController(manifest, placement_config("cuda"))
        t_build = time.perf_counter() - t0
        cs = ctl._cluster_state
        n_nodes = len(cs.nodes)
        check(type(cs).__name__ == "OverlayClusterState" and not dense_arrays(cs, n)
              and "replica_map" not in vars(cs),
              f"12a: the functional state holds a dense array: {dense_arrays(cs, n)}")
        seen = watch_reclusters(ctl)
        prof: dict = {}
        profile_phases(ctl, PLACEMENT_PROFILED_WINDOW, prof)
        ck = os.path.join(tmp, "killed.npz")
        save = ctl.save_checkpoint

        def save_and_keep(path, *args, **kw):
            save(path, *args, **kw)
            if ctl.window_index == PLACEMENT_KILL_AFTER + 1:
                shutil.copyfile(path, ck)

        ctl.save_checkpoint = save_and_keep
        lloyd_assign_reduce.launches = 0
        label_threshold_count.launches = 0
        t0 = time.perf_counter()
        full = ctl.run(events, checkpoint_path=os.path.join(tmp, "full.npz"))
        wall = time.perf_counter() - t0
        launches = {"lloyd": lloyd_assign_reduce.launches,
                    "seg_count": label_threshold_count.launches}
        peak = rss.peak
        recs = full.records
        log(f"placement: functional, ec_archival, p2c, {len(recs)} windows of "
            f"{PLACEMENT_WINDOW:g} s, {PLACEMENT_CRASH}; state built in {t_build:.3f} s; wall "
            f"{wall:.3f} s (checkpoints included), re-clusters "
            f"{[r['recluster_mode'] for r in recs]}, Lloyd iterations "
            f"{[c['n_iter'] for c in seen]}, launches {launches}")
        for r in recs:
            log("placement window " + json.dumps(
                {"window": r["window"], "fault_events": r["fault_events"],
                 "nodes_up": r["nodes_up"], "moves_applied": r["moves_applied"],
                 "repair_moves": r["repair_moves"], "repair_backlog": r["repair_backlog"],
                 "lost": r["durability"]["lost"], "at_risk": r["durability"]["at_risk"],
                 "under_replicated": r["durability"]["under_replicated"],
                 "regions_reachable": r["durability"]["regions_reachable"],
                 "placement": r["placement"], "ec_files": r["storage"]["ec_files"],
                 "reads": r.get("reads_routed"), "p99_ms": r.get("latency_p99_ms"),
                 "seconds": r["seconds"]}))
        per_stage = {st: sum(r["seconds"].get(st, 0.0) for r in recs) / len(recs)
                     for st in PLACEMENT_STAGES}
        log("placement stages mean seconds per window " + json.dumps(per_stage))
        dense_bytes = n * n_nodes * 5
        ckpts = [{"window": c["window"], "bytes": int(c["bytes"]),
                  "seconds": round(float(c["seconds"]), 3)} for c in ctl.checkpoint_log]
        exc = [r["placement"]["exceptions"] for r in recs]
        sparse = cs.state_arrays(rf_hint=ctl.current_rf)
        fn_bytes = sum(int(v.nbytes) for k, v in sparse.items() if k.startswith("fault_fn"))
        log("placement checkpoint " + json.dumps(
            {"exceptions": exc, "checkpoints": ckpts, "sparse_placement_bytes": fn_bytes,
             "dense_map_and_rot_bytes": dense_bytes,
             "peak_host_rss_gib_sampled": round(peak, 3)}))
        log("placement summary " + json.dumps(full.summary()))
        log("placement profile " + json.dumps(prof))
        want_lloyd = sum(c["n_iter"] + 1 for c in seen)
        check(len(recs) == int(PLACEMENT_SPAN / PLACEMENT_WINDOW),
              f"12a ran {len(recs)} windows")
        check(len(seen) == len(recs), f"12a: {len(seen)} re-clusters for {len(recs)} windows")
        check(launches["lloyd"] == want_lloyd,
              f"12a made {launches['lloyd']} Lloyd launches, expected {want_lloyd}")
        check(launches["seg_count"] == 12 * len(seen),
              f"12a made {launches['seg_count']} threshold-count launches, expected "
              f"{12 * len(seen)}")
        check(recs[2]["fault_events"] == [f"crash:dn{i}@2" for i in range(1, 5)],
              f"window 2's fault events are {recs[2]['fault_events']}")
        check(all(r["nodes_up"] == 8 and r["repair_moves"] > 0 for r in recs[2:]),
              "12a: region eu not down, or no repair, from window 2")
        check(all(r["durability"]["lost"] == 0 for r in recs), "12a lost files")
        check(all(r["placement"]["mode"] == "functional" for r in recs) and exc[-1] > 0,
              f"12a placement stamps {[r['placement'] for r in recs]}")
        check(fn_bytes < dense_bytes and not dense_arrays(cs, n),
              f"12a: sparse placement {fn_bytes} bytes against the dense {dense_bytes}, "
              f"dense arrays {dense_arrays(cs, n)}")
        check(prof.get("window") == PLACEMENT_PROFILED_WINDOW
              and prof.get("lloyd_launches_seen", 0) > 0, f"12a profile: {prof}")

        check(os.path.exists(ck), f"no snapshot after window {PLACEMENT_KILL_AFTER}")
        # The full run's controller goes before the resume builds another.
        shards = cs.installed_shards.copy()
        del ctl, cs, prof
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rest_ctl = ReplicationController(manifest, placement_config("cuda"))
        rest = rest_ctl.run(events, checkpoint_path=ck)
        t_resume = time.perf_counter() - t0
        check(strip_seconds(rest.records) == strip_seconds(recs[PLACEMENT_KILL_AFTER + 1:]),
              "12a kill/resume records differ from the uninterrupted run's")
        got = rest_ctl._cluster_state.state_arrays(rf_hint=rest_ctl.current_rf)
        check(set(got) == set(sparse) and all(np.array_equal(got[k], sparse[k]) for k in sparse),
              "12a kill/resume sparse state_arrays() differ from the full run's")
        check(np.array_equal(rest.rf, full.rf) and np.array_equal(rest.category_idx,
                                                                  full.category_idx),
              "12a kill/resume final plan differs")
        log(f"placement kill/resume: killed after window {PLACEMENT_KILL_AFTER}, resumed in "
            f"{t_resume:.3f} s (state built, snapshot loaded, the rest run); records (plan "
            f"hashes included) identical apart from seconds in windows "
            f"{[r['window'] for r in rest.records]}; sparse state_arrays identical")
    del events, rest_ctl
    placement_epoch_diff(manifest, shards)
    return {"launches": launches, "max_abs_err": errors}


def placement_epoch_diff(manifest, shards):
    """12c: ``EpochMap.diff`` at 10,000,000 files: a removal pruned against
    the full compare, the same epoch, and an addition of the standby pool
    against the full compare."""
    import numpy as np

    from cdrs_tpu_torch.cluster.placement import ClusterTopology, primary_on_topology
    from cdrs_tpu_torch.control.elastic import ElasticPolicy
    from cdrs_tpu_torch.placement_fn.epoch import EpochMap, addition_moved
    from cdrs_tpu_torch.scenarios import preset

    spec = preset("region-loss").topology
    topo = ClusterTopology.from_hierarchy(spec)
    cut = {**spec, "nodes": [x for x in spec["nodes"] if x != PLACEMENT_REMOVED],
           "rack": {r: [x for x in m if x != PLACEMENT_REMOVED] for r, m in spec["rack"].items()}}
    pol = ElasticPolicy(pool=PLACEMENT_POOL)
    grown = pol.grown_topology(topo, pol.next_activation(()))
    emap = EpochMap(manifest.nodes, topo, seed=0)
    emap.advance(ClusterTopology.from_hierarchy(cut))
    emap.advance(grown)
    pid = manifest.primary_node_id
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = round(time.perf_counter() - t0, 3)
        return out

    same = timed("same_epoch", lambda: emap.diff(0, 0, shards, pid))
    pruned = timed("removal_pruned", lambda: emap.diff(0, 1, shards, pid))
    full = timed("removal_full", lambda: emap.diff(0, 1, shards, pid, prune=False))
    prim = primary_on_topology(manifest.nodes, pid, topo)
    added = timed("addition_moved", lambda: addition_moved(topo, grown, shards, prim, 0))
    add_full = timed("addition_full", lambda: emap.diff(0, 2, shards, pid, prune=False))
    log("placement epoch diff " + json.dumps(
        {"files": len(manifest), "same_epoch_moves": len(same),
         "removed": PLACEMENT_REMOVED, "removal_moves": len(pruned),
         "removal_checked_pruned": pruned.n_checked, "removal_checked_full": full.n_checked,
         "added": [e["name"] for e in PLACEMENT_POOL], "addition_moves": int(added.size),
         "host_seconds": secs}))
    check(len(same) == 0, "12c: the same epoch moves files")
    check(pruned.pruned and not full.pruned and len(pruned) > 0
          and np.array_equal(np.sort(pruned.moved), np.sort(full.moved))
          and pruned.n_checked < full.n_checked,
          "12c: the pruned removal diff differs from the full compare")
    check(added.size > 0 and np.array_equal(added, add_full.moved),
          "12c: addition_moved differs from the full compare")


def placement_small():
    """12b: phase 4's workload on the same topology and settings: functional
    against its oracle (materialized_hash) on the card, and the card against
    the CPU, from one carried init."""
    import numpy as np

    from cdrs_tpu_torch.control.controller import ReplicationController

    manifest, events = _phase4_workload(STORAGE_NODES)
    runs = {}
    for dev, mode in (("cuda", "functional"), ("cuda", "materialized_hash"),
                      ("cpu", "functional")):
        ctl = ReplicationController(manifest, placement_config(dev, mode))
        watch_reclusters(ctl, cpu_init)
        runs[dev, mode] = (ctl, ctl.run(events))
    (fn_ctl, fn), (orc_ctl, orc), (cpu_ctl, cpu) = runs.values()
    drop = ("seconds", "placement")
    check([{k: v for k, v in r.items() if k not in drop} for r in fn.records]
          == [{k: v for k, v in r.items() if k not in drop} for r in orc.records],
          "12b: functional records differ from the materialized_hash oracle's")
    # The oracle's rows as the sparse snapshot the functional state writes.
    orc_cs = orc_ctl._cluster_state
    orc_cs._fn_sparse = True
    want = orc_cs.state_arrays(rf_hint=orc_ctl.current_rf)
    got = fn_ctl._cluster_state.state_arrays(rf_hint=fn_ctl.current_rf)
    check(set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want),
          "12b: functional state_arrays differ from the oracle's")
    _records_match(fn.records, cpu.records, "12b functional card vs cpu")
    got_cpu = cpu_ctl._cluster_state.state_arrays(rf_hint=cpu_ctl.current_rf)
    check(all(np.array_equal(got[k], got_cpu[k]) for k in got),
          "12b: state_arrays differ between the card and the CPU")
    check(all(r["durability"]["lost"] == 0 for r in fn.records) and
          fn.records[-1]["placement"]["exceptions"] > 0, "12b: files lost, or no exception")
    log(f"placement 20k: functional = materialized_hash in every record and in the sparse "
        f"state_arrays; card = CPU (drift within 1e-6); plan hashes "
        f"{[r['plan_hash'] for r in fn.records]}; exceptions "
        f"{[r['placement']['exceptions'] for r in fn.records]}")


def placement_memo():
    """12d: 12a at 5,000 files (the same settings, 4 windows of 5 s, the
    crash from window 2) with the functional state's single-row memo on and
    off: the same records either way, and the host seconds of the stages
    that loop over files one at a time."""
    from cdrs_tpu_torch import GeneratorConfig, SimulatorConfig
    from cdrs_tpu_torch.control.controller import ReplicationController
    from cdrs_tpu_torch.placement_fn import state as fn_state
    from cdrs_tpu_torch.sim.access import simulate_access
    from cdrs_tpu_torch.sim.generator import generate_population

    manifest = generate_population(GeneratorConfig(n_files=PLACEMENT_MEMO_FILES,
                                                   seed=MAIN_SEED, nodes=STORAGE_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=PLACEMENT_SPAN,
                                                       seed=MAIN_SEED + 1))
    runs = {}
    memo_max = fn_state._MEMO_MAX
    try:
        for label, limit in (("on", memo_max), ("off", 0)):
            fn_state._MEMO_MAX = limit
            ctl = ReplicationController(manifest, placement_config("cuda"))
            watch_reclusters(ctl, cpu_init)
            t0 = time.perf_counter()
            res = ctl.run(events)
            runs[label] = (res.records, time.perf_counter() - t0)
    finally:
        fn_state._MEMO_MAX = memo_max
    check(strip_seconds(runs["on"][0]) == strip_seconds(runs["off"][0]),
          "12d: the records differ with the memo off")
    out = {"files": len(manifest), "windows": len(runs["on"][0]),
           "moves_applied": sum(r["moves_applied"] for r in runs["on"][0]),
           "repair_moves": sum(r["repair_moves"] for r in runs["on"][0])}
    for label, (recs, wall) in runs.items():
        out[label] = {"wall": round(wall, 3), **{
            st: round(sum(r["seconds"].get(st, 0.0) for r in recs), 3)
            for st in ("repair", "schedule", "total")}}
    log("placement memo " + json.dumps(out))


def run_cli(argv):
    """``cdrs_tpu_torch.cli.main(argv)`` in this process; returns (exit code,
    its standard output, host seconds)."""
    import contextlib
    import io

    from cdrs_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(list(argv))
    return rc, buf.getvalue(), time.perf_counter() - t0


def reset_launches() -> None:
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count

    lloyd_assign_reduce.launches = 0
    label_threshold_count.launches = 0


def read_launches() -> dict:
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce
    from cdrs_tpu_torch.ops.seg_count import label_threshold_count

    return {"lloyd": lloyd_assign_reduce.launches, "seg_count": label_threshold_count.launches}


def device_args(device: str) -> list:
    """No ``--device`` on the card: the commands' default is CUDA."""
    return [] if device == "cuda" else ["--device", device]


def batch_manifest_csv(manifest, work) -> str:
    """13a's first stage: phase 5's manifest written as ``metadata.csv`` in
    ``work``, which 13a's commands read.  Returns its path."""
    m_csv = os.path.join(work, "metadata.csv")
    t0 = time.perf_counter()
    manifest.write_csv(m_csv)
    log(f"batch manifest csv: {len(manifest)} files in {time.perf_counter() - t0:.3f} s")
    return m_csv


def batch_staged(m_csv, log_path, work, device="cuda"):
    """13a: ``features``, ``cluster`` and ``evaluate`` through ``cli.main``
    over the manifest CSV and the ``.cdrsb`` log.  Returns the kernels'
    launches in ``cluster`` and the feature matrix it read."""
    import numpy as np
    import torch

    from cdrs_tpu_torch import KMeansConfig, validated_scoring_config
    from cdrs_tpu_torch.cluster.evaluate import compare_policies
    from cdrs_tpu_torch.cluster.placement import ClusterTopology
    from cdrs_tpu_torch.config import CATEGORIES
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.io.events import EventLog, Manifest
    from cdrs_tpu_torch.io.features import load_feature_matrix
    from cdrs_tpu_torch.models.replication import ReplicationPolicyModel

    d = os.path.join(work, "batch")
    os.makedirs(d, exist_ok=True)
    feats = os.path.join(d, "features_out") + os.sep
    cats, assign = os.path.join(d, "final_categories.csv"), os.path.join(d, "assignments.csv")
    plan, setrep = os.path.join(d, "plan.csv"), os.path.join(d, "apply.sh")
    secs = {}
    # The manifest as the commands read it: its node vocabulary is in order
    # of first appearance, which sets evaluate's topology.
    t0 = time.perf_counter()
    manifest = Manifest.read_csv(m_csv)
    secs["manifest_read"] = time.perf_counter() - t0
    n = len(manifest)
    rc, _, secs["features"] = run_cli(["features", "--manifest", m_csv, "--access_log", log_path,
                                       "--out", feats, *device_args(device)])
    check(rc == 0, f"13a: features exited {rc}")
    seen, _, restore = model_runs()
    reset_launches()
    try:
        rc, _, secs["cluster"] = run_cli([
            "cluster", "--input_path", feats, "--k", str(K), "--seed", str(MAIN_SEED),
            "--medians_from_data", "--scoring_config", "validated", "--output_csv", cats,
            "--assignments_csv", assign, *device_args(device)])
    finally:
        restore()
    launches = read_launches()
    check(rc == 0, f"13a: cluster exited {rc}")
    if device == "cuda":
        check(launches["lloyd"] >= 1 and launches["seg_count"] >= 1,
              f"13a: cluster launched B1 {launches['lloyd']} and B2 {launches['seg_count']} times")
        check(launches["lloyd"] == seen[0] + 1 and launches["seg_count"] == 12,
              f"13a: cluster made {launches}, expected {seen[0]} + 1 Lloyd and 12 counts")
    # The model on the matrix that load_feature_matrix gives, in this process.
    t0 = time.perf_counter()
    X, paths = load_feature_matrix(feats)
    secs["load_matrix"] = time.perf_counter() - t0
    check(X.shape == (n, 5) and paths == manifest.paths, f"13a: feature matrix {X.shape}")
    scoring = validated_scoring_config()
    model = ReplicationPolicyModel(KMeansConfig(k=K, seed=MAIN_SEED), scoring)
    with deterministic():
        dec = model.run(torch.as_tensor(X, dtype=torch.float32).to(device))
    with open(assign, newline="") as f:
        rows = list(csv.reader(f))[1:]
    got_cat = np.asarray([r[2] for r in rows])
    want_cat = np.asarray(CATEGORIES)[dec.category_idx[dec.labels]]
    check(len(rows) == n and bool((got_cat == want_cat).all()),
          "13a: cluster's per-file categories differ from ReplicationPolicyModel.run's")
    with open(cats, newline="") as f:
        check([r[1] for r in list(csv.reader(f))[1:]] == dec.categories,
              "13a: final_categories.csv differs from ReplicationPolicyModel.run's")
    rf = dec.replication_factor_per_file(scoring)
    rc, out, secs["evaluate"] = run_cli([
        "evaluate", "--manifest", m_csv, "--access_log", log_path, "--assignments_csv", assign,
        "--scoring_config", "validated", "--emit_plan", plan, "--emit_setrep", setrep])
    check(rc == 0, f"13a: evaluate exited {rc}")
    t0 = time.perf_counter()
    events = EventLog.read_csv(log_path, manifest)
    want = compare_policies(manifest, events, rf,
                            topology=ClusterTopology(nodes=tuple(manifest.nodes)))
    secs["compare_in_process"] = time.perf_counter() - t0
    check(json.loads(out) == json.loads(json.dumps(want)),
          "13a: evaluate's JSON differs from compare_policies in process")
    with open(plan) as f:
        plan_rows = sum(1 for _ in f) - 1
    with open(setrep) as f:
        setrep_cmds = sum(1 for line in f if line.startswith("hdfs dfs -setrep"))
    check(plan_rows == n, f"13a: the plan has {plan_rows} rows for {n} files")
    log("batch staged " + json.dumps({
        "files": n, "events": len(events), "seconds": {k: round(v, 3) for k, v in secs.items()},
        "b1_launches": launches["lloyd"], "b2_launches": launches["seg_count"],
        "n_iter": seen[0], "categories": dec.categories, "plan_rows": plan_rows,
        "setrep_commands": setrep_cmds, "nodes": manifest.nodes,
        "read_locality": {k: round(v["read_locality"], 6) for k, v in want.items()},
        "feature_csv_bytes": os.path.getsize(os.path.join(feats, "part-00000-features.csv"))}))
    return launches, X


def batch_pipeline_card_cpu(work):
    """13a: ``pipeline --evaluate`` at 20,000 files on the card and on the
    CPU, both from the cold init computed on the CPU: the same evaluation."""
    outs = {}
    _, hooks, restore = model_runs()
    hooks["init_fn"] = cpu_model_init
    try:
        for dev in ("cuda", "cpu"):
            rc, out, sec = run_cli([
                "pipeline", "--n", str(BATCH_EVAL_FILES), "--k", str(K), "--seed",
                str(MAIN_SEED), "--duration_seconds", str(MAIN_DURATION), "--scoring_config",
                "validated", "--evaluate", "--outdir", os.path.join(work, f"pipeline_{dev}"),
                *device_args(dev)])
            check(rc == 0, f"13a: pipeline --evaluate on {dev} exited {rc}")
            outs[dev] = (json.loads(out), sec)
    finally:
        restore()
    (card, t_card), (cpu, t_cpu) = outs["cuda"], outs["cpu"]
    check(card["evaluation"] == cpu["evaluation"],
          "13a: pipeline --evaluate's evaluation differs between the card and the CPU")
    log(f"batch pipeline --evaluate at {BATCH_EVAL_FILES} files: card = CPU evaluation "
        f"(policy read locality {card['evaluation']['policy']['read_locality']:.6f}, "
        f"load balance {card['evaluation']['policy']['load_balance']:.6f}); seconds card "
        f"{t_card:.3f}, cpu {t_cpu:.3f}, evaluate stage card "
        f"{card['evaluate.seconds']:.3f}")


class Killed(RuntimeError):
    """Raised by a wrapped ``save_state``: a process killed after a snapshot."""


def checkpointed_run(x, path, kill_blocks, **kw):
    """``kmeans_checkpointed`` killed after ``kill_blocks`` snapshots, then
    resumed; returns (the resumed result, B1 launches of both runs, host
    seconds of both runs)."""
    import cdrs_tpu_torch.utils.checkpoint as ckpt

    save, written = ckpt.save_state, []

    def dying(p, arrays, meta=None):
        out = save(p, arrays, meta)
        written.append(meta["iters_done"])
        if len(written) == kill_blocks:
            raise Killed(f"killed after block {kill_blocks}")
        return out

    reset_launches()
    t0 = time.perf_counter()
    ckpt.save_state = dying
    try:
        ckpt.kmeans_checkpointed(x, K, path, **kw)
        fail("13b: the checkpointed run was not killed")
    except Killed:
        pass
    finally:
        ckpt.save_state = save
    res = ckpt.kmeans_checkpointed(x, K, path, **kw)
    return res, read_launches()["lloyd"], time.perf_counter() - t0


def batch_checkpointed(X, work, device="cuda"):
    """13b: the Lloyd loop in blocks of ``BATCH_BLOCK_ITERS`` over 13a's
    matrix, killed after two blocks and resumed, against one uninterrupted
    ``kmeans_full`` under both label modes; then a shape whose reseeds fire
    in every iteration, across both block edges.  Returns B1's launches."""
    import torch

    from cdrs_tpu_torch.config import default_max_iter
    from cdrs_tpu_torch.ops.kmeans import kmeans_full
    from cdrs_tpu_torch.ops.lloyd import lloyd_assign_reduce

    x = torch.as_tensor(X, dtype=torch.float32).to(device)
    n = x.shape[0]
    total = 0

    def hold(name, x, want, it_want, **kw):
        nonlocal total
        path = os.path.join(work, f"lloyd_{name}.npz")
        for labels in ("final", "parity"):
            if os.path.exists(path):
                os.unlink(path)
            (c, lab, it), launches, sec = checkpointed_run(
                x, path, BATCH_KILL_BLOCKS, block_iters=BATCH_BLOCK_ITERS, labels=labels, **kw)
            total += launches
            blocks = -(-it // BATCH_BLOCK_ITERS)
            check(it == it_want and torch.equal(c, want[0])
                  and torch.equal(lab, want[1] if labels == "parity" else want[2]),
                  f"13b {name}: the resumed run ({labels} labels) differs from the "
                  f"uninterrupted one")
            if device == "cuda":
                check(launches == it + blocks + (labels == "final"),
                      f"13b {name}: {launches} Lloyd launches for {it} iterations in "
                      f"{blocks} blocks")
            log("batch checkpointed " + json.dumps({
                "case": name, "labels": labels, "rows": n, "iterations": it, "blocks": blocks,
                "killed_after_blocks": BATCH_KILL_BLOCKS, "b1_launches": launches,
                "seconds": round(sec, 3), "bit_identical": True}))

    max_iter = default_max_iter(n)
    c, lab, it, _ = kmeans_full(x, K, seed=MAIN_SEED, max_iter=max_iter)
    final = lloyd_assign_reduce(x, c, n, with_labels=True)[0]
    hold("main", x, (c, lab, final), it, seed=MAIN_SEED, max_iter=max_iter)
    # Three distinct rows and five centroids far outside them: every
    # iteration leaves at least five clusters empty, and reseeds them.
    few = x[:3][torch.arange(n, device=x.device) % 3].contiguous()
    init = torch.cat([x[:3].float(), 10.0 + torch.arange(5, device=x.device,
                                                          dtype=torch.float32)[:, None]
                      .expand(5, x.shape[1])])
    kw = dict(seed=MAIN_SEED, max_iter=12, tol=0.0, init_centroids=init)
    c, lab, it, _ = kmeans_full(few, K, **kw)
    final, _, counts = lloyd_assign_reduce(few, c, n, with_labels=True)
    check(int((counts == 0).sum()) >= 5, "13b: the reseed shape left fewer than 5 clusters empty")
    hold("reseed", few, (c, lab, final), it, **kw)
    return total


def batch_search(work, device="cuda"):
    """13c: ``scenarios search`` and ``scenarios triage`` over a copy of the
    committed corpus.  Returns the kernels' launches."""
    import cdrs_tpu_torch.scenarios.search as search_mod

    committed = os.path.join(ROOT, "data", "search_corpus")

    def listing(root):
        return sorted((os.path.relpath(os.path.join(dp, f), root),
                       os.path.getsize(os.path.join(dp, f)),
                       os.path.getmtime(os.path.join(dp, f)))
                      for dp, _, fs in os.walk(root) for f in fs)

    before = listing(committed)
    corpus = os.path.join(work, "search_corpus")
    shutil.copytree(committed, corpus)
    seen, _, restore = model_runs()
    run_cell, cells = search_mod.run_cell, []

    def counted(spec, **kw):
        cells.append(spec.name)
        return run_cell(spec, **kw)

    search_mod.run_cell = counted
    reset_launches()
    try:
        rc, out, sec = run_cli(["scenarios", "search", "--seed", "0", "--budget-cells",
                                str(SEARCH_BUDGET_CELLS), "--corpus", corpus, "--out",
                                os.path.join(work, "search.json"), *device_args(device)])
        search_launches = read_launches()
        search_cells, search_runs = len(cells), list(seen)
        check(rc == 0, f"13c: search exited {rc}; it exits 0 with violations banked")
        with open(os.path.join(work, "search.json"), encoding="utf-8") as f:
            doc = json.load(f)
        reset_launches()
        seen.clear()
        rc, _, tsec = run_cli(["scenarios", "triage", "--corpus", corpus, "--out",
                               os.path.join(work, "triage.json"), *device_args(device)])
        triage_launches = read_launches()
        triage_runs = list(seen)
    finally:
        search_mod.run_cell = run_cell
        restore()
    with open(os.path.join(work, "triage.json"), encoding="utf-8") as f:
        tri = json.load(f)
    with open(os.path.join(committed, "triage.json"), encoding="utf-8") as f:
        pinned = set(json.load(f)["names"])
    found = {"triage-" + v["name"][len("search-"):] for v in doc["violations"]}
    for r in tri["results"]:
        if r["name"] in pinned:
            check(r["ok"] or r["name"] in SEARCH_QUEUE_C,
                  f"13c: banked violation {r['name']} reproduces: {r['failed']}")
        else:
            check(r["name"] in found and not r["ok"],
                  f"13c: triage cell {r['name']} is neither banked nor this run's finding")
    check(rc == (0 if tri["ok"] else 1), f"13c: triage exited {rc} with ok {tri['ok']}")
    check(listing(committed) == before, "13c: the committed corpus changed")
    if device == "cuda":
        for name, got, runs in (("search", search_launches, search_runs),
                                ("triage", triage_launches, triage_runs)):
            check(got["lloyd"] == sum(n + 1 for n in runs) and got["lloyd"] >= 1,
                  f"13c {name}: {got['lloyd']} Lloyd launches for {len(runs)} re-clusters")
            check(got["seg_count"] == 0, f"13c {name}: {got['seg_count']} threshold counts")
    log("batch search " + json.dumps({
        "seed": 0, "budget_cells": SEARCH_BUDGET_CELLS, "cells_run": doc["cells_run"],
        "cells_with_base_and_shrink": search_cells, "seconds": round(sec, 3),
        "cells_per_second": round(search_cells / sec, 3), "kept": len(doc["kept"]),
        "kept_names": [e["name"] for e in doc["kept"]], "baseline_bits": doc["baseline_bits"],
        "coverage_bits": doc["coverage_bits"], "violations": [
            {"name": v["name"], "failed": v.get("failed") or v.get("error"),
             "shrunk_events": (v.get("shrunk") or {}).get("events")} for v in doc["violations"]],
        "re_clusters": len(search_runs), "b1_launches": search_launches["lloyd"],
        "b2_launches": search_launches["seg_count"]}))
    log("batch triage " + json.dumps({
        "cells": len(tri["results"]), "ok": tri["ok"], "seconds": round(tsec, 3),
        "cells_per_second": round(len(tri["results"]) / tsec, 3),
        "red": {r["name"]: r["failed"] for r in tri["results"] if not r["ok"]},
        "b1_launches": triage_launches["lloyd"], "b2_launches": triage_launches["seg_count"]}))
    return {k: search_launches[k] + triage_launches[k] for k in search_launches}


def main_workload(work):
    """Phase 5's population and its ``.cdrsb`` log in ``work``, made anew
    (``--phase 13`` alone)."""
    from cdrs_tpu_torch import GeneratorConfig, SimulatorConfig
    from cdrs_tpu_torch.sim.access import simulate_access
    from cdrs_tpu_torch.sim.generator import generate_population

    t0 = time.perf_counter()
    manifest = generate_population(GeneratorConfig(n_files=MAIN_FILES, seed=MAIN_SEED))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=MAIN_DURATION,
                                                       seed=MAIN_SEED + 1))
    log_path = os.path.join(work, "access.cdrsb")
    events.write_binary(log_path, manifest)
    log(f"phase 13 workload: {len(manifest)} files, {len(events)} events in "
        f"{time.perf_counter() - t0:.1f} s")
    return batch_manifest_csv(manifest, work), log_path


def batch_child(work) -> int:
    """The phase-13 child's body: phase 5's manifest CSV and ``.cdrsb`` log
    in ``work``, both written by the parent; the launches go to
    ``batch.json``."""
    launches = phase_batch(os.path.join(work, "metadata.csv"),
                           os.path.join(work, "access.cdrsb"), work)
    with open(os.path.join(work, "batch.json"), "w") as f:
        json.dump(launches, f)
    return 0


def phase_batch(m_csv, log_path, work, device="cuda"):
    """Phase 13: the staged batch commands (13a), the checkpointed Lloyd
    loop (13b) and the failure-space search (13c).  Returns the kernels'
    launches in 13a's ``cluster``, 13b and 13c."""
    t0 = time.perf_counter()
    launches, X = batch_staged(m_csv, log_path, work, device)
    if device == "cuda":
        batch_pipeline_card_cpu(work)
    log(f"phase 13a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["lloyd"] += batch_checkpointed(X, work, device)
    del X
    log(f"phase 13b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    found = batch_search(work, device)
    log(f"phase 13c: {time.perf_counter() - t0:.1f} s")
    return {k: launches[k] + found[k] for k in launches}


# -- phase 14: the mesh ------------------------------------------------------------

#: Phase 14's failed checks: each is logged when it fails and the phase
#: fails at its end, so one run reports every part.
MESH_FAILED: list = []


def expect(cond: bool, msg: str) -> None:
    if not cond:
        MESH_FAILED.append(msg)
        log(f"mesh check failed: {msg}")


def agreement(a, b) -> float:
    import numpy as np

    return float((np.asarray(a) == np.asarray(b)).mean())


def mesh_label_trace(norm, init, mesh_shape):
    """Labels and centroids of the first iterations at ``mesh_shape``
    against one device from ``init``: where the runs part."""
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.ops.kmeans import kmeans_full

    trace = {}
    with deterministic():
        for t in (1, 2, 3, 5, 10, 20, 40):
            a = kmeans_full(norm, K, init_centroids=init, max_iter=t, tol=0.0)
            b = kmeans_full(norm, K, init_centroids=init, max_iter=t, tol=0.0,
                            mesh_shape=mesh_shape)
            trace[t] = {"labels_differ": int((a[1] != b[1]).sum()),
                        "centroid_err": float((a[0] - b[0]).abs().max())}
    log(f"mesh label trace {mesh_shape} " + json.dumps(trace))


def mesh_stage_seconds(cfg, manifest, events, ref, mesh_shape):
    """Features and clustering of phase 5's workload on one mesh shape:
    (stage seconds, launches), the table and decision held against phase
    3's (``ref``)."""
    import torch

    from cdrs_tpu_torch.config import MetricsLog
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.features.batch import compute_features_torch
    from cdrs_tpu_torch.models.replication import ReplicationPolicyModel

    metrics = MetricsLog()
    dev = torch.device("cuda", 0)
    reset_launches()
    with deterministic():
        with metrics.timer("features", dev):
            table = compute_features_torch(manifest, events, device=dev,
                                           mesh_shape=mesh_shape)
        model = ReplicationPolicyModel(cfg.kmeans, cfg.scoring, mesh_shape=mesh_shape)
        with metrics.timer("cluster", dev):
            dec = model.run(table.norm, metrics=metrics)
    launches = read_launches()
    what = f"14a {mesh_shape}"
    expect(torch.equal(table.raw, ref.table.raw) and torch.equal(table.norm, ref.table.norm),
          f"{what}: the features differ from one device's")
    agree = agreement(dec.labels, ref.decision.labels)
    expect(agree >= MESH_AGREE, f"{what}: labels agree on {agree:.7f}")
    secs = {k: round(float(metrics.records[f"{k}.seconds"]), 6)
            for k in ("features", "cluster", "kmeans", "score")}
    return secs, launches


def mesh_minibatch_drift(norm, ref):
    """14a's B3 paths on a mesh: mini-batch KMeans and drift at data = 4
    against one device.  Returns the launches on the mesh."""
    import numpy as np
    import torch

    from cdrs_tpu_torch.control.drift import detect_drift_torch
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.ops.kmeans_stream import MiniBatchKMeans

    batches = [norm[i * MB_BATCH:(i + 1) * MB_BATCH] for i in range(4)]
    out = {}
    with deterministic():
        for shape in (None, MESH_MAIN):
            mb = MiniBatchKMeans(K, seed=MAIN_SEED, device="cuda", mesh_shape=shape)
            reset_launches()
            labels = [mb.partial_fit(b) for b in batches]
            cat = np.asarray(ref.decision.category_idx)
            frac = np.bincount(cat[np.asarray(ref.decision.labels)], minlength=4) / len(norm)
            drift = detect_drift_torch(norm[:len(norm) // 2], ref.decision.centroids, cat,
                                       frac, 4, mesh_shape=shape)
            out[shape is None] = (mb.centroids, labels, drift, read_launches()["lloyd"])
    (c4, l4, d4, n4), (c1, l1, d1, _) = out[False], out[True]
    agree = agreement(torch.cat(l4).cpu(), torch.cat(l1).cpu())
    expect(agree == 1.0, f"14a mini-batch labels agree on {agree:.7f}, not all")
    err = float((c4 - c1).abs().max())
    expect(err <= MESH_TOL, f"14a mini-batch centroids differ by {err:.3e} > {MESH_TOL}")
    expect(abs(d4.centroid_shift - d1.centroid_shift) <= 1e-6
          and np.array_equal(d4.fractions, d1.fractions), f"14a drift {d4} vs {d1}")
    want = 4 * (len(batches) + 1)
    expect(n4 == want, f"14a mini-batch + drift made {n4} launches on the mesh, expected {want}")
    log("mesh minibatch/drift " + json.dumps(
        {"label_agreement": agree, "centroid_err": err,
         "drift_shift": [d1.centroid_shift, d4.centroid_shift],
         "launches": n4}))
    return n4


def mesh_main(cfg, main_result, manifest, events):
    """14a: ``run_pipeline`` at data = 4 (the main path on the mesh),
    cold inits at data = 1, 2, 4, stage seconds by shard count and the B3
    paths; 14b: the model axis.  Returns the launches."""
    import dataclasses

    import numpy as np
    import torch

    from cdrs_tpu_torch import run_pipeline
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.models.replication import ReplicationPolicyModel
    from cdrs_tpu_torch.ops.kmeans import kmeans_full

    ref = main_result
    reset_launches()
    t0 = time.perf_counter()
    res = run_pipeline(dataclasses.replace(cfg, mesh_shape=MESH_MAIN))
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_iter = int(res.summary()["kmeans.n_iter"])
    log(f"mesh 14a main path at {MESH_MAIN}: wall {wall:.3f} s, launches {launches}")
    log("mesh 14a stages " + json.dumps(res.summary()))
    expect(launches["lloyd"] == 4 * (n_iter + 1),
          f"14a made {launches['lloyd']} Lloyd launches, expected 4 x ({n_iter} + 1)")
    expect(launches["seg_count"] == 4 * 12,
          f"14a made {launches['seg_count']} threshold-count launches, expected 4 x 12")
    expect(torch.equal(res.table.raw, ref.table.raw) and torch.equal(res.table.norm,
                                                                   ref.table.norm),
          "14a features differ from one device's")
    d4, d1 = res.decision, ref.decision
    agree = agreement(d4.labels, d1.labels)
    rf_agree = agreement(d4.replication_factor_per_file(cfg.scoring),
                         d1.replication_factor_per_file(cfg.scoring))
    err = float(np.abs(d4.centroids - d1.centroids).max())
    log("mesh 14a decisions " + json.dumps(
        {"n_iter": [int(ref.summary()["kmeans.n_iter"]), n_iter], "label_agreement": agree,
         "rf_agreement": rf_agree, "centroid_err": err,
         "categories": [d1.categories, d4.categories]}))
    expect(agree >= MESH_AGREE, f"14a labels agree with one device's on {agree:.7f}")
    expect(err <= MESH_TOL, f"14a centroids differ from one device's by {err:.3e}")
    expect(rf_agree >= MESH_AGREE, f"14a per-file rf agree on {rf_agree:.7f}")
    expect(np.array_equal(d4.category_idx, d1.category_idx), "14a categories differ")
    norm = ref.table.norm
    inits = {}
    with deterministic():
        for nd in MESH_DATA:
            inits[nd] = kmeans_full(norm, K, seed=MAIN_SEED, max_iter=0, tol=0.0,
                                    init_method=cfg.kmeans.init_method,
                                    mesh_shape={"data": nd})[0]
    expect(all(torch.equal(inits[nd], inits[1]) for nd in MESH_DATA),
          "14a cold D² inits differ across shard counts")
    log("mesh 14a cold inits equal at " + json.dumps(list(MESH_DATA)))
    mesh_label_trace(norm, inits[1], MESH_MAIN)
    # Stage seconds by shard count, in turns (1, 2, 4, 4, 2, 1) in one call.
    stages = {}
    for nd in MESH_DATA + MESH_DATA[::-1]:
        secs, got = mesh_stage_seconds(cfg, manifest, events, ref, {"data": nd})
        stages.setdefault(nd, []).append(secs)
        for key in launches:
            launches[key] += got[key]
    log("mesh stage seconds " + json.dumps(stages))
    rowmajor = mesh_minibatch_drift(norm, ref)
    # 14b: the model axis, from the same init: no Lloyd-kernel launch.
    reset_launches()
    with deterministic():
        dec = ReplicationPolicyModel(cfg.kmeans, cfg.scoring, mesh_shape=MESH_MODEL).run(
            norm, init_centroids=inits[1])
    got = read_launches()
    expect(got["lloyd"] == 0, f"14b launched the Lloyd kernel {got['lloyd']} times")
    expect(got["seg_count"] == MESH_MODEL["data"] * 12,
          f"14b made {got['seg_count']} threshold-count launches")
    err_b = float(np.abs(dec.centroids - d1.centroids).max())
    agree_b = agreement(dec.labels, d1.labels)
    log("mesh 14b " + json.dumps({"mesh": MESH_MODEL, "launches": got, "label_agreement": agree_b,
                                  "centroid_err": err_b, "categories": dec.categories}))
    expect(agree_b >= MESH_AGREE, f"14b labels agree with one device's on {agree_b:.7f}")
    expect(err_b <= MESH_TOL, f"14b centroids differ from one device's by {err_b:.3e}")
    expect(np.array_equal(dec.category_idx, d1.category_idx), "14b categories differ")
    mesh_label_trace(norm, inits[1], MESH_MODEL)
    launches["seg_count"] += got["seg_count"]
    launches["lloyd_rowmajor"] = rowmajor
    return launches


def mesh_cell():
    """14c: ``scale-mesh`` on the card against the CPU shards, both from the
    CPU-computed cold init.  Returns the card's launches."""
    import cdrs_tpu_torch.control.controller as ctl_mod
    from cdrs_tpu_torch.scenarios import preset, run_cell

    spec = preset("scale-mesh")
    ndata = spec.mesh["data"]
    seen, hooks, restore = model_runs()
    hooks["init_fn"] = cpu_model_init
    drift_calls, drift = [], ctl_mod.detect_drift_torch

    def counted_drift(*a, **kw):
        drift_calls.append(1)
        return drift(*a, **kw)

    ctl_mod.detect_drift_torch = counted_drift
    try:
        reset_launches()
        card = run_cell(spec, device="cuda")
        got = read_launches()
        n_runs, n_drift = list(seen), len(drift_calls)
        cpu = run_cell(spec, device="cpu")
    finally:
        ctl_mod.detect_drift_torch = drift
        restore()
    log("mesh 14c " + json.dumps({"cell": spec.name, "ok": card["ok"],
                                  "invariants": card["invariants"],
                                  "seconds": card["seconds"], "cpu_seconds": cpu["seconds"],
                                  "model_runs": len(n_runs), "drift_calls": n_drift,
                                  "launches": got}))
    expect(card["ok"] and card["invariants"].get("mesh_engaged"),
          f"scale-mesh is red on the card: {card['invariants']}")
    for key in ("invariants", "metrics", "coverage", "fingerprint"):
        expect(card[key] == cpu[key], f"scale-mesh: {key} differ between the card and the "
              f"CPU: {card[key]} vs {cpu[key]}")
    want = ndata * (sum(n + 1 for n in n_runs) + n_drift)
    expect(got["lloyd"] == want, f"14c made {got['lloyd']} Lloyd launches, expected {want}")
    expect(got["seg_count"] == ndata * 12 * len(n_runs),
          f"14c made {got['seg_count']} threshold-count launches")
    return got


def mesh_points(work) -> str:
    """14d's points, phase 3's feature table, saved for the children."""
    return os.path.join(work, "mesh_points.npy")


def mesh_child(work, backend: str, world: int, rank: int, port: int) -> int:
    """14d's child: join a ``world``-process group over ``backend`` and run
    ``kmeans_full`` on 14d's points at ``{"data": 2}`` on the card; the
    result goes to ``mesh_<backend>_<rank>.npz`` in ``work``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.ops.kmeans import kmeans_full
    from cdrs_tpu_torch.parallel.distributed import init_distributed

    init_distributed(f"tcp://localhost:{port}", num_processes=world, process_id=rank,
                     backend=backend, device="cuda")
    x = torch.from_numpy(np.load(mesh_points(work))).cuda()
    reset_launches()
    with deterministic():
        c, lab, it, shift = kmeans_full(x, K, seed=MAIN_SEED, max_iter=MESH_CHILD_ITERS,
                                        mesh_shape={"data": 2})
    np.savez(os.path.join(work, f"mesh_{backend}_{rank}.npz"), centroids=c.cpu().numpy(),
             labels=lab.cpu().numpy(), it=it, lloyd=read_launches()["lloyd"])
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_mesh_children(work, norm):
    """14d: NCCL at world size 1 (one rank, both shards) and gloo with two
    ranks (one shard each), all on card 0; started at once."""
    import numpy as np

    np.save(mesh_points(work), norm.cpu().numpy())
    threads = {k: "1" for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")}
    children = []
    for backend, world in (("nccl", 1), ("gloo", 2)):
        port = free_port()
        for rank in range(world):
            child_log = os.path.join(work, f"mesh_{backend}_{rank}.log")
            with open(child_log, "w") as out:
                child = subprocess.Popen(
                    [sys.executable, "-c",
                     f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
                     f"sys.exit(chip_smoke.mesh_child({work!r}, {backend!r}, {world}, "
                     f"{rank}, {port}))"],
                    cwd=work, env=dict(os.environ, PYTHONPATH=ROOT, **threads), stdout=out,
                    stderr=subprocess.STDOUT, start_new_session=True)
            children.append((backend, rank, child, child_log))
    return children, time.perf_counter()


def join_mesh_children(children, t_start, work, norm):
    """Wait for 14d's children and hold each against the in-process
    ``{"data": 2}`` mesh: centroids and labels bit for bit."""
    import numpy as np
    import torch

    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.ops.kmeans import kmeans_full

    for backend, rank, child, child_log in children:
        try:
            rc = child.wait(timeout=MESH_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            stop_child(child)
            rc = "timeout"
        with open(child_log) as f:
            text = f.read()
        expect(rc == 0, f"14d {backend} rank {rank} exited {rc}: {text[-3000:]}")
    log(f"phase 14d: children done {time.perf_counter() - t_start:.1f} s after their start")
    with deterministic():
        c, lab, it, _ = kmeans_full(norm, K, seed=MAIN_SEED, max_iter=MESH_CHILD_ITERS,
                                    mesh_shape={"data": 2})
    c, lab = c.cpu().numpy(), lab.cpu().numpy()
    out = {}
    for backend, rank, _, _ in children:
        got = np.load(os.path.join(work, f"mesh_{backend}_{rank}.npz"))
        same = (np.array_equal(got["centroids"], c) and np.array_equal(got["labels"], lab)
                and int(got["it"]) == it)
        expect(same, f"14d {backend} rank {rank} differs from the in-process data = 2 mesh")
        out[f"{backend}_{rank}"] = {"iterations": int(got["it"]), "lloyd": int(got["lloyd"])}
    log("mesh 14d " + json.dumps(out))
    expect(torch.isfinite(torch.from_numpy(c)).all().item(), "14d centroids not finite")


def mesh_alone(work):
    """``--phase 14``: phase 3's pipeline on one device and phase 5's
    workload made anew, then phase 14."""
    from cdrs_tpu_torch import run_pipeline
    from cdrs_tpu_torch.sim.access import simulate_access
    from cdrs_tpu_torch.sim.generator import generate_population

    cfg = main_config()
    main_result = run_pipeline(cfg)
    manifest = generate_population(cfg.generator)
    events = simulate_access(manifest, cfg.simulator)
    return phase_mesh(cfg, main_result, manifest, events, work)


def phase_mesh(cfg, main_result, manifest, events, work):
    """Phase 14: 14a and 14b (``mesh_main``), 14c (``mesh_cell``) with 14d's
    children running beside it.  Returns the launches of 14a-c."""
    t0 = time.perf_counter()
    launches = mesh_main(cfg, main_result, manifest, events)
    log(f"phase 14a/14b: {time.perf_counter() - t0:.1f} s")
    children, t_children = start_mesh_children(work, main_result.table.norm)
    try:
        t0 = time.perf_counter()
        cell = mesh_cell()
        log(f"phase 14c: {time.perf_counter() - t0:.1f} s")
        join_mesh_children(children, t_children, work, main_result.table.norm)
    finally:
        for child in children:
            stop_child(child[2])
    for key in ("lloyd", "seg_count"):
        launches[key] += cell[key]
    check(not MESH_FAILED, f"phase 14 failed {len(MESH_FAILED)} checks: {MESH_FAILED}")
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="build and check the kernels only; prints no ok line")
    parser.add_argument("--phase", type=int, choices=(9, 10, 11, 12, 13, 14), default=None,
                        help="build and check the kernels, then run this phase alone; prints "
                             "no ok line")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke runs on a GPU")
    if not os.path.isdir(os.path.join(ROOT, "cdrs_tpu_torch", "csrc")):
        fail("cdrs_tpu_torch is not beside this script: run it from a checkout")
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()

    phase_environment()
    rows = phase_kernels(reps=5 if args.quick else 20)
    if args.quick:
        log(f"quick run done in {time.perf_counter() - t_start:.1f} s; main path skipped")
        return 0
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    child = batch = None
    if args.phase is not None:
        try:
            if args.phase == 9:
                log(f"phase 9 launches {phase_scenarios()}")
            elif args.phase == 11:
                log(f"phase 11 launches {phase_storage()}")
            elif args.phase == 12:
                placement_memo()
                child, child_log, t_child = start_child(work, "placement")
                placement_small()
                placement = join_child(child, child_log, t_child, work, "placement", "12a/12c")
                log(f"phase 12 launches {placement}")
            elif args.phase == 13:
                log(f"phase 13 launches {phase_batch(*main_workload(work), work)}")
            elif args.phase == 14:
                log(f"phase 14 launches {mesh_alone(work)}")
            else:
                from cdrs_tpu_torch import GeneratorConfig
                from cdrs_tpu_torch.sim.generator import generate_population

                manifest = generate_population(GeneratorConfig(n_files=MAIN_FILES,
                                                               seed=MAIN_SEED))
                log(f"phase 10 launches {phase_serve(manifest, work)}")
        finally:
            stop_child(child)
            shutil.rmtree(work, ignore_errors=True)
        log(f"phase {args.phase} run done in {time.perf_counter() - t_start:.1f} s")
        return 0
    try:
        # 12a and 12c (host-bound, one core) run in a child beside 3-11.
        child, child_log, t_child = start_child(work, "placement")
        launches, cfg, main_result = phase_main_path()
        norm_20k, init_20k = phase_card_vs_cpu()
        stream_launches, stream_times, manifest, events, log_path = phase_stream_path(
            cfg, main_result, work)
        # Phase 13 (host-bound CSV stages) runs in a child beside 6-12 from
        # here, on phase 5's manifest written as CSV and its log.
        batch_manifest_csv(manifest, work)
        batch, batch_log, t_batch = start_child(work, "batch")
        phase_minibatch_card_vs_cpu(norm_20k, init_20k)
        log("stream path times " + json.dumps(stream_times))
        t0 = time.perf_counter()
        control_launches, control_records = phase_controller(manifest, events, main_result)
        log(f"phase 6 (controller): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        daemon_launches = phase_daemon(manifest, events, log_path, control_records, work)
        log(f"phase 7 (daemon): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        chaos_launches = phase_chaos(manifest, events)
        log(f"phase 8 (chaos): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh_launches = phase_mesh(cfg, main_result, manifest, events, work)
        log(f"phase 14 (mesh): {time.perf_counter() - t0:.1f} s")
        del events
        t0 = time.perf_counter()
        scenario_launches = phase_scenarios()
        log(f"phase 9 (scenarios): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        serve_launches = phase_serve(manifest, work)
        log(f"phase 10 (serve): {time.perf_counter() - t0:.1f} s")
        del manifest
        t0 = time.perf_counter()
        storage_launches = phase_storage()
        log(f"phase 11 (storage): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        placement_small()
        log(f"phase 12b: {time.perf_counter() - t0:.1f} s")
        batch_launches = join_child(batch, batch_log, t_batch, work, "batch", "13")
        placement = join_child(child, child_log, t_child, work, "placement", "12a/12c")
        log(f"phase 12 (placement): {time.perf_counter() - t0:.1f} s after phase 11")
        for name in ("lloyd", "seg_count"):
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            placement["max_abs_err"][name])
    finally:
        stop_child(child)
        stop_child(batch)
        shutil.rmtree(work, ignore_errors=True)

    kernels = [
        {"name": "lloyd_assign_reduce", "route": "cuda",
         "source": "cdrs_tpu_torch/csrc/lloyd.cu",
         "replaces": "cdrs_tpu/ops/pallas_kernels.py:392",
         "launches": launches["lloyd"], "control_launches": control_launches["lloyd"],
         "daemon_launches": daemon_launches["lloyd"],
         "chaos_launches": chaos_launches["lloyd"],
         "scenario_launches": scenario_launches["lloyd"],
         "serve_launches": serve_launches["lloyd"],
         "storage_launches": storage_launches["lloyd"],
         "placement_launches": placement["launches"]["lloyd"],
         "batch_launches": batch_launches["lloyd"], "mesh_launches": mesh_launches["lloyd"],
         **rows["lloyd"], "library_ms": None},
        {"name": "label_threshold_count", "route": "cuda",
         "source": "cdrs_tpu_torch/csrc/seg_count.cu",
         "replaces": "cdrs_tpu/ops/pallas_kernels.py:534",
         "launches": launches["seg_count"],
         "control_launches": control_launches["seg_count"],
         "daemon_launches": daemon_launches["seg_count"],
         "chaos_launches": chaos_launches["seg_count"],
         "scenario_launches": scenario_launches["seg_count"],
         "serve_launches": serve_launches["seg_count"],
         "storage_launches": storage_launches["seg_count"],
         "placement_launches": placement["launches"]["seg_count"],
         "batch_launches": batch_launches["seg_count"],
         "mesh_launches": mesh_launches["seg_count"], **rows["seg_count"],
         "library_ms": None},
        {"name": "lloyd_assign_reduce (row-major, labels)", "route": "cuda",
         "source": "cdrs_tpu_torch/csrc/lloyd.cu",
         "replaces": "cdrs_tpu/ops/pallas_kernels.py:443",
         "launches": stream_launches, "control_launches": 0,
         "daemon_launches": daemon_launches["lloyd_rowmajor"], "chaos_launches": 0,
         "scenario_launches": 0, "serve_launches": 0, "storage_launches": 0,
         "placement_launches": 0, "batch_launches": 0,
         "mesh_launches": mesh_launches["lloyd_rowmajor"], **rows["lloyd_rowmajor"],
         "library_ms": None},
    ]
    for row in kernels:
        check(all(isinstance(row[key], (int, float)) and math.isfinite(row[key])
                  for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")),
              f"kernel row {row['name']} has a missing number")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
