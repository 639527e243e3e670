"""Benchmark harness: the BASELINE.md workload configs on the port, the
counterpart of ``cdrs_tpu/benchmarks/harness.py``.

Configs (BASELINE.md table; the reference's n, d, k and iteration budgets):

  1: 10K files x 8 features,  k=10    — the CPU baseline alone
  2: 1M  files x 32 features, k=128   — one card, the headline
  3: 10M files x 128 features, k=1024 — one card
  4: 100M files x 128 features, k=1024 — 8-way data-parallel (scaled down
     to the cards present; on one card its bf16 e2e is the rehearsal)
  5: streaming: events/s through the fold off the simulator's feed

What differs from the reference, and why:

* The device path is the port's: ``ops/kmeans.kmeans_full`` (B1, the CUDA
  Lloyd kernel, once an iteration and once for the labels),
  ``ops/scoring.classify`` (B2 in the bisection medians) and the fold of
  ``features/streaming``.  It runs on the card unless ``device="cpu"`` is
  asked for.
* ``vs_baseline``'s denominator is the port's plain PyTorch version on the
  CPU in float32 (``baseline: "torch-cpu"``) where the reference timed its
  numpy backend, so its ``numpy_*`` keys are ``baseline_*`` here.  Backend
  "torch-cpu" (config 1's) times the baseline alone.
* Device stamps: ``device_platform`` ("cuda" or "cpu"), ``device_name`` (the
  card's; "torch-cpu" on the CPU) and ``device_count`` in place of
  ``jax_platform``/``jax_devices``; ``launches`` counts B1's, B2's and B3's
  launches over the call.
* The port has one Lloyd step a device (the CUDA kernel on a card, its
  plain version on the CPU: ``ops/kmeans.resolve_update``), so ``update``
  takes only "auto"; the TPU's strategies are refused.  The recorded
  ``update`` is the step that ran.  The TPU's ``chunk_rows`` tiling has no
  counterpart (the kernel tiles itself) and is recorded as null.
* The memory guard gives the points 5/16 of the card's memory (the
  reference's 5 GiB of a 16 GiB v5e), recorded as ``points_budget_bytes``;
  on an 80 GB card config 3 runs its full 10,485,760 rows.
* Matrices past ``direct_baseline_limit`` rows are drawn on the card from a
  ``torch.Generator`` keyed by the seed (not JAX's threefry stream), chunk
  by chunk straight into the points' dtype.  Host-drawn data
  (``synth_blobs_np``, ``_init_from_rows``, ``_synth_event_batch``) is the
  reference's, bit for bit.
* The timed Lloyd loop runs at ``tol=0``, which reads nothing back to the
  host until it ends; ``shift_readback`` times the same loop with the
  per-iteration shift read that ``tol > 0`` makes.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np

__all__ = ["BenchConfig", "CONFIGS", "run_bench", "synth_blobs_np", "e2e_scoring",
           "downscaled_rows", "decision_quality_metrics"]

#: The baseline's name: the port's plain PyTorch version on the CPU.
BASELINE = "torch-cpu"


@dataclass(frozen=True)
class BenchConfig:
    n: int
    d: int
    k: int
    #: "torch" (the device path against the baseline) or "torch-cpu" (the
    #: baseline alone).
    backend: str
    iters: int = 20
    mesh_shape: tuple[tuple[str, int], ...] | None = None  # hashable dict items
    dtype: str = "float32"
    #: Lloyd budget of the ``e2e`` time-to-categories run, kept apart from
    #: ``iters`` (the iteration windows); None = ``iters``.
    e2e_iters: int | None = None
    #: The baseline runs directly up to this many rows, else on a quarter of
    #: it and scaled linearly in n (the Lloyd step is O(n k d)).
    direct_baseline_limit: int = 2_000_000

    def mesh_dict(self) -> dict[str, int] | None:
        return dict(self.mesh_shape) if self.mesh_shape else None


CONFIGS: dict[int, BenchConfig] = {
    1: BenchConfig(n=10_000, d=8, k=10, backend=BASELINE, iters=10),
    # Windows long enough that a call's fixed costs (the init's copy, the
    # final label pass and sync) stay under a percent of the window.
    2: BenchConfig(n=1_048_576, d=32, k=128, backend="torch", iters=2000, e2e_iters=100),
    3: BenchConfig(n=10_485_760, d=128, k=1024, backend="torch", iters=50, e2e_iters=5),
    4: BenchConfig(n=104_857_600, d=128, k=1024, backend="torch", iters=50,
                   mesh_shape=(("data", 8),), e2e_iters=5),
    # 5 = streaming: n is the file population, iters the number of event
    # batches; see _bench_streaming (events/s is the metric).
    5: BenchConfig(n=1_048_576, d=32, k=128, backend="torch", iters=10),
}

STREAM_BATCH_EVENTS = 1_048_576
#: The points' share of a card's memory: the reference's 5 GiB of a 16 GiB
#: v5e.  The Lloyd loop, k-means|| (a float32 copy of bf16 points) and the
#: medians' masked copies need the rest.
POINTS_BUDGET_SHARE = 5 / 16
#: Rows drawn at once by ``_synth_blobs_device`` (2 GiB of float32 noise at
#: d = 128).
_SYNTH_CHUNK_ROWS = 1 << 22
#: Generator stream of the device-drawn blobs (``ops/kmeans.generator``).
_SYNTH_STREAM = 16
#: A tolerance no nonzero shift falls under: the loop reads the shift back
#: every iteration and stops only where the centroids stop moving exactly.
_READBACK_TOL = 1e-300


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_count(dev) -> int:
    import torch

    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _device_memory(dev) -> int | None:
    """Bytes of the card's memory; None on the CPU (no guard: the points
    live in host memory there)."""
    import torch

    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def _device_stamp(dev) -> dict:
    from ..device import device_name

    return {"device_platform": dev.type, "device_name": device_name(dev),
            "device_count": _device_count(dev)}


def _launches() -> dict:
    """The kernels' launch counters (CUDA launches only): B1's, B2's and
    B3's (the Lloyd launches made inside ``ops/lloyd.rowmajor()``)."""
    from ..ops.lloyd import lloyd_assign_reduce
    from ..ops.seg_count import label_threshold_count

    b3 = lloyd_assign_reduce.rowmajor_launches
    return {"lloyd_assign_reduce": lloyd_assign_reduce.launches - b3,
            "label_threshold_count": label_threshold_count.launches,
            "lloyd_assign_reduce_rowmajor": b3}


def _launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _synth_event_batch(rng, n_files, e, t0):
    """Vectorized synthetic event batch (time-ordered), numpy struct-of-arrays."""
    ts = t0 + np.sort(rng.random(e)) * 60.0
    return {
        "pid": rng.integers(0, n_files, size=e, dtype=np.int32),
        "ts": ts,
        "op": (rng.random(e) < 0.2).astype(np.int8),
        "client": rng.integers(0, 4, size=e, dtype=np.int32),
    }


def _numpy_stream_fold(batch, n_files, counters):
    """APPROXIMATE numpy fold (freq/writes + per-batch concurrency, no
    cross-batch carry), reported for transparency; ``vs_baseline`` compares
    against the port's exact fold on the CPU, which computes what the
    device fold computes."""
    pid, ts, op = batch["pid"], batch["ts"], batch["op"]
    counters["freq"] += np.bincount(pid, minlength=n_files)
    counters["writes"] += np.bincount(pid, weights=(op == 1), minlength=n_files)
    sec = np.floor(ts).astype(np.int64)
    sec -= sec.min()
    key = pid.astype(np.int64) * (int(sec.max()) + 1) + sec
    uniq, cnt = np.unique(key, return_counts=True)
    np.maximum.at(counters["conc"], uniq // (int(sec.max()) + 1),
                  cnt.astype(np.float64))


def _stream_workload(n: int, e: int, batches: int, seed: int):
    """(manifest, raw batches, EventLogs) of config 5: the reference's draws
    in its order (the files' primary nodes, then each batch)."""
    from ..io.events import EventLog, Manifest

    rng = np.random.default_rng(seed)
    manifest = Manifest(
        paths=[f"/f{i}" for i in range(n)],
        creation_ts=np.zeros(n),
        primary_node_id=rng.integers(0, 4, size=n, dtype=np.int32),
        size_bytes=np.ones(n, dtype=np.int64),
        category=["moderate"] * n, nodes=["dn1", "dn2", "dn3", "dn4"])
    raw = [_synth_event_batch(rng, n, e, 1.7e9 + 60.0 * i) for i in range(batches)]
    logs = [EventLog(ts=b["ts"], path_id=b["pid"], op=b["op"], client_id=b["client"],
                     clients=manifest.nodes) for b in raw]
    return manifest, raw, logs


def _bench_streaming(cfg: BenchConfig, seed: int, mesh_shape: dict[str, int] | None = None,
                     device=None, batch_events: int = STREAM_BATCH_EVENTS) -> dict:
    """Events/s through the device fold against the port's exact fold on
    the CPU.  ``mesh_shape={"data": N}`` folds each batch over N event
    shards (the reference's sharded config-5 scenario)."""
    from ..device import resolve_device
    from ..features.streaming import (_fold_columns, _prep_batch, _to_device, stream_init,
                                      stream_update)

    dev = resolve_device(device)
    n, e = cfg.n, int(batch_events)
    ndata = int((mesh_shape or {}).get("data", 1))
    requested = ndata
    avail = _device_count(dev)
    if ndata > avail:
        # Largest available power of two: always divides the 2^20 batch.
        ndata = 1 << (avail.bit_length() - 1)
    e_shard = e + ((-e) % ndata)  # padded as stream_update pads
    manifest, raw, logs = _stream_workload(n, e, cfg.iters, seed)

    # The production prep decides the wire format and builds the columns:
    # the bench times the fold fed what the real pipeline feeds it.
    prepped = []
    sec_base = None
    for lg in logs:
        pb = _prep_batch(lg, manifest, sec_base=sec_base, pad_target=e_shard, ndata=ndata)
        sec_base = pb.sec_base
        prepped.append(pb)
    wire = prepped[0].wire
    # The copies land before the timed loop: the metric is the fold's rate
    # (stream1b times the transfer-bound end to end).
    staged = [_to_device(pb, dev) for pb in prepped]
    _sync(dev)

    _fold_columns(stream_init(n, dev), prepped[0], *staged[0])   # warm-up
    _sync(dev)
    st = stream_init(n, dev)
    t0 = time.perf_counter()
    for pb, cols in zip(prepped, staged):
        st = _fold_columns(st, pb, *cols)
    _sync(dev)
    dev_eps = (cfg.iters * e) / (time.perf_counter() - t0)
    del staged, st

    # The port's exact fold on the CPU: the same semantics as the device
    # fold, ``vs_baseline``'s denominator.
    base_logs = logs[1:1 + max(2, cfg.iters // 4)]
    st_cpu = stream_update(stream_init(n, "cpu"), logs[0], manifest)   # warm-up
    t0 = time.perf_counter()
    for lg in base_logs:
        st_cpu = stream_update(st_cpu, lg, manifest)
    cpu_exact_eps = (len(base_logs) * e) / (time.perf_counter() - t0)

    counters = {"freq": np.zeros(n), "writes": np.zeros(n), "conc": np.zeros(n)}
    t0 = time.perf_counter()
    for b in raw[:len(base_logs)]:
        _numpy_stream_fold(b, n, counters)
    np_approx_eps = (len(base_logs) * e) / (time.perf_counter() - t0)

    suffix = f"_mesh{ndata}" if ndata > 1 else ""
    out = {
        "config": 5, "n": n, "d": cfg.d, "k": cfg.k,
        "batch_events": e, "batches": cfg.iters,
        "metric": f"stream_events_per_sec_n{n}_batch{e}{suffix}",
        "value": dev_eps,
        "unit": "event/s",
        "vs_baseline": dev_eps / cpu_exact_eps,
        "baseline_exact_events_per_sec": cpu_exact_eps,
        "numpy_approx_events_per_sec": np_approx_eps,
        "baseline": BASELINE,
        "backend": "torch",
        "mesh_data": ndata,
        "wire": wire,
        **_device_stamp(dev),
    }
    if ndata != requested:
        out["mesh_downscaled_to"] = {"data": ndata}
    return out


def e2e_scoring(d: int, median_method: str):
    """The e2e's scoring tables over ``d`` synthetic features (the pipeline's
    real tables cover its 5; the bench scores every column, so the median
    and score stages carry the full width)."""
    from ..config import ScoringConfig

    feats = tuple(f"f{i}" for i in range(d))
    dirs = {"Hot": 1, "Shared": 1, "Moderate": 0, "Archival": -1}
    return ScoringConfig(
        features=feats,
        global_medians={f: 0.5 for f in feats},
        weights={c: {f: 1.0 for f in feats} for c in dirs},
        directions={c: {f: v for f in feats} for c, v in dirs.items()},
        median_method=median_method,
        compute_global_medians_from_data=True)


def _plain_lloyd_step(x, c):
    """One Lloyd step of the plain PyTorch version: (new centroids, labels
    against ``c``); an empty cluster keeps its centroid."""
    import torch

    from ..ops.lloyd import lloyd_assign_reduce_plain

    labels, sums, counts = lloyd_assign_reduce_plain(x, c, x.shape[0], with_labels=True)
    return torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], c), labels


def _bench_e2e(cfg: BenchConfig, config_num: int, seed: int,
               mesh_shape: dict[str, int] | None, update: str, dev) -> dict:
    """Wall-clock time-to-categories: points on the card -> KMeans ->
    scoring -> the category table on the host.

    The matrix is drawn on the card, clustered for exactly
    ``cfg.e2e_iters`` Lloyd iterations from a k-means|| init (D² where its
    per-round sample does not fit), and classified with bisection medians
    on CUDA ("auto" on the CPU); the clock stops when the per-cluster
    categories reach the host.  The baseline runs the same pipeline (same
    budget, exact sort medians) on 200,000 rows on the CPU and scales
    linearly in n.
    """
    import torch

    from ..ops.kmeans import kmeans_full
    from ..ops.scoring import classify

    n, d, k = cfg.n, cfg.d, cfg.k
    e2e_iters = cfg.e2e_iters if cfg.e2e_iters is not None else cfg.iters
    X = _synth_blobs_device(n, d, min(k, 64), seed, cfg.dtype, dev)
    _sync(dev)
    scoring = e2e_scoring(d, "bisect" if dev.type == "cuda" else "auto")

    def run_once(init_method):
        t0 = time.perf_counter()
        # tol=0: the Lloyd loop reads nothing back before it ends, so the
        # scoring launches queue behind it; the one fetch the clock waits
        # for is the categories'.
        _, labels, it, _ = kmeans_full(X, k, tol=0.0, seed=seed, max_iter=e2e_iters,
                                       init_method=init_method, mesh_shape=mesh_shape)
        winner, _, _ = classify(X, labels, k, scoring, mesh_shape=mesh_shape)
        cats = winner.cpu().numpy()
        return time.perf_counter() - t0, int(it), cats

    # k-means|| costs a few passes whatever k is (D² takes k sequential
    # rounds); fall back where its per-round sample cannot fit the rows.
    try:
        run_once("kmeans||")        # first launches, scratch, kernel load
        init_method = "kmeans||"
    except ValueError:
        run_once("d2")
        init_method = "d2"
    secs, it, cats = run_once(init_method)
    del X

    # The baseline: the same pipeline on a subsample on the CPU, scaled in n.
    n_sub = min(n, 200_000)
    xs_np = synth_blobs_np(n_sub, d, min(k, 64), seed)
    xs = torch.from_numpy(xs_np.astype(np.float32))
    c = torch.from_numpy(_init_from_rows(xs_np, k, seed).astype(np.float32))
    steps = max(1, min(2, e2e_iters))
    t0 = time.perf_counter()
    labels = None
    for _ in range(steps):
        c, labels = _plain_lloyd_step(xs, c)
    per_iter = (time.perf_counter() - t0) / steps
    t0 = time.perf_counter()
    classify(xs, labels, k, dataclasses.replace(scoring, median_method="sort"))
    base_score = time.perf_counter() - t0
    base_secs = (per_iter * e2e_iters + base_score) * (n / n_sub)

    return {
        "config": int(config_num),
        "e2e": True,
        "n": n, "d": d, "k": k,
        "metric": f"e2e_seconds_to_categories_n{n}_d{d}_k{k}",
        "value": secs,
        "unit": "s",
        "vs_baseline": base_secs / secs,   # > 1: faster than the baseline pipeline
        "lloyd_iters": it,
        "init_method": init_method,
        "median_method": scoring.median_method,
        "files_per_sec": n / secs,
        "categories_found": sorted(set(int(x) for x in cats)),
        "baseline_seconds_estimated": base_secs,
        "baseline": BASELINE,
        "backend": "torch",
        "update": update,
        "dtype": cfg.dtype,
        "chunk_rows": None,
        "mesh": dict(mesh_shape or {}),
        **_device_stamp(dev),
    }


def synth_blobs_np(n: int, d: int, k_true: int, seed: int = 0) -> np.ndarray:
    """Host-side Gaussian blob mixture (small configs)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k_true, d)) * 3.0
    lab = rng.integers(0, k_true, size=n)
    return (centers[lab] + rng.normal(size=(n, d)) * 0.5).astype(np.float64)


def _synth_blobs_device(n: int, d: int, k_true: int, seed: int, dtype, device):
    """(n, d) Gaussian blob mixture drawn on ``device`` from a generator
    keyed by ``seed``, written ``_SYNTH_CHUNK_ROWS`` rows at a time into
    ``dtype``: the host never holds the matrix, and no full-size float32
    temporary stands beside a bf16 one."""
    import torch

    from ..device import torch_dtype
    from ..ops.kmeans import generator

    gen = generator(seed, _SYNTH_STREAM, 0, device)
    centers = torch.randn((k_true, d), generator=gen, device=device) * 3.0
    lab = torch.randint(0, k_true, (n,), generator=gen, device=device)
    x = torch.empty((n, d), dtype=torch_dtype(dtype), device=device)
    for i in range(0, n, _SYNTH_CHUNK_ROWS):
        j = min(n, i + _SYNTH_CHUNK_ROWS)
        noise = torch.randn((j - i, d), generator=gen, device=device)
        x[i:j] = centers[lab[i:j]] + noise * 0.5
    return x


def _init_from_rows(X, k: int, seed: int):
    """Random-row init shared by both timed paths (keeps timing init-free)."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(X.shape[0], size=k, replace=False))
    return np.asarray(X[idx])


def _time_baseline_lloyd(X: np.ndarray, k: int, init: np.ndarray, iters: int) -> float:
    """Seconds per Lloyd iteration of the plain PyTorch step on the CPU
    (float32), after one warm-up step."""
    import torch

    x = torch.from_numpy(np.asarray(X, dtype=np.float32))
    c = torch.from_numpy(np.asarray(init, dtype=np.float32))
    _plain_lloyd_step(x, c)
    t0 = time.perf_counter()
    for _ in range(iters):
        c, _ = _plain_lloyd_step(x, c)
    return (time.perf_counter() - t0) / iters


#: Subtraction-based init timings below this fraction of the base pass are
#: below the harness's resolution and reported as None, never as 0.0.
INIT_TIMING_FLOOR_FRAC = 0.05


def _time_init(X, k: int, init, method: str, mesh_shape=None) -> float | None:
    """Seconds for one D²/k-means|| init (first launches excluded).

    Measured as (init + one label pass) minus a label pass from fixed
    centroids: ``max_iter=0`` skips the Lloyd loop in both.  None when the
    method cannot run at this shape (k-means|| per-round sample past the
    rows) or when the difference lies under ``INIT_TIMING_FLOOR_FRAC`` of
    the base pass.
    """
    from ..ops.kmeans import kmeans_full

    dev = X.device

    def timed(**kw):
        for _ in range(2):   # the first run is the warm-up
            t0 = time.perf_counter()
            kmeans_full(X, k, tol=0.0, seed=0, max_iter=0, mesh_shape=mesh_shape, **kw)
            _sync(dev)
        return time.perf_counter() - t0

    try:
        full = timed(init_method=method)
    except ValueError:
        return None
    base = timed(init_centroids=init)
    diff = full - base
    if diff <= INIT_TIMING_FLOOR_FRAC * base:
        return None
    return diff


def _time_lloyd(X, k: int, init, iters: int, mesh_shape=None, repeats: int = 5):
    """(best window seconds per iteration, every window's, the last
    window's centroids) of ``repeats`` windows of exactly ``iters`` Lloyd
    iterations from ``init``, after one warm-up window.  Best of N: noise
    on a shared host only adds."""
    from ..ops.kmeans import kmeans_full

    dev = X.device
    kw = dict(tol=0.0, seed=0, init_centroids=init, max_iter=iters, mesh_shape=mesh_shape)
    kmeans_full(X, k, **kw)
    _sync(dev)
    windows, c = [], None
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        c, _, it, _ = kmeans_full(X, k, **kw)
        _sync(dev)
        windows.append((time.perf_counter() - t0) / iters)
        if it != iters:
            raise RuntimeError(f"the Lloyd loop ran {it} of {iters} iterations at tol=0")
    return min(windows), windows, c


def _time_shift_readback(X, k: int, init, iters: int, mesh_shape=None,
                         rounds: int = 3) -> dict:
    """Seconds per iteration of a window of up to ``iters`` Lloyd
    iterations at ``tol=0`` (nothing read back until the end) and with the
    shift read back every iteration (``tol > 0``, as the pipeline's default
    1e-4 runs), best of ``rounds`` windows each in turns; ``readback_share``
    is the read's share of an iteration that makes it."""
    from ..ops.kmeans import kmeans_full

    dev = X.device
    best = {}
    for _ in range(rounds):
        for tol in (0.0, _READBACK_TOL):
            t0 = time.perf_counter()
            _, _, it, _ = kmeans_full(X, k, tol=tol, seed=0, init_centroids=init,
                                      max_iter=iters, mesh_shape=mesh_shape)
            _sync(dev)
            per = (time.perf_counter() - t0) / max(1, it)
            best[tol] = min(best.get(tol, per), per)
    quiet, read = best[0.0], best[_READBACK_TOL]
    return {"iters": iters, "sec_per_iter_tol0": quiet, "sec_per_iter_readback": read,
            "readback_share": (read - quiet) / read}


def _quality_run(n_files: int, duration: float, seed: int, init_method: str = "d2",
                 k: int = 8, device=None, init_centroids=None):
    """``run_pipeline(evaluate=True)`` at one decision-quality workload;
    ``init_centroids`` replaces the KMeans init."""
    from ..config import (GeneratorConfig, KMeansConfig, PipelineConfig, SimulatorConfig,
                          validated_scoring_config)
    from ..pipeline import run_pipeline

    return run_pipeline(PipelineConfig(
        device=device,
        generator=GeneratorConfig(n_files=n_files, seed=seed),
        simulator=SimulatorConfig(duration_seconds=duration, seed=seed + 1),
        kmeans=KMeansConfig(k=k, seed=42, init_method=init_method),
        scoring=validated_scoring_config(),
        evaluate=True,
    ), init_centroids=init_centroids)


def _quality_one(n_files: int, duration: float, seed: int, init_method: str = "d2",
                 k: int = 8, device=None) -> dict:
    result = _quality_run(n_files, duration, seed, init_method, k, device)
    ev = result.evaluation
    return {
        "n_files": n_files,
        "planted_accuracy": result.planted_accuracy,
        "read_locality_policy": ev["policy"]["read_locality"],
        "read_locality_uniform1": ev["uniform_1"]["read_locality"],
        "read_locality_gain": (ev["policy"]["read_locality"]
                               - ev["uniform_1"]["read_locality"]),
        "storage_vs_uniform1": (ev["policy"]["total_storage_bytes"]
                                / ev["uniform_1"]["total_storage_bytes"]),
    }


def decision_quality_metrics(seed: int = 21, device=None) -> dict:
    """Decision quality as tracked bench numbers: three seeded workloads
    (300 files/300 s, 2,000 files/600 s, 100,000 files/600 s) through
    ``run_pipeline(evaluate=True)`` with the validated scoring tables,
    planted-category recovery and the read-locality gain over uniform
    rf 1.  The larger ones guard against tables tuned to one tiny
    scenario."""
    out = _quality_one(300, 300.0, seed, device=device)
    out["at_2000_files"] = _quality_one(2000, 600.0, seed + 100, device=device)
    out["at_100000_files"] = _quality_one(100_000, 600.0, seed, device=device)
    return out


def downscaled_rows(n: int, row_bytes: int, ndev: int, budget: int) -> int:
    """Rows of a config whose points (``row_bytes`` a row, split over
    ``ndev`` devices) fit ``budget`` bytes a device: n halved until they
    fit, then rounded down to a multiple of ``ndev``."""
    n_run = n
    while n_run > 1 and (n_run // ndev) * row_bytes > budget:
        n_run //= 2
    if n_run != n:
        n_run = max(ndev, (n_run // ndev) * ndev)
    return n_run


def run_bench(config: int = 2, backend: str | None = None, seed: int = 0,
              mesh_shape: dict[str, int] | None = None, update: str | None = None,
              quality: bool = True, e2e: bool = False, dtype: str | None = None,
              device=None) -> dict:
    """Run one BASELINE config; returns the bench JSON dict.

    ``vs_baseline`` is the device path's iterations a second over the
    baseline's on the same workload (>= 1: faster than the plain version on
    the CPU).  Past ``direct_baseline_limit`` rows the baseline is timed on
    a subsample and scaled linearly in n (``baseline_estimated: true``).
    ``update`` takes only "auto" (the reference's option: the port's step
    is set by the device); the recorded ``update`` is the step that ran,
    "kernel" or "matmul".  ``e2e`` switches the metric to
    wall-clock time-to-categories.  ``device`` is the device path's (CUDA
    unless "cpu").
    """
    import torch

    from ..device import resolve_device, stat_dtype, torch_dtype
    from ..ops.kmeans import resolve_update

    cfg = CONFIGS[int(config)]
    backend = backend or cfg.backend
    if backend not in ("torch", BASELINE):
        raise ValueError(f"unknown backend {backend!r}: 'torch' (the device path) or "
                         f"{BASELINE!r} (the baseline alone)")
    if update not in (None, "auto"):
        raise ValueError(
            f"update={update!r}: the port has one Lloyd step a device (the CUDA kernel on a "
            f"card, its plain version on the CPU), so only 'auto' is taken; the TPU's "
            f"strategies have no counterpart")
    if dtype is not None:
        if backend == BASELINE:
            raise ValueError(f"--dtype selects the device path's points dtype; not "
                             f"applicable to --backend {BASELINE}")
        torch_dtype(dtype)
        cfg = dataclasses.replace(cfg, dtype=str(dtype))
    if int(config) == 5:
        if backend != "torch":
            raise ValueError(f"config 5 (streaming) is the device fold; --backend "
                             f"{BASELINE} is not supported")
        if dtype is not None:
            raise ValueError("--dtype applies to the Lloyd configs, not the "
                             "streaming fold (config 5)")
        before = _launches()
        result = _bench_streaming(cfg, seed, mesh_shape=mesh_shape, device=device)
        result["launches"] = _launches_since(before)
        if quality:
            result["decision_quality"] = decision_quality_metrics(device=device)
        return result
    if e2e and backend != "torch":
        raise ValueError(f"--e2e measures the device pipeline; --backend {BASELINE} is "
                         f"not supported")
    dev = None
    if backend == "torch":
        dev = resolve_device(device)
        if cfg.dtype == "float64" and dev.type == "cuda":
            raise ValueError("--dtype float64: the Lloyd kernel takes float32 or bfloat16 "
                             "points; float64 runs on the CPU only (--device cpu)")
        update = resolve_update("auto", dev, torch_dtype(cfg.dtype))
    before = _launches()
    quality_block = decision_quality_metrics(device=device) if quality else None

    result: dict = {}
    if not e2e:
        base_iters = max(2, min(3, cfg.iters))
        # The subsample guard applies whatever the backend: the baseline's
        # host memory is bounded too.
        if cfg.n <= cfg.direct_baseline_limit:
            X_np = synth_blobs_np(cfg.n, cfg.d, min(cfg.k, 64), seed)
            sub, scale, estimated = X_np, 1.0, False
        else:
            n_sub = cfg.direct_baseline_limit // 4
            X_np = None
            sub = synth_blobs_np(n_sub, cfg.d, min(cfg.k, 64), seed)
            scale, estimated = cfg.n / n_sub, True
        init_np = _init_from_rows(sub, cfg.k, seed)
        base_ips = 1.0 / (_time_baseline_lloyd(sub, cfg.k, init_np, base_iters) * scale)
        del sub
        result = {"config": int(config), "n": cfg.n, "d": cfg.d, "k": cfg.k,
                  "baseline_iters_per_sec": base_ips, "baseline_estimated": estimated,
                  "baseline": BASELINE}
        if quality_block is not None:
            result["decision_quality"] = quality_block

    if backend == BASELINE:
        result.update({
            "metric": f"lloyd_iters_per_sec_n{cfg.n}_d{cfg.d}_k{cfg.k}",
            "value": base_ips,
            "unit": "iter/s",
            "vs_baseline": 1.0,
            "backend": BASELINE,
        })
        return result

    mesh_shape = mesh_shape or cfg.mesh_dict()
    avail = _device_count(dev)
    # Points are split over the data axis only (replicated over the model
    # axis), so a device holds its data shard's rows.
    ndev = max(1, min(int((mesh_shape or {}).get("data", 1)), avail))
    memory = _device_memory(dev)
    if memory is not None:
        budget = int(memory * POINTS_BUDGET_SHARE)
        result["points_budget_bytes"] = budget
        n_cfg = cfg.n
        n_run = downscaled_rows(n_cfg, cfg.d * torch_dtype(cfg.dtype).itemsize, ndev, budget)
        if n_run != n_cfg:
            # The metric name carries the n that ran; n_downscaled_from the config's.
            cfg = dataclasses.replace(cfg, n=n_run)
            result["n_downscaled_from"] = n_cfg
            result["n"] = n_run
            if not e2e:
                # The baseline was scaled to the config's n; rescale to the n run.
                base_ips = base_ips * (n_cfg / n_run)
                result["baseline_iters_per_sec"] = base_ips
                result["baseline_estimated"] = True
    if mesh_shape:
        need = int(np.prod(list(mesh_shape.values())))
        if need > avail:
            # The mesh scaled down to the devices present: the largest power
            # of two <= their count that divides the rows.
            ndata = 1 << (avail.bit_length() - 1)
            while ndata > 1 and cfg.n % ndata:
                ndata //= 2
            mesh_shape = {"data": ndata}
            result["mesh_downscaled_to"] = mesh_shape

    if e2e:
        out = _bench_e2e(cfg, int(config), seed, mesh_shape, update, dev)
        for key in ("points_budget_bytes", "mesh_downscaled_to", "n_downscaled_from"):
            if key in result:
                out[key] = result[key]
        if quality_block is not None:
            out["decision_quality"] = quality_block
        out["launches"] = _launches_since(before)
        return out

    acc = stat_dtype(torch_dtype(cfg.dtype))
    if X_np is not None:
        # The matrix staged on the device once, outside the timed region:
        # the metric is the steady iteration rate, as the baseline's data
        # is resident in host memory.
        X = torch.from_numpy(X_np).to(device=dev, dtype=torch_dtype(cfg.dtype))
        # Both paths start from the same centroids, staged once too.
        init = torch.from_numpy(init_np).to(device=dev, dtype=acc)
        del X_np
    else:
        X = _synth_blobs_device(cfg.n, cfg.d, min(cfg.k, 64), seed, cfg.dtype, dev)
        init = X[: cfg.k].to(acc)
    _sync(dev)

    sec, windows, _ = _time_lloyd(X, cfg.k, init, cfg.iters, mesh_shape)
    ips = 1.0 / sec
    # Every window's rate (the best is the headline; the spread is host noise).
    result["window_iters_per_sec"] = [1.0 / w for w in windows]
    result["window_iters_per_sec_median"] = float(1.0 / np.median(windows))
    result["shift_readback"] = _time_shift_readback(X, cfg.k, init, max(1, cfg.iters // 10),
                                                    mesh_shape)
    # The init's cost (D² is k sequential rounds); None = not measurable or
    # not runnable at this shape, never 0.0.
    for method, field in (("d2", "init_seconds_d2"),
                          ("kmeans||", "init_seconds_kmeans_par")):
        result[field] = _time_init(X, cfg.k, init, method, mesh_shape)
    result.update({
        "metric": f"lloyd_iters_per_sec_n{cfg.n}_d{cfg.d}_k{cfg.k}",
        "value": ips,
        "unit": "iter/s",
        "vs_baseline": ips / base_ips,
        "backend": "torch",
        "update": update,
        "dtype": cfg.dtype,
        "chunk_rows": None,
        **_device_stamp(dev),
        "launches": _launches_since(before),
    })
    return result
