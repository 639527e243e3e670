"""Command line of the PyTorch port: ``python -m cdrs_tpu_torch <command>``.

* ``gen`` and ``simulate`` make a manifest and an access log on the host
  (``simulate --out x.cdrsb`` writes the binary columnar log;
  ``--engine native`` runs the host library's threaded generator);
* ``features``, ``cluster`` and ``evaluate`` are the staged batch path:
  manifest and log to the features CSV (on the device), features CSV to
  ``final_categories.csv`` and the per-file assignments (KMeans and
  scoring on the device), assignments to the policy-vs-baselines replay
  (host) with the exportable plan and ``hdfs dfs -setrep`` script;
* ``pipeline`` runs generator to decision in one process (``--evaluate``
  adds the replay);
* ``stream`` folds an access log in batches, then clusters (full-batch, or
  mini-batch with ``--kmeans_batch``);
* ``control`` runs the online replication controller over an access log
  and prints its JSON summary;
* ``daemon`` runs the controller as the always-on streaming daemon over a
  ``.cdrsb`` log (once, or following it as it grows) and prints its digest;
* ``chaos`` runs the controller with a fault schedule (node crashes,
  partitions, stragglers, silent corruption), rack or geo failure domains,
  repairs and the scrubber, and prints the summary with its
  ``durability`` block;
* ``control``, ``daemon`` and ``chaos`` take ``--serve``: every window's
  reads route through the read router and hotspots trigger re-clusters;
  ``--storage_config``: categories map to replicate or erasure-coded
  strategies on storage tiers; and ``--placement``: the rng chooser over a
  dense map (``materialized``), the stateless hash chooser over the
  overlay state with sparse checkpoints (``functional``), or the hash
  chooser over a dense map (``materialized_hash``, its oracle);
* ``storage show|estimate`` resolves a storage config per category, or
  estimates its bytes and cost over a manifest and a category table;
* ``serve`` replays the log's reads against a static placement (or a
  faulted cluster state; ``--placement functional`` resolves each
  window's rows through the hash chooser) through the read router, on the
  host, and prints the serving digest;
* ``scenarios list|run|sweep`` runs cells of the scenario matrix, each
  gated on invariants (a failing cell prints its repro line);
  ``scenarios search`` grows the matrix by coverage-guided mutation and
  banks new cells and shrunk violations in a corpus, and ``scenarios
  triage`` reruns the banked violations as regression-locked cells;
* ``bench`` runs one BASELINE config of the benchmark harness
  (``benchmarks/harness.py``) and prints its detail JSON;
* ``metrics summarize|tail|export|report|watch|alerts`` reads a telemetry
  stream (``obs/metrics_cli.py``), ``metrics regress`` holds a bench run
  against its trajectory bands (``benchmarks/regress.py``),
  ``trace list|show|export`` the daemon's
  decision traces (``obs/trace.py``), and ``status HOST:PORT`` a live
  daemon's ``/statusz`` with its probes;
* ``explain file|category|window`` rebuilds a decision's provenance from a
  telemetry stream and a controller checkpoint (``obs/explain.py``).

The flags are those of ``cdrs_tpu``'s subcommands of the same names that
this port supports, plus ``--device`` (CUDA unless "cpu" is asked for).
``--mesh`` ('8' or 'data=4,model=2') runs ``features``, ``cluster``,
``pipeline``, ``stream`` and the controller family on a mesh of shards
(``parallel/mesh.py``).  ``--metrics FILE`` on ``cluster``, ``pipeline``,
``stream``, ``control``, ``daemon``, ``chaos`` and ``serve`` activates the
ambient instrument (``obs/``) over one JSONL stream with one root span per
command: stage spans, counters, histograms, the kmeans convergence
traces, the kernels' calls and costs, and the window records of the
controller family (``--metrics_max_bytes`` rotates it,
``--device_memory`` adds the card's memory gauges at every span's end).
``pipeline --profile DIR`` writes a ``torch.profiler`` Chrome trace.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

from .config import (GeneratorConfig, KMeansConfig, PipelineConfig, ScoringConfig,
                     SimulatorConfig, load_scoring_config, validated_scoring_config)
from .utils.logging import StageTimer

__all__ = ["main", "build_parser"]


def _load_scoring(args) -> ScoringConfig:
    """--scoring_config ("validated" or a JSON path) with --medians_from_data
    applied on top."""
    medians_from_data = getattr(args, "medians_from_data", False)
    if args.scoring_config:
        cfg = (validated_scoring_config() if args.scoring_config == "validated"
               else load_scoring_config(args.scoring_config))
        if medians_from_data:
            cfg = dataclasses.replace(cfg, compute_global_medians_from_data=True)
        return cfg
    return ScoringConfig(compute_global_medians_from_data=medians_from_data)


def _open_telemetry(args, stack, root_span: str):
    """Activate a ``Telemetry`` over the ``--metrics`` JSONL sink (None
    without the flag), with one root span ``root_span`` for the command,
    both owned by the ``contextlib.ExitStack`` ``stack``."""
    path = getattr(args, "metrics", None)
    if not path:
        return None
    from .obs import JsonlSink, Telemetry

    tel = Telemetry(JsonlSink(path, max_bytes=args.metrics_max_bytes),
                    device_memory=args.device_memory)
    stack.enter_context(tel)
    stack.enter_context(tel.span(root_span, device=getattr(args, "device", None)))
    return tel


def _parse_mesh(spec: str) -> dict[str, int]:
    """``--mesh``'s type: '8' (the data axis) or 'data=4,model=2', checked
    by ``validate_mesh_shape``; a bad value is a usage error (exit 2)."""
    from .parallel.mesh import validate_mesh_shape

    try:
        if "=" not in spec:
            return validate_mesh_shape({"data": int(spec)})
        return validate_mesh_shape({k.strip(): int(v) for k, v in
                                    (part.split("=") for part in spec.split(","))})
    except ValueError as e:
        raise argparse.ArgumentTypeError(
            f"{e} (--mesh takes '8' or 'data=4,model=2')") from None


def _cmd_pipeline(args) -> int:
    from .pipeline import run_pipeline
    from .utils.profiling import trace_region

    cfg = PipelineConfig(
        device=args.device,
        dtype="float64" if args.dtype == "float64" else "float32",
        generator=GeneratorConfig(n_files=args.n, seed=args.seed),
        simulator=SimulatorConfig(duration_seconds=args.duration_seconds,
                                  seed=None if args.seed is None else args.seed + 1),
        kmeans=KMeansConfig(k=args.k, seed=args.seed, init_method=args.init_method,
                            dtype=args.dtype),
        scoring=_load_scoring(args),
        evaluate=args.evaluate,
        mesh_shape=args.mesh,
    )
    with contextlib.ExitStack() as stack:
        _open_telemetry(args, stack, "pipeline")
        with trace_region(args.profile):
            result = run_pipeline(cfg, outdir=args.outdir)
    print(json.dumps(result.summary(), indent=2))
    return 0


def _cmd_gen(args) -> int:
    from .sim.generator import generate_population

    cfg = GeneratorConfig(n_files=args.n, base_dir=args.hdfs_dir, min_size=args.min_size,
                          max_size=args.max_size, nodes=tuple(args.nodes.split(",")),
                          age_days_max=args.age_days_max, seed=args.seed,
                          write_payloads=args.write_payloads)
    t0 = time.perf_counter()
    manifest = generate_population(cfg)
    manifest.write_csv(args.out_manifest)
    print(f"Wrote {args.out_manifest} ({len(manifest)} files) in "
          f"{time.perf_counter() - t0:.2f}s")
    return 0


def _cmd_simulate(args) -> int:
    from .io.events import Manifest
    from .sim.access import simulate_access

    cfg = SimulatorConfig(duration_seconds=args.duration_seconds,
                          clients=tuple(args.clients.split(",")), seed=args.seed)
    fmt = args.format
    if fmt == "auto":
        fmt = "binary" if args.out.endswith(".cdrsb") else "csv"
    t0 = time.perf_counter()
    manifest = Manifest.read_csv(args.manifest)
    events = simulate_access(manifest, cfg, engine=args.engine)
    if fmt == "binary":
        events.write_binary(args.out, manifest)
    else:
        events.write_csv(args.out, manifest)
    print(f"Wrote {args.out} with {len(events)} entries in {time.perf_counter() - t0:.2f}s")
    return 0


def _cmd_features(args) -> int:
    """Manifest + access log (CSV or ``.cdrsb``) -> the features CSV; the
    features are computed on the device.  An ``--out`` that is a directory
    (or ends in a separator) gets ``part-00000-features.csv``."""
    from .device import deterministic
    from .features.batch import compute_features_torch
    from .io.events import EventLog, Manifest

    t0 = time.perf_counter()
    manifest = Manifest.read_csv(args.manifest)
    events = EventLog.read_csv(args.access_log, manifest)
    with deterministic():
        table = compute_features_torch(manifest, events, device=args.device,
                                       mesh_shape=args.mesh)
    out = args.out
    if os.path.isdir(out) or out.endswith(os.sep):
        os.makedirs(out, exist_ok=True)
        out = os.path.join(out, "part-00000-features.csv")
    else:
        parent = os.path.dirname(out)
        if parent:
            os.makedirs(parent, exist_ok=True)
    table.write_csv(out)
    print(f"Wrote features to {out} in {time.perf_counter() - t0:.2f}s")
    return 0


def _cmd_cluster(args) -> int:
    """Features CSV -> KMeans++ and scoring on the device ->
    ``final_categories.csv`` (and the per-file ``--assignments_csv``)."""
    import torch

    from .device import deterministic, resolve_device
    from .io.features import load_feature_matrix
    from .models.replication import ReplicationPolicyModel

    dev = resolve_device(args.device)
    model = ReplicationPolicyModel(
        kmeans_cfg=KMeansConfig(k=args.k, seed=args.seed, init_method=args.init_method,
                                dtype=args.dtype),
        scoring_cfg=_load_scoring(args), mesh_shape=args.mesh)
    with contextlib.ExitStack() as stack:
        _open_telemetry(args, stack, "cluster_cmd")
        with StageTimer("cluster") as t:
            X, paths = load_feature_matrix(args.input_path)
            # The features' float32 table, as the pipeline hands it to
            # clustering; float64 keeps the CSV's values unrounded.
            dtype = torch.float64 if args.dtype == "float64" else torch.float32
            with deterministic():
                decision = model.run(torch.as_tensor(X, dtype=dtype).to(dev))
            decision.write_csv(args.output_csv)
            if args.assignments_csv:
                decision.write_assignments_csv(args.assignments_csv, paths)
    print(f"Cluster centroid assignments ({args.k} clusters) saved to: "
          f"{args.output_csv} in {t.elapsed:.2f}s")
    return 0


def _cmd_evaluate(args) -> int:
    """Place the decided rf of an assignments table on the simulated
    cluster and replay the log against it and against uniform baselines
    (host numpy); optionally export the plan and its setrep script."""
    import numpy as np

    from .cluster.evaluate import compare_policies
    from .cluster.placement import ClusterTopology
    from .io.events import EventLog, Manifest

    manifest = Manifest.read_csv(args.manifest)
    events = EventLog.read_csv(args.access_log, manifest)
    # The scoring config the assignments were made with: its rf table.
    scoring = _load_scoring(args)
    rf = np.full(len(manifest), args.default_rf, dtype=np.int32)
    want_plan = bool(args.emit_plan or args.emit_setrep)
    plan_rows: list[tuple[str, str]] = []
    pairs = _read_assignments(manifest, args.assignments_csv, scoring.replication_factors)
    if pairs is None:
        return 1
    for i, c in pairs:
        rf[i] = scoring.replication_factors[c]
        if want_plan:
            plan_rows.append((manifest.paths[i], c))
    if want_plan:
        from .cluster.plan import build_plan, write_plan_csv, write_setrep_script

        entries = build_plan([p for p, _ in plan_rows], [c for _, c in plan_rows], scoring)
        if args.emit_plan:
            write_plan_csv(args.emit_plan, entries)
            print(f"plan: {len(entries)} files -> {args.emit_plan}", file=sys.stderr)
        if args.emit_setrep:
            n = write_setrep_script(args.emit_setrep, entries)
            print(f"setrep script: {n} commands -> {args.emit_setrep}", file=sys.stderr)
    nodes = tuple(args.nodes.split(",")) if args.nodes else tuple(manifest.nodes)
    out = compare_policies(manifest, events, rf, topology=ClusterTopology(nodes=nodes))
    print(json.dumps(out, indent=2))
    return 0


def _cmd_stream(args) -> int:
    """Fold the access log in batches on the device, finalize the features,
    then cluster and score them there."""
    from .device import deterministic
    from .features.streaming import fold_stream, stream_finalize
    from .io.events import Manifest
    from .models.replication import ReplicationPolicyModel

    if args.kmeans_batch is not None and args.kmeans_batch < 1:
        print(f"error: --kmeans_batch must be >= 1, got {args.kmeans_batch}",
              file=sys.stderr)
        return 1
    mesh_shape = args.mesh
    model = ReplicationPolicyModel(
        kmeans_cfg=KMeansConfig(k=args.k, seed=args.seed, batch_size=args.kmeans_batch,
                                init_method=args.init_method),
        scoring_cfg=_load_scoring(args), mesh_shape=mesh_shape)
    stats: dict = {}
    with contextlib.ExitStack() as stack, deterministic():
        tel = _open_telemetry(args, stack, "stream_cmd")
        with StageTimer("stream") as t:
            manifest = Manifest.read_csv(args.manifest)
            state = fold_stream(args.access_log, manifest, device=args.device,
                                batch_size=args.batch_size, stats=stats,
                                checkpoint_path=args.checkpoint,
                                checkpoint_every=args.checkpoint_every, mesh_shape=mesh_shape)
            table = stream_finalize(state, manifest)
        if args.checkpoint and stats["resumed_from_offset"]:
            print(f"Resumed from checkpoint at byte {stats['resumed_from_offset']}")
        print(f"Streamed {state.n_events} events in {stats['batches']} batches "
              f"({t.elapsed:.2f}s)")
        if tel is not None:
            # Ingest rate, the stream path's headline number.
            if t.elapsed > 0:
                tel.gauge("stream.events_per_sec", state.n_events / t.elapsed)
            tel.counter_inc("stream.events", int(state.n_events))
            tel.counter_inc("stream.batches", int(stats["batches"]))
        t0 = time.perf_counter()
        decision = model.run(table.norm)
        decision.write_csv(args.output_csv)
    mode = f"mini-batch({args.kmeans_batch})" if args.kmeans_batch else "full-batch"
    print(f"Cluster centroid assignments ({args.k} clusters, {mode}) saved to: "
          f"{args.output_csv} in {time.perf_counter() - t0:.2f}s")
    return 0


def _controller_cfg(args, fault_schedule=None, topology=None):
    """ControllerConfig from the ``control``/``chaos`` arguments."""
    from .control.controller import ControllerConfig

    scrub = None
    if getattr(args, "scrub", None):
        from .faults import ScrubConfig

        scrub = ScrubConfig(bytes_per_window=args.scrub)
    serve = None
    if args.serve:
        from .serve import ServeConfig, SloSpec

        serve = ServeConfig(
            policy=args.serve_policy, seed=args.serve_seed, service_ms=args.serve_service_ms,
            slo=SloSpec(target_ms=args.serve_slo_ms, availability=args.serve_slo_availability),
            recluster_on_hotspot=not args.no_hotspot_recluster,
            verify_reads=not getattr(args, "no_verify_reads", False))
    scoring = _load_scoring(args)
    storage = None
    if args.storage_config:
        from .storage import resolve_storage_config

        storage = resolve_storage_config(args.storage_config, scoring)
    return ControllerConfig(
        window_seconds=args.window_seconds, drift_threshold=args.drift_threshold,
        full_recluster_drift=args.full_drift, warm_max_iter=args.warm_max_iter,
        max_bytes_per_window=args.max_bytes, max_files_per_window=args.max_files,
        hysteresis_windows=args.hysteresis, decay=args.decay, default_rf=args.default_rf,
        kmeans=KMeansConfig(k=args.k, seed=args.seed, init_method=args.init_method),
        scoring=scoring, evaluate=not args.no_evaluate,
        overlap_windows=args.overlap, device=args.device, fault_schedule=fault_schedule,
        repair_seed=getattr(args, "repair_seed", 0), topology=topology, scrub=scrub,
        serve=serve, storage=storage, placement_mode=args.placement,
        mesh_shape=args.mesh)


def _cmd_control(args, manifest=None, cfg=None, root_span: str = "control_cmd") -> int:
    """Online replication controller: the log as time windows, drift-gated
    re-clusters, bounded-churn migrations (control/controller.py); ``chaos``
    passes its manifest, fault-path config and root span."""
    from .control.controller import ReplicationController
    from .io.events import Manifest

    if manifest is None:
        manifest = Manifest.read_csv(args.manifest)
    controller = ReplicationController(manifest, cfg or _controller_cfg(args))
    with contextlib.ExitStack() as stack:
        # One stream: the window records ride the instrument's sink.
        _open_telemetry(args, stack, root_span)
        with StageTimer(root_span) as t:
            result = controller.run(args.access_log, metrics_path=args.metrics,
                                    metrics_max_bytes=args.metrics_max_bytes,
                                    checkpoint_path=args.checkpoint,
                                    checkpoint_every=args.checkpoint_every,
                                    max_windows=args.max_windows, batch_size=args.batch_size)
    elapsed = t.elapsed
    if args.plan_out:
        from .cluster.plan import write_plan_csv

        write_plan_csv(args.plan_out, result.plan_entries())
        print(f"plan: {len(manifest)} files -> {args.plan_out}", file=sys.stderr)
    out = result.summary()
    out["seconds"] = round(elapsed, 3)
    print(json.dumps(out, indent=2))
    return 0


def _cmd_chaos(args) -> int:
    """The controller with a fault schedule built from the fault flags,
    ``--schedule`` and ``--random_faults``, on the ``--racks`` or
    ``--topology`` failure domains."""
    from .cluster.placement import ClusterTopology
    from .faults import FaultSchedule
    from .io.events import Manifest

    manifest = Manifest.read_csv(args.manifest)
    topology = None
    if args.topology:
        if args.racks:
            print("error: --topology and --racks are mutually exclusive (the hierarchy "
                  "spec subsumes the rack map)", file=sys.stderr)
            return 2
        text = args.topology
        if not text.lstrip().startswith("{"):
            with open(text, encoding="utf-8") as f:
                text = f.read()
        try:
            topology = ClusterTopology.from_hierarchy(json.loads(text))
        except ValueError as e:
            print(f"error: bad --topology spec: {e}", file=sys.stderr)
            return 2
        unknown = sorted(set(manifest.nodes) - set(topology.nodes))
        if unknown:
            print(f"error: --topology is missing manifest nodes {unknown}", file=sys.stderr)
            return 2
    elif args.racks:
        topology = ClusterTopology.from_rack_spec(manifest.nodes, args.racks)
    events = []
    for kind, flag in (("crash", args.kill), ("recover", args.recover),
                       ("decommission", args.decommission), ("flaky", args.flaky),
                       ("partition", args.partition), ("degrade", args.degrade),
                       ("corrupt", args.corrupt)):
        for spec in flag or ():
            events.extend(FaultSchedule.from_specs([f"{kind}:{spec}"]))
    if args.schedule:
        with open(args.schedule, encoding="utf-8") as f:
            events.extend(FaultSchedule.from_json(json.load(f)))
    if args.random_faults:
        events.extend(FaultSchedule.random(manifest.nodes, n_windows=args.random_faults,
                                           seed=args.fault_seed,
                                           corrupt_rate=args.corrupt_rate,
                                           corrupt_frac=args.corrupt_frac))
    if not events:
        print("error: chaos needs at least one fault (--kill/--recover/--decommission/"
              "--flaky/--partition/--degrade/--corrupt/--schedule/--random_faults)",
              file=sys.stderr)
        return 1
    schedule = FaultSchedule(events)
    if args.schedule_out:
        with open(args.schedule_out, "w", encoding="utf-8") as f:
            json.dump(schedule.to_json(), f, indent=2)
            f.write("\n")
        print(f"schedule: {len(schedule)} events -> {args.schedule_out}", file=sys.stderr)
    return _cmd_control(args, manifest, _controller_cfg(args, schedule, topology),
                        "chaos_cmd")


def _read_assignments(manifest, path, categories):
    """``(file id, category)`` pairs of an assignments CSV (path,category,...)
    matched against the manifest; None (with an error) when rows exist but
    none matched, a warning when some did not."""
    import csv

    pairs, rows = [], 0
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            rows += 1
            i = manifest.path_to_id.get(row.get("path"))
            c = row.get("category")
            if i is not None and c in categories:
                pairs.append((i, c))
    if rows and not pairs:
        print(f"error: no row of {path} matched a manifest path with a known category — "
              f"is this the cluster --assignments_csv output?", file=sys.stderr)
        return None
    if len(pairs) < rows:
        print(f"warning: {rows - len(pairs)}/{rows} assignment rows ignored (unknown path "
              f"or category)", file=sys.stderr)
    return pairs


def _cmd_storage(args) -> int:
    """Storage strategies offline: the per-category resolution of a config
    (``show``), or its bytes and cost over a manifest and a category table
    against the scoring rf table's replicate baseline (``estimate``).  The
    stdout JSON is the reference's.  Host numpy: no device."""
    import numpy as np

    from .config import CATEGORIES
    from .io.events import Manifest
    from .storage import resolve_storage_config

    scoring = _load_scoring(args)
    cfg = resolve_storage_config(args.storage_config, scoring)
    rows = cfg.describe(CATEGORIES, scoring.replication_factors)
    if args.action == "show":
        print(json.dumps({
            "storage_config": args.storage_config,
            "pure_replication": cfg.pure_replication,
            "default_tier": cfg.default_tier,
            "tiers": cfg.to_dict()["tiers"],
            "categories": rows,
        }, indent=2))
        return 0
    if not args.manifest or not args.assignments_csv:
        print("error: storage estimate needs --manifest and --assignments_csv (the "
              "cluster/control per-file path,cluster,category table)", file=sys.stderr)
        return 1
    manifest = Manifest.read_csv(args.manifest)
    sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
    cat_idx = {c: i for i, c in enumerate(CATEGORIES)}
    cat = np.full(len(manifest), -1, dtype=np.int64)
    pairs = _read_assignments(manifest, args.assignments_csv, cat_idx)
    if pairs is None:
        return 1
    for i, c in pairs:
        cat[i] = cat_idx[c]
    rf_vec = np.asarray([scoring.replication_factors[c] for c in CATEGORIES], dtype=np.int64)
    by_cat = []
    tot = {"raw": 0, "stored": 0, "cost": 0.0, "baseline": 0}
    for ci, c in enumerate(CATEGORIES):
        sel = cat == ci
        if not sel.any():
            continue
        st = cfg.strategy_for(c, scoring.replication_factors.get(c))
        raw = int(sizes[sel].sum())
        stored = int((-(-sizes[sel] // st.shard_div) * st.n_shards).sum())
        cost = stored * cfg.tiers[st.tier].byte_cost
        baseline = int(raw * rf_vec[ci])
        by_cat.append({
            "category": c, "files": int(sel.sum()), "strategy": st.spec(),
            "bytes_raw": raw, "bytes_stored": stored, "cost_units": round(cost, 3),
            "bytes_replicate_baseline": baseline,
            "bytes_saved_vs_baseline": baseline - stored,
        })
        tot["raw"] += raw
        tot["stored"] += stored
        tot["cost"] += cost
        tot["baseline"] += baseline
    print(json.dumps({
        "storage_config": args.storage_config,
        "note": "logical estimate — shard counts are not capped at the node count "
                "(a live run's `storage` record is)",
        "files": len(manifest), "files_categorized": len(pairs),
        "per_category": by_cat,
        "bytes_raw": tot["raw"], "bytes_stored": tot["stored"],
        "cost_units": round(tot["cost"], 3),
        "bytes_replicate_baseline": tot["baseline"],
        "stored_vs_baseline_ratio": round(tot["baseline"] / tot["stored"], 4)
        if tot["stored"] else None,
    }, indent=2))
    return 0


def _cmd_serve(args) -> int:
    """Read-path SLO replay: the log's reads, window by window, through the
    read router against the static placement of ``--default_rf`` (the rng
    or, with ``--placement``, the hash chooser; ``functional`` computes
    only each window's files' rows) or, with fault flags, a
    ``ClusterState`` they mutate, with hotspot scoring; prints the serving
    digest.  Host numpy: no device, no kernel."""
    import numpy as np

    from .cluster.evaluate import _client_to_topology
    from .cluster.placement import ClusterTopology, place_replicas, primary_on_topology
    from .control.windows import iter_windows
    from .faults import ClusterState, FaultSchedule
    from .io.events import Manifest
    from .obs.aggregate import serve_digest
    from .serve import (HotspotDetector, ReadRouter, ServeConfig, SloSpec,
                        emit_window_telemetry, read_view)

    manifest = Manifest.read_csv(args.manifest)
    topology = ClusterTopology(nodes=tuple(manifest.nodes))
    if args.racks:
        topology = ClusterTopology.from_rack_spec(manifest.nodes, args.racks)
    serve_cfg = ServeConfig(
        policy=args.policy, seed=args.seed, service_ms=args.service_ms,
        slo=SloSpec(target_ms=args.slo_ms, availability=args.slo_availability),
        verify_reads=not args.no_verify_reads)
    rf = np.full(len(manifest), args.default_rf, dtype=np.int32)
    events = []
    for kind, flag in (("crash", args.kill), ("partition", args.partition),
                       ("degrade", args.degrade), ("corrupt", args.corrupt)):
        for spec in flag or ():
            events.extend(FaultSchedule.from_specs([f"{kind}:{spec}"]))
    schedule = FaultSchedule(events) if events else None
    method = "rng" if args.placement == "materialized" else "hash"
    placement = state = resolver = None
    if schedule is not None:
        # Faults need the mutable state; the hash modes swap its chooser.
        placement = place_replicas(manifest, rf, topology, seed=0, method=method)
        schedule.validate_nodes(topology.nodes)
        state = ClusterState(placement, np.asarray(manifest.size_bytes, dtype=np.int64))
    elif args.placement == "functional":
        # No map at all: each window resolves only its own files' rows.
        from .placement_fn import compute_placement

        primary = primary_on_topology(manifest.nodes, manifest.primary_node_id, topology)

        def resolver(uniq):
            return compute_placement(uniq, rf[uniq], primary[uniq], topology, 0)[0]
    else:
        placement = place_replicas(manifest, rf, topology, seed=0, method=method)
    router = ReadRouter(len(topology), serve_cfg)
    hotspot = HotspotDetector(len(manifest), alpha=serve_cfg.hotspot_alpha,
                              spike_factor=serve_cfg.hotspot_spike_factor,
                              min_reads=serve_cfg.hotspot_min_reads,
                              top_k=serve_cfg.hotspot_top_k)
    records: list[dict] = []
    with contextlib.ExitStack() as stack:
        # The window records ride the instrument's stream ("kind": "window").
        tel = _open_telemetry(args, stack, "serve_cmd")
        t = stack.enter_context(StageTimer("serve"))
        for w, ev in iter_windows(args.access_log, manifest, args.window_seconds,
                                  batch_size=args.batch_size):
            if args.max_windows is not None and len(records) >= args.max_windows:
                break
            if state is not None:
                for fev in schedule.for_window(w):
                    state.apply_event(fev)
            rec: dict = {"window": int(w), "n_events": int(len(ev))}
            if len(ev):
                keep = ev.path_id >= 0
                is_read = np.asarray(ev.op)[keep] == 0
                pid = ev.path_id[keep][is_read]
                hs = hotspot.observe(np.bincount(pid, minlength=len(manifest)))
                view = read_view(pid, state=state, resolver=resolver, placement=placement,
                                 n_nodes=len(topology))
                res = router.route(
                    view.replica_map, view.slot_ok, view.node_throughput,
                    ts=ev.ts[keep][is_read], pid=view.pid,
                    client=_client_to_topology(ev, topology)[keep][is_read],
                    window_seconds=args.window_seconds,
                    rng=np.random.default_rng([args.seed, int(w)]),
                    slot_corrupt=view.slot_corrupt)
                if res.corrupt_pairs is not None and len(res.corrupt_pairs):
                    # Detect-on-read: drop the rotten copies the reads found.
                    for fid, node in res.corrupt_pairs:
                        state.quarantine(int(fid), int(node))
                rec["n_reads"] = res.n_reads
                rec.update(res.record_fields())
                rec["hotspot_score"] = round(hs.score, 6)
                rec["hotspot_files"] = list(hs.files)
                if tel is not None:
                    emit_window_telemetry(tel, rec, res.latency_ms)
            records.append(rec)
            if tel is not None:
                tel._emit({"kind": "window", **rec})
    elapsed = t.elapsed
    out = serve_digest(records) or {"windows": len(records), "reads_routed": 0}
    out["policy"] = args.policy
    out["seconds"] = round(elapsed, 3)
    if out.get("reads_routed"):
        out["routed_reads_per_sec"] = round(out["reads_routed"] / max(elapsed, 1e-9), 1)
    print(json.dumps(out, indent=2))
    return 0


def _cmd_metrics(args) -> int:
    """Inspect a telemetry JSONL stream (obs/metrics_cli.py)."""
    from .obs.metrics_cli import main as metrics_main

    return metrics_main(args.rest)


def _cmd_explain(args) -> int:
    """Decision provenance (obs/explain.py), offline from a telemetry stream
    and a checkpoint."""
    from .obs.explain import main as explain_main

    return explain_main(args.rest)


def _cmd_trace(args) -> int:
    """The daemon's decision traces (obs/trace.py): list slowest first,
    show one span tree, export Chrome/Perfetto JSON."""
    from .obs.trace import main as trace_main

    return trace_main(args.rest)


def _cmd_status(args) -> int:
    """One-shot reader of a live daemon's /statusz (obs/httpz.py) with the
    /readyz and /healthz verdicts; exit 1 when it is unreachable."""
    import urllib.error
    import urllib.request

    from .obs.metrics_cli import base_url, fetch_statusz, statusz_lines

    base = base_url(args.url)
    try:
        doc = fetch_statusz(base)
    except (OSError, ValueError) as e:
        print(f"error: {base} unreachable: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(doc, sort_keys=True, indent=1))
        return 0
    for line in statusz_lines(base, doc):
        print(line)
    for probe in ("/readyz", "/healthz"):
        try:
            with urllib.request.urlopen(base + probe, timeout=5) as r:
                body = r.read().decode("utf-8").strip()
                code = r.status
        except urllib.error.HTTPError as e:
            body = e.read().decode("utf-8").strip()
            code = e.code
        except OSError as e:
            body, code = str(e), None
        print(f"{probe}:  {code} {body}")
    return 0


def _supervised_child(argv: list[str]) -> list[str]:
    """``argv`` without the supervision flags, so that the child does not
    supervise in turn."""
    child, skip = [], False
    for tok in argv:
        if skip:
            skip = False
        elif tok in ("--supervise", "--max_restarts"):
            skip = tok == "--max_restarts"
        elif not tok.startswith("--max_restarts="):
            child.append(tok)
    return child


def _cmd_daemon(args) -> int:
    """The streaming daemon (daemon/): tail the ``.cdrsb`` log, decide per
    window, publish epoch-pinned placements, checkpoint with the ingest
    cursor so that SIGTERM and a rerun resume bit-identically."""
    from .control.controller import ReplicationController
    from .daemon import BrownoutConfig, DaemonConfig, StreamDaemon, supervise
    from .io.events import Manifest

    if args.supervise:
        return supervise([sys.executable, "-m", "cdrs_tpu_torch"]
                         + _supervised_child(args.argv), max_restarts=args.max_restarts)
    brownout = None
    if args.brownout:
        kw = {}
        if args.brownout_engage:
            kw["engage"] = tuple(float(x) for x in args.brownout_engage.split(","))
        if args.brownout_release:
            kw["release"] = tuple(float(x) for x in args.brownout_release.split(","))
        if args.shed_fraction is not None:
            kw["shed_fraction"] = args.shed_fraction
        brownout = BrownoutConfig(**kw)
    manifest = Manifest.read_csv(args.manifest)
    controller = ReplicationController(manifest, _controller_cfg(args))
    daemon = StreamDaemon(controller, DaemonConfig(
        follow=args.follow, poll=args.poll, checkpoint_every=args.checkpoint_every,
        max_windows=args.max_windows, max_seconds=args.max_seconds,
        recluster=args.recluster, minibatch_rows=args.minibatch_rows, brownout=brownout))
    daemon.install_signal_handlers()
    with contextlib.ExitStack() as stack:
        if args.http:
            from .obs.httpz import ObsServer

            host, _, port = args.http.rpartition(":")
            try:
                server = ObsServer(host or "127.0.0.1", int(port))
            except (OSError, ValueError) as e:
                print(f"error: cannot bind --http {args.http}: {e}", file=sys.stderr)
                return 2
            stack.callback(server.close)
            server.start()
            daemon.attach_http(server)
            # The bound address (port 0 binds an ephemeral one).
            print(f"http: serving /metrics /healthz /readyz /statusz /debug/trace on "
                  f"{server.url}", file=sys.stderr)
        _open_telemetry(args, stack, "daemon_cmd")
        with StageTimer("daemon_cmd") as t:
            digest = daemon.run(args.access_log, metrics_path=args.metrics,
                                metrics_max_bytes=args.metrics_max_bytes,
                                checkpoint_path=args.checkpoint)
    elapsed = t.elapsed
    if args.plan_out:
        from .cluster.plan import write_plan_csv
        from .control.controller import ControllerResult

        result = ControllerResult(records=daemon.records, rf=controller.current_rf,
                                  category_idx=controller.current_cat, manifest=manifest)
        write_plan_csv(args.plan_out, result.plan_entries())
        print(f"plan: {len(manifest)} files -> {args.plan_out}", file=sys.stderr)
    digest["seconds"] = round(elapsed, 3)
    if args.digest_out:
        with open(args.digest_out, "w", encoding="utf-8") as f:
            json.dump(digest, f, indent=2)
            f.write("\n")
    print(json.dumps(digest, indent=2))
    return 0


def _scenario_spec(args):
    """The cell ``scenarios run`` names, or an error message."""
    from .scenarios import ScenarioSpec, preset, suite_cells

    if args.preset:
        if args.seed:
            # A preset names its pinned workload; shifted variants are suite cells.
            return None, (f"--preset runs the pinned cell and takes no --seed — use "
                          f"--suite ... --seed N --cell {args.preset} for the shifted "
                          f"variant")
        try:
            return preset(args.preset), None
        except KeyError as e:
            return None, str(e.args[0])
    if args.cell:
        try:
            cells = {c.name: c for c in suite_cells(args.suite, args.seed)}
        except KeyError as e:
            return None, str(e.args[0])
        if args.cell not in cells:
            return None, f"no cell {args.cell!r} in suite {args.suite!r} (have {sorted(cells)})"
        return cells[args.cell], None
    if args.spec:
        text = args.spec
        inline = text.lstrip().startswith("{")
        if not inline:
            try:
                with open(text, encoding="utf-8") as f:
                    text = f.read()
            except OSError as e:
                return None, f"cannot read spec file {args.spec}: {e.strerror or e}"
        try:
            doc = json.loads(text)
            if not isinstance(doc, dict):
                raise ValueError("spec must be a JSON object")
            if isinstance(doc.get("spec"), dict):
                doc = doc["spec"]   # a banked search-corpus entry wraps its spec
            return ScenarioSpec.from_dict(doc), None
        except (TypeError, ValueError) as e:
            return None, f"invalid scenario spec in {'--spec' if inline else args.spec}: {e}"
    return None, "scenarios run needs --preset NAME, --cell NAME (with --suite), or --spec JSON|FILE"


def _write_json(path: str, doc: dict, **kw) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, **kw)
        f.write("\n")


def _cmd_search(args) -> int:
    """``scenarios search``: the coverage-guided search over the corpus.
    Violations are banked findings (with shrunk repro lines), not
    regressions: the search exits 0 so a long soak keeps growing the
    corpus."""
    from .scenarios.search import SEARCH_BASE, distill_corpus, load_corpus, run_search

    base = tuple(s for s in (args.base or "").split(",") if s) or SEARCH_BASE
    try:
        out = run_search(seed=args.seed, budget_cells=args.budget_cells,
                         budget_seconds=args.budget_seconds, corpus_dir=args.corpus,
                         base=base, device=args.device,
                         progress=lambda line: print(line, file=sys.stderr, flush=True))
    except (KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.distill:
        d = distill_corpus(load_corpus(args.corpus))
        os.makedirs(args.corpus, exist_ok=True)
        path = os.path.join(args.corpus, "distilled.json")
        _write_json(path, d, sort_keys=True)
        out["distilled"] = {"path": path, "names": d["names"],
                            "coverage_bits": d["coverage_bits"], "fingerprint": d["fingerprint"]}
    if args.out:
        _write_json(args.out, out)
    digest = {k: out[k] for k in ("seed", "budget_cells", "iterations", "cells_run",
                                  "baseline_bits", "coverage_bits", "new_coverage_cells",
                                  "fingerprint", "seconds")}
    digest["violations"] = len(out["violations"])
    if "distilled" in out:
        digest["distilled"] = out["distilled"]
    print(json.dumps(digest, indent=2))
    for v in out["violations"]:
        sh = v.get("shrunk") or {}
        print(f"finding: {','.join(v.get('failed') or ()) or v.get('error')}"
              f" — repro: {sh.get('repro') or v['repro']}", file=sys.stderr)
    return 0


def _cmd_triage(args) -> int:
    """``scenarios triage``: rerun every banked violation under a
    ``triage-*`` name; non-zero while any still reproduces."""
    from .scenarios.search import triage_corpus

    out = triage_corpus(args.corpus, device=args.device,
                        progress=lambda line: print(line, file=sys.stderr, flush=True))
    if args.out:
        _write_json(args.out, out, sort_keys=True)
    print(json.dumps({k: out[k] for k in ("names", "n_violations", "ok", "seconds")},
                     indent=2))
    if not out["ok"]:
        # A violation that still reproduces is a bug not fixed yet.
        for r in out["results"]:
            if not r["ok"]:
                print(f"STILL RED: {r['name']} ({','.join(r['failed'])})\n"
                      f"  repro: {r['repro']}", file=sys.stderr)
        return 1
    return 0


def _cmd_scenarios(args) -> int:
    """The scenario matrix: list the presets and suites, run one cell,
    sweep a suite, search the failure space or triage its banked
    violations; every cell runs the controller end to end and is gated on
    invariants."""
    from .scenarios import PRESETS, SUITES, run_cell

    if args.action == "search":
        return _cmd_search(args)
    if args.action == "triage":
        return _cmd_triage(args)
    if args.action == "list":
        print("presets:")
        for name in sorted(PRESETS):
            sp = PRESETS[name]
            axes = [(sp.workload or {}).get("kind", "poisson")]
            if sp.drift:
                axes.append(f"drift={sp.drift['kind']}")
            if sp.faults:
                axes.append("faults")
            if sp.racks:
                axes.append("racks")
            if sp.storage:
                axes.append(f"storage={sp.storage}")
            if sp.serve:
                axes.append(f"serve={sp.serve.get('policy', 'p2c')}")
            if sp.scrub:
                axes.append("scrub")
            if sp.placement != "materialized":
                axes.append(f"placement={sp.placement}")
            if sp.elastic:
                axes.append("elastic")
            if sp.mesh:
                axes.append("mesh")
            if sp.resume_window is not None:
                axes.append("resume-check")
            print(f"  {name:<22} n={sp.n_files:<5} windows={sp.n_windows:<3} "
                  f"seed={sp.seed:<3} " + " ".join(axes))
        print("suites:")
        for name, (names, n_random) in SUITES.items():
            print(f"  {name:<22} {len(names)} presets + {n_random} random cells")
        return 0
    if args.action == "run":
        spec, err = _scenario_spec(args)
        if err is not None:
            print(f"error: {err}", file=sys.stderr)
            return 2
        cell = run_cell(spec, suite=args.suite if args.cell else None,
                        suite_seed=args.seed if args.cell else 0, device=args.device)
        print(json.dumps(cell, indent=2))
        if not cell["ok"]:
            print(f"FAILED; repro: {cell['repro']}", file=sys.stderr)
            return 1
        return 0

    from .scenarios.sweep import format_cell_line, run_sweep

    try:
        out = run_sweep(args.suite, seed=args.seed, round_no=args.round_no,
                        history=args.history or None, extra=args.extra_cells or None,
                        device=args.device,
                        progress=lambda line: print(line, file=sys.stderr, flush=True))
    except (KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.metrics:
        from .obs.sink import JsonlSink

        sink = JsonlSink(args.metrics)
        try:
            for c in out["cells"]:
                sink.emit({"kind": "cell", **{k: v for k, v in c.items() if k != "spec"}})
        finally:
            sink.close()
    if args.out:
        _write_json(args.out, out)
    digest = {k: out[k] for k in ("suite", "seed", "n_cells", "n_failed",
                                  "invariants_checked", "ok", "seconds")}
    for key in ("round", "history_appended"):
        if key in out:
            digest[key] = out[key]
    print(json.dumps(digest, indent=2))
    if not out["ok"]:
        for c in out["cells"]:
            if not c["ok"]:
                print(format_cell_line(c), file=sys.stderr)
        return 1
    return 0


def _cmd_bench(args) -> int:
    """One BASELINE config of the harness; the detail JSON (with the
    environment stamp) on stdout."""
    from .benchmarks.harness import run_bench
    from .obs import run_metadata

    try:
        with contextlib.ExitStack() as stack:
            tel = _open_telemetry(args, stack, f"bench.config{args.config}")
            if tel is not None:
                # Spans and counters only: the timed loop runs as it would.
                tel.kmeans_trace = False
            out = run_bench(config=args.config, backend=args.backend, mesh_shape=args.mesh,
                            update=args.update, e2e=args.e2e, dtype=args.dtype,
                            device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out["run_meta"] = run_metadata()
    print(json.dumps(out))
    return 0


def _add_scoring_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--medians_from_data", action="store_true")
    p.add_argument("--scoring_config", default=None, metavar="JSON|validated")


def _add_init_method_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--init_method", choices=["auto", "d2", "kmeans||"], default="auto",
                   help="centroid init: 'd2' KMeans++, 'kmeans||' oversampling, "
                        "'auto' kmeans|| at k >= 256 and d2 below")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")


def _add_dtype_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dtype", choices=["float32", "bfloat16", "float64"], default=None,
                   help="clustering points dtype (default: the feature table's float32); "
                        "bfloat16 halves the Lloyd kernel's reads, centroids and stats stay "
                        "float32; float64 runs on the CPU only")


def _add_mesh_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh", type=_parse_mesh, default=None, metavar="SPEC",
                   help="mesh of shards: '8' or 'data=4,model=2' (shard s on card "
                        "s mod the card count; the CPU with --device cpu)")


def _add_metrics_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--metrics", default=None, metavar="JSONL",
                   help="emit telemetry here (spans, counters, kmeans convergence traces, "
                        "kernel calls and costs, window records); read it with "
                        "'metrics summarize'")
    p.add_argument("--metrics_max_bytes", type=int, default=None, metavar="BYTES",
                   help="with --metrics: rotate the stream past this size (.1/.2 "
                        "suffixes, larger = older); readers see the rotated set as one "
                        "stream")
    p.add_argument("--device_memory", action="store_true",
                   help="with --metrics: torch.cuda.memory_stats gauges at every span's "
                        "end (nothing on the CPU)")


def _add_control_args(p: argparse.ArgumentParser) -> None:
    """Options shared by the ``control``, ``daemon`` and ``chaos`` subcommands."""
    p.add_argument("--manifest", required=True)
    p.add_argument("--access_log", required=True,
                   help="globally time-sorted log (CSV access.log or .cdrsb)")
    p.add_argument("--window_seconds", type=float, default=60.0)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--drift_threshold", type=float, default=0.05,
                   help="drift score at/above which a re-cluster runs")
    p.add_argument("--full_drift", type=float, default=0.30, metavar="SCORE",
                   help="drift at/above which the warm start is abandoned (fresh init, "
                        "full iteration budget)")
    p.add_argument("--warm_max_iter", type=int, default=25)
    p.add_argument("--max_bytes", type=int, default=None, metavar="BYTES",
                   help="per-window migration byte budget (default: unbounded); chaos "
                        "runs charge repairs and scrub against it first")
    p.add_argument("--max_files", type=int, default=None, metavar="N",
                   help="per-window migrated-file cap (default: unbounded)")
    p.add_argument("--hysteresis", type=int, default=1, metavar="WINDOWS",
                   help="windows a migrated file stays frozen (anti-flap)")
    p.add_argument("--decay", type=float, default=1.0,
                   help="per-window feature-counter decay in (0, 1]; < 1.0 re-weights "
                        "toward recent traffic")
    p.add_argument("--default_rf", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1_000_000,
                   help="events per log read batch (windows re-slice it)")
    _add_metrics_arg(p)
    p.add_argument("--plan_out", default=None, metavar="CSV",
                   help="write the final applied plan (path,category,rf)")
    p.add_argument("--checkpoint", default=None, metavar="NPZ",
                   help="snapshot the controller state here every --checkpoint_every "
                        "windows; rerunning the same command resumes with an identical "
                        "plan sequence")
    p.add_argument("--checkpoint_every", type=int, default=1, metavar="W")
    p.add_argument("--max_windows", type=int, default=None,
                   help="stop after N processed windows")
    p.add_argument("--no_evaluate", action="store_true",
                   help="skip the per-window locality/balance replay")
    p.add_argument("--overlap", action="store_true",
                   help="run window t+1's re-cluster before window t's planning; "
                        "decision-identical to the serial order")
    p.add_argument("--serve", action="store_true",
                   help="route every window's reads through the read router (serve/): "
                        "latency p50/p95/p99, SLO burn, utilization and hotspot fields on "
                        "the window records; hotspot spikes trigger re-clusters")
    p.add_argument("--serve_policy", choices=["primary", "random", "least_loaded", "p2c"],
                   default="p2c")
    p.add_argument("--serve_seed", type=int, default=0)
    p.add_argument("--serve_service_ms", type=float, default=0.5)
    p.add_argument("--serve_slo_ms", type=float, default=10.0)
    p.add_argument("--serve_slo_availability", type=float, default=0.999)
    p.add_argument("--no_hotspot_recluster", action="store_true",
                   help="observe hotspots without feeding them back into the re-cluster "
                        "trigger")
    p.add_argument("--storage_config", default=None, metavar="JSON|replicate|ec_archival",
                   help="storage strategies (storage/): a JSON config mapping categories "
                        "to replicate(rf)/ec(k,m) strategies on hot/warm/cold tiers, "
                        "'replicate' for the explicit degenerate config, or 'ec_archival' "
                        "for the built-in EC(6,3)-cold Archival preset; window records "
                        "gain a 'storage' record; see 'storage show'")
    p.add_argument("--placement", choices=["materialized", "functional", "materialized_hash"],
                   default="materialized",
                   help="placement representation: 'materialized' = the rng chooser and a "
                        "dense replica map; 'functional' = the stateless hash chooser: "
                        "checkpoints store only the rows that differ from the computed "
                        "base and reads resolve their rows on the fly; "
                        "'materialized_hash' = the hash chooser over the dense map (the "
                        "functional mode's oracle)")
    _add_scoring_args(p)
    _add_init_method_arg(p)
    _add_device_arg(p)
    _add_mesh_arg(p)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cdrs_tpu_torch",
        description="Clustering-driven replication strategy on PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("pipeline", aliases=["run"],
                       help="end-to-end: gen -> sim -> features -> cluster")
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--duration_seconds", type=float, default=600.0)
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--outdir", default="output")
    p.add_argument("--evaluate", action="store_true",
                   help="apply the decided rf on the simulated cluster and report "
                        "locality/load/storage against uniform baselines")
    _add_scoring_args(p)
    _add_init_method_arg(p)
    _add_dtype_arg(p)
    _add_device_arg(p)
    _add_mesh_arg(p)
    _add_metrics_arg(p)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace (CPU and CUDA activity) "
                        "into DIR/trace.json")
    p.set_defaults(fn=_cmd_pipeline)

    p = sub.add_parser("gen", help="generate a synthetic file population")
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--hdfs_dir", default="/user/root/synth")
    p.add_argument("--min_size", type=int, default=1024)
    p.add_argument("--max_size", type=int, default=1024 * 1024)
    p.add_argument("--nodes", default="dn1,dn2,dn3")
    p.add_argument("--age_days_max", type=float, default=365.0)
    p.add_argument("--out_manifest", default="metadata.csv")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--write_payloads", action="store_true",
                   help="also write each file's random bytes under --hdfs_dir "
                        "(relative to the working directory)")
    p.set_defaults(fn=_cmd_gen)

    p = sub.add_parser("simulate", help="simulate Poisson access events")
    p.add_argument("--manifest", required=True)
    p.add_argument("--out", default="access.log")
    p.add_argument("--duration_seconds", type=float, default=300.0)
    p.add_argument("--clients", default="dn1,dn2,dn3,dn4")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--engine", choices=["numpy", "native"], default="numpy",
                   help="'native' = the host library's threaded generator "
                        "(runtime/native.py)")
    p.add_argument("--format", choices=["auto", "csv", "binary"], default="auto",
                   help="'csv' = access.log; 'binary' = the columnar .cdrsb log "
                        "(every reader detects it); 'auto' = binary when --out "
                        "ends in .cdrsb")
    p.set_defaults(fn=_cmd_simulate)

    p = sub.add_parser("features", help="extract the 5 per-file features (on the device)")
    p.add_argument("--manifest", required=True)
    p.add_argument("--access_log", required=True, help="CSV access.log or .cdrsb")
    p.add_argument("--out", default="features_out/",
                   help="a CSV path, or a directory that gets part-00000-features.csv")
    _add_device_arg(p)
    _add_mesh_arg(p)
    p.set_defaults(fn=_cmd_features)

    p = sub.add_parser("cluster", help="KMeans++ clustering + category scoring of a "
                       "features CSV (on the device)")
    p.add_argument("--input_path", required=True,
                   help="features CSV, a glob, or a directory holding part-00000*.csv")
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--output_csv", default="final_categories.csv")
    p.add_argument("--assignments_csv", default=None,
                   help="also write the per-file path,cluster,category table")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--medians_from_data", action="store_true")
    p.add_argument("--scoring_config", default=None, metavar="JSON|validated",
                   help="weights/directions/medians/rf config file, or 'validated' for "
                        "the built-in workload-tuned tables")
    _add_init_method_arg(p)
    _add_dtype_arg(p)
    _add_device_arg(p)
    _add_mesh_arg(p)
    _add_metrics_arg(p)
    p.set_defaults(fn=_cmd_cluster)

    p = sub.add_parser("evaluate", help="apply replication factors on the simulated "
                       "cluster; report locality/load/storage against uniform baselines "
                       "(host only, takes no --device)")
    p.add_argument("--manifest", required=True)
    p.add_argument("--access_log", required=True, help="CSV access.log or .cdrsb")
    p.add_argument("--assignments_csv", required=True,
                   help="per-file path,cluster,category table (cluster --assignments_csv)")
    p.add_argument("--nodes", default=None, help="datanode names (default: manifest nodes)")
    p.add_argument("--default_rf", type=int, default=1)
    p.add_argument("--scoring_config", default=None, metavar="JSON|validated",
                   help="scoring config the assignments were made with (its category -> "
                        "replication-factor table)")
    p.add_argument("--emit_plan", default=None, metavar="CSV",
                   help="write the per-file target-rf plan (path,category,rf)")
    p.add_argument("--emit_setrep", default=None, metavar="SH",
                   help="write an 'hdfs dfs -setrep' script applying the plan on a live "
                        "HDFS")
    p.set_defaults(fn=_cmd_evaluate)

    p = sub.add_parser("stream", help="fold the access log in batches, then cluster")
    p.add_argument("--manifest", required=True)
    p.add_argument("--access_log", required=True)
    p.add_argument("--batch_size", type=int, default=1_000_000,
                   help="events per feature-fold batch")
    p.add_argument("--kmeans_batch", type=int, default=None, metavar="ROWS",
                   help="rows per mini-batch KMeans step (default: full-batch Lloyd)")
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output_csv", default="final_categories.csv")
    p.add_argument("--checkpoint", default=None, metavar="NPZ",
                   help="snapshot the fold state and log offset here every "
                        "--checkpoint_every batches; rerunning the same command "
                        "resumes (offsets exist at .cdrsb block ends)")
    p.add_argument("--checkpoint_every", type=int, default=25, metavar="B")
    _add_scoring_args(p)
    _add_init_method_arg(p)
    _add_device_arg(p)
    _add_mesh_arg(p)
    _add_metrics_arg(p)
    p.set_defaults(fn=_cmd_stream)

    p = sub.add_parser("control", help="online replication controller: windowed drift "
                       "detection -> incremental re-cluster -> bounded-churn migration")
    _add_control_args(p)
    p.set_defaults(fn=_cmd_control)

    p = sub.add_parser("daemon", help="always-on streaming controller: tail the growing "
                       ".cdrsb log, decide per window, publish epoch-pinned placements, "
                       "checkpoint with an ingest cursor for a bit-identical resume")
    _add_control_args(p)
    p.add_argument("--follow", action="store_true",
                   help="keep tailing the log for appended blocks (default: process to "
                        "EOF once and exit)")
    p.add_argument("--poll", type=float, default=0.5, metavar="SECONDS",
                   help="follow-mode poll cadence")
    p.add_argument("--max_seconds", type=float, default=None,
                   help="stop (checkpoint + digest) after this much wall clock")
    p.add_argument("--recluster", choices=["controller", "minibatch"], default="controller",
                   help="'minibatch' also advances a mini-batch Lloyd step per window on "
                        "the device (live centroids and inertia; decisions unchanged)")
    p.add_argument("--minibatch_rows", type=int, default=2048, metavar="ROWS")
    p.add_argument("--digest_out", default=None, metavar="JSON",
                   help="also write the final digest here")
    p.add_argument("--http", default=None, metavar="HOST:PORT",
                   help="serve the live operational plane while running (obs/httpz.py): "
                        "/metrics, /healthz, /readyz, /statusz, /debug/trace, off the "
                        "decision path; port 0 binds an ephemeral port (printed to stderr)")
    p.add_argument("--brownout", action="store_true",
                   help="engage the overload brownout ladder: as decision lag crosses "
                        "each rung's threshold, shed optional work in order (skip "
                        "minibatch, defer scrub, cap trace exemplars, coalesce windows, "
                        "shed reads), recovering hysteretically in reverse")
    p.add_argument("--brownout_engage", default=None, metavar="CSV",
                   help="5 comma-separated lag-window thresholds, one per rung "
                        "(default 2,3,4,6,8)")
    p.add_argument("--brownout_release", default=None, metavar="CSV",
                   help="5 release thresholds, each strictly below its engage threshold "
                        "(default 1,1.5,2,3,4)")
    p.add_argument("--shed_fraction", type=float, default=None, metavar="F",
                   help="fraction of reads shed while the shed_reads rung is engaged "
                        "(default 0.2)")
    p.add_argument("--supervise", action="store_true",
                   help="run under the crash supervisor: restart on an abnormal exit with "
                        "capped exponential backoff (a killed daemon resumes from its "
                        "checkpoint)")
    p.add_argument("--max_restarts", type=int, default=5, metavar="N",
                   help="give up after N consecutive crash-restarts")
    p.set_defaults(fn=_cmd_daemon)

    p = sub.add_parser("chaos", help="fault-injected controller run: node crash/recover/"
                       "decommission/flaky/partition/degrade/corrupt events, durability "
                       "accounting, self-healing repairs under the migration churn budget")
    _add_control_args(p)
    p.add_argument("--kill", action="append", metavar="NODE@W[-W2]",
                   help="crash NODE at window W (recovering after W2, e.g. dn2@3-7); "
                        "repeatable")
    p.add_argument("--recover", action="append", metavar="NODE@W",
                   help="recover a crashed NODE at window W; repeatable")
    p.add_argument("--decommission", action="append", metavar="NODE@W",
                   help="remove NODE for good at window W (replicas destroyed); repeatable")
    p.add_argument("--flaky", action="append", metavar="NODE@W[-W2][:P]",
                   help="repair copies to NODE fail with probability P (default 0.5) over "
                        "windows W..W2, e.g. dn1@2-6:0.5; repeatable")
    p.add_argument("--racks", default=None, metavar="SPEC",
                   help="failure domains: ';'-separated rack groups, each 'name=n1,n2' or "
                        "bare 'n1,n2', e.g. 'r0=dn1,dn2;r1=dn3,dn4'")
    p.add_argument("--topology", default=None, metavar="JSON|FILE",
                   help="geo-hierarchical failure domains (inline JSON or a file): "
                        "{'nodes': [...], 'levels': ['rack', 'region'], 'rack': {'r0': "
                        "['dn1','dn2'], ...}, 'region': {'eu': ['r0','r1'], ...}, "
                        "'edge_bytes': {...}, 'edge_latency': {...}}; fault specs accept "
                        "domain scopes (crash:region:eu@3-7).  Exclusive with --racks")
    p.add_argument("--partition", action="append", metavar="NODES@W[-W2]",
                   help="partition a '+'-joined node set over windows W..W2 (unreachable "
                        "as a group, replicas intact), e.g. dn1+dn2@4-6; repeatable")
    p.add_argument("--degrade", action="append", metavar="NODE@W[-W2][:M]",
                   help="straggler: NODE moves data at M x nominal throughput (default "
                        "0.5) over windows W..W2, e.g. dn3@2-6:0.25; repeatable")
    p.add_argument("--corrupt", action="append", metavar="NODE[#FILE]@W[:F]",
                   help="silent corruption of a seeded fraction F (default 0.1) of NODE's "
                        "copies at window W (dn2@3:0.25), or of FILE's copy (dn2#17@3); "
                        "repeatable")
    p.add_argument("--scrub", type=int, default=None, metavar="BYTES",
                   help="background scrubber: verification-read BYTES per window over "
                        "the population, capped by what repairs left of --max_bytes")
    p.add_argument("--no_verify_reads", action="store_true",
                   help="with --serve: serve rotten copies as if intact (the unverified "
                        "baseline; reads_corrupt_served counts them) instead of detecting "
                        "and redirecting")
    p.add_argument("--schedule", default=None, metavar="JSON",
                   help="add fault events from a JSON file (the --schedule_out format)")
    p.add_argument("--schedule_out", default=None, metavar="JSON",
                   help="write the whole schedule here (replayable via --schedule)")
    p.add_argument("--random_faults", type=int, default=None, metavar="W",
                   help="add a seeded random schedule over W windows (never downs the "
                        "last node)")
    p.add_argument("--fault_seed", type=int, default=0, help="seed of --random_faults")
    p.add_argument("--corrupt_rate", type=float, default=0.0,
                   help="with --random_faults: per-window probability that an up node "
                        "rots a fraction of its copies")
    p.add_argument("--corrupt_frac", type=float, default=0.05,
                   help="fraction of a node's copies each --corrupt_rate event rots")
    p.add_argument("--repair_seed", type=int, default=0,
                   help="seed of the stateless flaky-copy failure rolls")
    p.set_defaults(fn=_cmd_chaos)

    p = sub.add_parser("serve", help="read-path SLO replay on the host (no device, no "
                       "kernel): route the log's reads against a placement (replica-"
                       "selection policies, FIFO queue latency, p99 and SLO burn, hotspot "
                       "detection; optional crashes, partitions, stragglers, rot); takes "
                       "no --device")
    p.add_argument("--manifest", required=True)
    p.add_argument("--access_log", required=True,
                   help="globally time-sorted log (CSV access.log or .cdrsb)")
    p.add_argument("--window_seconds", type=float, default=60.0)
    p.add_argument("--policy", choices=["primary", "random", "least_loaded", "p2c"],
                   default="p2c",
                   help="replica selection: primary-only | seeded random | global "
                        "least-loaded | power-of-two-choices (default)")
    p.add_argument("--seed", type=int, default=0,
                   help="replica-choice seed (per-window streams derive from it)")
    p.add_argument("--default_rf", type=int, default=2)
    p.add_argument("--service_ms", type=float, default=0.5,
                   help="per-read service time at nominal node throughput")
    p.add_argument("--slo_ms", type=float, default=10.0, help="read-latency SLO target")
    p.add_argument("--slo_availability", type=float, default=0.999,
                   help="SLO availability objective (error budget = 1 - this)")
    p.add_argument("--racks", default=None, metavar="SPEC",
                   help="failure domains (the chaos --racks spec): placement spreads "
                        "replicas across racks")
    p.add_argument("--placement", choices=["materialized", "functional", "materialized_hash"],
                   default="materialized",
                   help="placement source: 'functional' resolves each window's rows on the "
                        "fly through the stateless hash chooser (no map; memory in the "
                        "window's unique files); 'materialized_hash' materializes the same "
                        "chooser (the oracle); default: the rng chooser")
    p.add_argument("--kill", action="append", metavar="NODE@W[-W2]",
                   help="crash NODE over windows W..W2; repeatable")
    p.add_argument("--partition", action="append", metavar="NODES@W[-W2]",
                   help="network-partition a '+'-joined node set; repeatable")
    p.add_argument("--degrade", action="append", metavar="NODE@W[-W2][:M]",
                   help="straggler: NODE serves reads at M x nominal speed; repeatable")
    p.add_argument("--corrupt", action="append", metavar="NODE[#FILE]@W[:F]",
                   help="silently rot NODE's copies at window W (the chaos --corrupt "
                        "spec); reads that select a rotten copy detect and redirect")
    p.add_argument("--no_verify_reads", action="store_true",
                   help="serve rotten copies as if intact (reads_corrupt_served counts "
                        "them)")
    p.add_argument("--batch_size", type=int, default=1_000_000)
    p.add_argument("--max_windows", type=int, default=None)
    _add_metrics_arg(p)
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("storage", help="storage strategies: resolve a replicate/EC/tier "
                       "config ('show') or estimate its byte/cost footprint over a manifest "
                       "('estimate'); host only, takes no --device")
    p.add_argument("action", choices=["show", "estimate"],
                   help="show = resolved per-category strategy table; estimate = byte/cost "
                        "footprint of a category assignment vs the replicate baseline")
    p.add_argument("--storage_config", default="ec_archival",
                   metavar="JSON|replicate|ec_archival",
                   help="strategy config (default: the built-in EC(6,3)-cold Archival "
                        "preset)")
    p.add_argument("--manifest", default=None, help="(estimate) manifest CSV")
    p.add_argument("--assignments_csv", default=None,
                   help="(estimate) per-file path,cluster,category table (control "
                        "--plan_out)")
    _add_scoring_args(p)
    p.set_defaults(fn=_cmd_storage)

    p = sub.add_parser("scenarios", help="declarative scenario matrix: list presets and "
                       "suites, run one cell, or sweep a suite gated on invariants (zero "
                       "silent loss, churn budget, domain diversity, kill/resume "
                       "bit-identity, alerts)")
    p.add_argument("action", choices=["list", "run", "sweep", "search", "triage"],
                   help="list = presets and suites; run = one cell (--preset, "
                        "--suite + --cell, or --spec); sweep = every ported cell of "
                        "--suite, non-zero exit on any invariant failure; search = "
                        "coverage-guided mutation of the corpus (violations banked with "
                        "shrunk repros, exit 0); triage = rerun the banked violations as "
                        "triage-* cells (non-zero exit while any still reproduces)")
    p.add_argument("--suite", default="ci-smoke", help="cell suite (default ci-smoke)")
    p.add_argument("--seed", type=int, default=0,
                   help="suite seed: shifts every preset's workload seed and draws the "
                        "random cells")
    p.add_argument("--preset", default=None, metavar="NAME", help="(run) a named preset")
    p.add_argument("--cell", default=None, metavar="NAME",
                   help="(run) one cell of --suite: the failing-cell repro path")
    p.add_argument("--spec", default=None, metavar="JSON|FILE",
                   help="(run) an inline spec JSON object or a path to one")
    p.add_argument("--out", default=None, metavar="JSON",
                   help="(sweep/search/triage) write the full artifact here (triage: the "
                        "promoted cell file for --extra_cells)")
    p.add_argument("--extra_cells", action="append", default=None, metavar="JSON",
                   help="(sweep) corpus cell files riding along with the suite "
                        "({'cells': [...], 'names': [...]}); never seed-shifted")
    p.add_argument("--round", type=int, default=None, dest="round_no",
                   help="(sweep) round stamp: appends the per-cell bench_records to "
                        "--history (benchmarks/regress.append_history, deduped: re-runs "
                        "never double-append); suite seed 0 only")
    p.add_argument("--history", default="data/bench_history_torch.jsonl", metavar="JSONL",
                   help="(sweep) trajectory history the per-cell records append to when "
                        "--round is given ('' disables)")
    p.add_argument("--metrics", default=None, metavar="JSONL",
                   help="(sweep) emit the per-cell records as 'cell' events here")
    p.add_argument("--budget-cells", type=int, default=50, dest="budget_cells",
                   help="(search) mutation iterations to attempt (deterministic in --seed)")
    p.add_argument("--budget-seconds", type=float, default=None, dest="budget_seconds",
                   help="(search) wall-clock cap: truncates the same seeded sequence")
    p.add_argument("--corpus", default="data/search_corpus", metavar="DIR",
                   help="(search/triage) corpus directory: banked cells seed the next "
                        "run's frontier; violations land under violations/ with shrunk "
                        "repro lines")
    p.add_argument("--base", default=None, metavar="P1,P2,...",
                   help="(search) comma-separated presets seeding the corpus (default: "
                        "the cheap cross-domain SEARCH_BASE set)")
    p.add_argument("--distill", action="store_true",
                   help="(search) after the run, distill the banked corpus to a small cell "
                        "set covering its frontier (<corpus>/distilled.json)")
    _add_device_arg(p)
    p.set_defaults(fn=_cmd_scenarios)

    p = sub.add_parser("bench", help="benchmark harness (BASELINE.md configs): Lloyd "
                       "iter/s, --e2e time-to-categories, config 5 streaming events/s, "
                       "each against the plain version on the CPU")
    p.add_argument("--config", type=int, default=1, choices=[1, 2, 3, 4, 5])
    p.add_argument("--backend", default=None, choices=["torch", "torch-cpu"],
                   help="torch = the device path; torch-cpu = the plain version on the "
                        "CPU alone (default: the config's)")
    p.add_argument("--update", default=None,
                   help="the reference's Lloyd strategy option: only auto is taken (the "
                        "port's step is the CUDA kernel on a card, its plain version on "
                        "the CPU); any other value is refused")
    p.add_argument("--e2e", action="store_true",
                   help="wall-clock time-to-categories (kmeans -> scoring -> host) instead "
                        "of Lloyd iterations/s")
    p.add_argument("--dtype", choices=["float32", "bfloat16", "float64"], default=None,
                   help="points dtype override (bfloat16 halves the Lloyd kernel's reads; "
                        "float64 runs on the CPU only)")
    _add_mesh_arg(p)
    _add_metrics_arg(p)
    _add_device_arg(p)
    p.set_defaults(fn=_cmd_bench)

    p = sub.add_parser("metrics", help="inspect a telemetry JSONL stream: summarize | tail | "
                       "export | report | watch | alerts; regress: a bench run against "
                       "its trajectory bands")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="summarize FILE | tail FILE [-n N] | "
                        "export FILE --format prometheus [--out FILE] | "
                        "report FILE [-o HTML] | watch FILE | "
                        "alerts FILE [--follow] [--rules JSON] | "
                        "regress RUN.json [--history JSONL] [--round N]")
    p.set_defaults(fn=_cmd_metrics)

    p = sub.add_parser("trace", help="per-decision causal traces of the streaming daemon: "
                       "list | show | export (Chrome/Perfetto trace_event JSON)")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="list FILE [--limit N] | show FILE WINDOW | "
                        "export FILE [--out JSON] [--canonical]")
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser("explain", help="decision provenance: why a file lives where it "
                       "does (slot-by-slot chooser narration and cause-tagged move "
                       "history), why a category scored what it did (per-feature "
                       "decomposition), what a window's signals, traffic and alerts were")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="file ID --manifest CSV [--metrics JSONL] [--checkpoint NPZ] "
                        "[--topology JSON|--racks SPEC] | category NAME --checkpoint NPZ | "
                        "window W --metrics JSONL")
    p.set_defaults(fn=_cmd_explain)

    p = sub.add_parser("status", help="one-shot status of a live daemon started with "
                       "--http: /statusz digest plus the /readyz and /healthz verdicts")
    p.add_argument("url", metavar="HOST:PORT|URL",
                   help="the daemon's --http address (scheme optional)")
    p.add_argument("--json", action="store_true",
                   help="print the raw /statusz JSON instead of the human block")
    p.set_defaults(fn=_cmd_status)
    return parser


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    args.argv = argv
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
