"""``cdrs metrics``: human and scraper reading of a telemetry JSONL stream
(``cdrs_tpu/obs/metrics_cli.py``).

* ``summarize FILE`` — the span tree (aggregated over repeated spans),
  counters, gauges, histogram p50/p95, kmeans convergence traces, the
  kernels' roofline rows (``obs/kprof.py``: operations and bytes of each
  kernel signature against the card's peaks, "not measured" where no
  launch was timed), the audit, alert, serving, storage, durability,
  integrity, daemon and controller-window digests.
* ``tail FILE [-n N]`` — the last N events, one line each.
* ``export FILE --format prometheus [--out FILE]`` — textfile exposition.
* ``report FILE [-o HTML]`` — the static HTML report (``obs/report.py``).
* ``watch FILE`` (or ``--url HOST:PORT``) — a live view of a growing
  stream, or of a daemon's ``/statusz``.
* ``alerts FILE [--follow]`` — the alert rules (``obs/alerts.py``) over the
  stream: batch verdicts with their transitions, or a live follow.
* ``regress RUN.json [--history JSONL] [--round N]`` — a bench run against
  the trajectory bands (``benchmarks/regress.py``; nonzero exit on a
  regression), or ``--ingest`` captures into the history.

Outputs are the reference's byte for byte on a stream without kernel
events; unknown kinds are ignored and a missing, empty or torn stream is a
one-line error naming the path.
"""

from __future__ import annotations

import argparse
import json
import sys

from .aggregate import (
    bucket_percentile,
    collect,
    critical_path_digest,
    daemon_digest,
    dedup_windows,
    final_counters,
    fmt_bytes,
    ordered_span_paths,
    pacing_digest,
    percentile,
    roofline_rows,
    serve_digest,
    span_forest,
    storage_digest,
)
from .sink import read_events

__all__ = ["main", "summarize_events", "prometheus_lines"]

# Backwards-compatible aliases (the aggregation moved to obs/aggregate.py).
_percentile = percentile
_span_forest = span_forest
_dedup_windows = dedup_windows
_final_counters = final_counters


# -- summarize ---------------------------------------------------------------


def _render_span_tree(agg, out) -> None:
    for path in ordered_span_paths(agg):
        node = agg[path]
        indent = "  " * (len(path) - 1)
        calls = f" x{node['count']}" if node["count"] > 1 else ""
        print(f"  {indent}{path[-1]:<{max(1, 28 - len(indent))}} "
              f"{node['total']:>9.3f}s{calls}", file=out)


def _fmt_bytes(b) -> str:
    return fmt_bytes(b, sep="")


def _render_roofline(digest, out, peak_flops=None, peak_gbps=None) -> None:
    """One line per kernel signature: its work, the card, the timed
    launch's achieved rates and its share of the larger bound."""
    rows = roofline_rows(digest, peak_flops, peak_gbps)
    if not rows:
        return
    print("\nKernel costs (roofline):", file=out)
    for r in rows:
        parts = [f"  {r['kernel']:<22}"]
        if "flops" in r:
            parts.append(f"ops={r['flops']:.4g}")
        if "bytes" in r:
            parts.append(f"bytes={_fmt_bytes(r['bytes'])}")
        if "intensity" in r:
            parts.append(f"I={r['intensity']:.3g}op/B")
        parts.append(f"{r.get('dtype', '?')} on {r.get('device', '?')}")
        if r.get("devices"):
            parts.append(f"devices={r['devices']}")
        if r.get("exec_seconds") is None:
            parts.append("time not measured")
        else:
            parts.append(f"time={r['exec_seconds'] * 1e3:.4g}ms "
                         f"achieved={r['gbps']:.4g}GB/s {r['gflops']:.4g}GF/s")
        if "bound_seconds" in r:
            share = ("not measured" if "peak_fraction" not in r
                     else f"{100 * r['peak_fraction']:.1f}%")
            parts.append(f"bound={r['bound_seconds'] * 1e3:.4g}ms ({r['bound']}), "
                         f"share {share}")
        print(" ".join(parts), file=out)


def _render_checkpoint(digest, out) -> None:
    """Checkpoint-size digest (utils/checkpoint.save_state gauges) — the
    observable the functional placement mode's O(exceptions) snapshot
    claim is measured by."""
    g = digest["gauges"]
    if "checkpoint.bytes" not in g:
        return
    saves = int(digest["counters"].get("checkpoint.saves", 0))
    line = (f"\nCheckpoint: last snapshot "
            f"{_fmt_bytes(g['checkpoint.bytes'])}")
    if saves:
        line += f" over {saves} saves"
    secs = g.get("checkpoint.save_seconds")
    if secs is not None:
        line += f", last save {secs:.3f}s"
    print(line, file=out)


def _render_serving(windows: list[dict], out) -> None:
    """Read-path SLO digest (serving window records from a
    ``ControllerConfig.serve`` / ``cdrs serve`` run)."""
    d = serve_digest(windows)
    if d is None:
        return

    def g(v):  # latency fields are None for windows that routed nothing
        return "—" if v is None else f"{v:g}"

    print(f"\nServing: {d['reads_routed']} reads routed over "
          f"{d['windows']} windows "
          f"({d['reads_unavailable']} unavailable, fraction "
          f"{d['unavailable_fraction']:.4g})", file=out)
    print(f"  latency p50 {g(d['latency_p50_ms_last'])} ms, "
          f"p99 {g(d['latency_p99_ms_last'])} ms last window "
          f"(worst-window p99 {g(d['latency_p99_ms_max'])} ms)", file=out)
    line = (f"  SLO burn max {d['slo_burn_max']:.3g} "
            f"(mean {d['slo_burn_mean']:.3g}); "
            f"utilization max {d['utilization_max']:.3g}")
    if d.get("locality_last") is not None:
        line += f"; locality {d['locality_last']:.4g}"
    print(line, file=out)
    if d["hotspot_windows"]:
        print(f"  hotspots: {d['hotspot_windows']} windows fired "
              f"(last files {d['hotspot_files_last']}), "
              f"{d['hotspot_reclusters']} hotspot-triggered reclusters",
              file=out)


def _render_storage(windows: list[dict], out) -> None:
    """Tier/byte-cost digest (storage window records from a
    ``ControllerConfig.storage`` / ``--storage_config`` run)."""
    d = storage_digest(windows)
    if d is None:
        return
    print(f"\nStorage: {_fmt_bytes(d['bytes_stored_final'])} stored for "
          f"{_fmt_bytes(d['bytes_raw'])} raw "
          f"({d['overhead_ratio_final']:g}x, max "
          f"{d['overhead_ratio_max']:g}x; cost "
          f"{d['cost_units_final']:g} units)", file=out)
    tiers = ", ".join(f"{t}={_fmt_bytes(b)}" for t, b in
                      sorted(d["per_tier_bytes_final"].items()))
    line = f"  tiers: {tiers or '—'}"
    if d["ec_files_final"]:
        line += f"; {d['ec_files_final']} erasure-coded files"
    print(line, file=out)


def _render_durability(windows: list[dict], out) -> None:
    """Fault-mode digest: durability tiers, outage span, repair traffic
    (window records from a ``cdrs chaos`` / fault-schedule run)."""
    dur_w = [w for w in windows if w.get("durability")]
    if not dur_w:
        return
    last = dur_w[-1]["durability"]
    lost_max = max(w["durability"]["lost"] for w in dur_w)
    degraded = sum(1 for w in dur_w
                   if w["durability"]["lost"]
                   or w["durability"]["at_risk"]
                   or w["durability"]["under_replicated"])
    rep_bytes = sum(int(w.get("repair_bytes", 0)) for w in windows)
    rep_moves = sum(int(w.get("repair_moves", 0)) for w in windows)
    rep_failed = sum(int(w.get("repair_failed", 0)) for w in windows)
    faults = sum(len(w.get("fault_events") or ()) for w in windows)
    unavail = sum(int(w.get("unavailable_reads", 0)) for w in windows)
    print(f"\nDurability: {faults} fault events over {len(dur_w)} windows, "
          f"{degraded} degraded (max {lost_max} lost)", file=out)
    print(f"  final: {last['lost']} lost / {last['at_risk']} at-risk / "
          f"{last['under_replicated']} under-replicated "
          f"({last['nodes_up']} nodes up)", file=out)
    line = (f"  repair: {rep_moves} replicas, {_fmt_bytes(rep_bytes)}"
            + (f", {rep_failed} failed copies" if rep_failed else ""))
    if unavail:
        # Normalized by the reads actually presented, so runs of
        # different lengths compare: raw counts alone are meaningless
        # across a 5-window smoke and a 500-window soak.  Older streams
        # without per-window ``n_reads`` fall back to the event count (an
        # upper bound on reads — the fraction reads as a floor).
        reads = sum(int(w.get("n_reads", 0)) for w in windows)
        denom = reads or sum(int(w.get("n_events", 0)) for w in windows)
        frac = f" (fraction {unavail / denom:.4g})" if denom else ""
        line += f"; {unavail} reads hit unreadable files{frac}"
    print(line, file=out)
    part_w = sum(1 for w in dur_w
                 if w["durability"].get("nodes_partitioned"))
    stalled = sum(int(w.get("repair_deferred_partition", 0))
                  for w in windows)
    rebal = sum(int(w.get("repair_rebalanced", 0)) for w in windows)
    corr_max = max((w["durability"].get("correlated_risk", 0)
                    for w in dur_w), default=0)
    if part_w or stalled or rebal or corr_max:
        print(f"  domains: {part_w} partitioned windows, {stalled} "
              f"partition-stalled repairs, {rebal} spread rebalances, "
              f"correlated-risk max {corr_max} "
              f"(final {last.get('correlated_risk', 0)})", file=out)


def _render_integrity(windows: list[dict], out) -> None:
    """Integrity digest: silent corruption vs detection (window records
    from a corrupt-fault / scrub-enabled run)."""
    from .aggregate import integrity_digest

    d = integrity_digest(windows)
    if d is None:
        return
    print(f"\nIntegrity: {d['corrupt_copies_max']} corrupt copies max "
          f"(final {d['corrupt_copies_final']}), true losses max "
          f"{d['true_lost_max']} (final {d['true_lost_final']})", file=out)
    print(f"  detected: {d['detected_total']} "
          f"(scrub {d['detected_scrub']}, read {d['detected_read']}, "
          f"repair {d['detected_repair']}); "
          f"{d['corrupt_reads_served']} corrupt reads served", file=out)
    if d["scrub_copies_verified"]:
        line = (f"  scrub: {d['scrub_copies_verified']} copies verified, "
                f"{_fmt_bytes(d['scrub_bytes_total'])} read")
        if d["scrub_starved_windows"]:
            line += f", starved {d['scrub_starved_windows']} windows"
        print(line, file=out)


def _render_cells(cells: list[dict], out) -> None:
    """Scenario-matrix digest (sweep cell records, ``kind: cell``)."""
    from .aggregate import cells_digest

    d = cells_digest(cells)
    if d is None:
        return
    verdict = "all green" if d["ok"] else \
        f"FAILED {len(d['failed'])}: {', '.join(d['failed'])}"
    print(f"\nScenarios: {d['cells']} cells, "
          f"{d['invariants_checked']} invariants checked — {verdict} "
          f"({d['seconds_total']:.1f}s)", file=out)
    if d.get("coverage_bits"):
        print(f"  coverage: {d['coverage_bits']} fingerprint bits "
              f"(fp {d['fingerprint'][:12]})", file=out)
    if d["failed_invariants"]:
        print(f"  failed invariants: "
              f"{', '.join(d['failed_invariants'])}", file=out)


def _render_alerts(windows: list[dict], out) -> None:
    """Alert digest: the default rules (obs/alerts.py) evaluated over
    the stream's window records — fired alerts with their transition
    spans, and whatever is still firing at end of stream."""
    from .alerts import evaluate_records, firing_spans

    if not windows:
        return
    res = [r for r in evaluate_records(windows) if r["fired"]]
    if not res:
        return
    firing = [r for r in res if r["firing"]]
    print(f"\nAlerts: {len(res)} fired "
          f"({len(firing)} still firing at end of stream)", file=out)
    for r in res:
        spans = [f"w{a}->w{b}" if b is not None
                 else f"w{a}->(still firing)"
                 for a, b in firing_spans(r["transitions"])]
        print(f"  {r['name']:<24} [{r['severity']}] "
              f"{', '.join(spans)}", file=out)


def _render_audit(audits: list[dict], out) -> None:
    if not audits:
        return
    flagged = [a for a in audits if a.get("flags")]
    sils = [a["silhouette"] for a in audits if a.get("silhouette")
            is not None]
    line = f"\nAudit: {len(audits)} windows"
    if sils:
        line += (f", silhouette {sils[0]:.3f} -> {sils[-1]:.3f}"
                 f" (min {min(sils):.3f})")
    last = audits[-1]
    if last.get("category_entropy") is not None:
        line += f", entropy {last['category_entropy']:.3f}"
    print(line, file=out)
    if flagged:
        print(f"  anomalies in {len(flagged)} windows:", file=out)
        for a in flagged:
            print(f"    window {a.get('window')}: "
                  f"{', '.join(a['flags'])}", file=out)
    else:
        print("  no anomalies flagged", file=out)


def _render_daemon(digest: dict, out) -> None:
    """Streaming-daemon + critical-path digest lines (traced streams
    only — obs/trace.py; untraced streams render unchanged)."""
    dd = daemon_digest(digest.get("decisions") or [],
                       digest.get("epoch_pins") or [])
    if dd is None:
        return
    line = (f"\nDaemon: {dd['decisions']} traced decisions, "
            f"{dd['epochs_published']} epochs published, "
            f"{dd['epochs_pinned']} pinned; event-to-decision "
            f"p50 {dd['event_to_decision_p50_seconds']:.4g}s / "
            f"p99 {dd['event_to_decision_p99_seconds']:.4g}s")
    if dd.get("publish_to_pin_p50_seconds") is not None:
        line += (f"; publish-to-pin p50 "
                 f"{dd['publish_to_pin_p50_seconds']:.4g}s")
    print(line, file=out)
    cp = critical_path_digest(digest.get("decisions") or [],
                              digest.get("windows") or [])
    if cp is None:
        return
    shares = " / ".join(f"{k} {v:.0%}"
                        for k, v in cp["stage_shares"].items()
                        if v >= 0.005)
    recon = ("reconciled" if cp["reconciled"] else
             f"RECONCILIATION BROKEN x{cp['reconcile_mismatches']}")
    print(f"Critical path: decision p99 {cp['total_p99_seconds']:.4g}s "
          f"= {shares} ({recon})", file=out)
    if cp["exemplars"]:
        ex = ", ".join(f"{e['trace']} {e['total_seconds']:.4g}s"
                       for e in cp["exemplars"][:4])
        print(f"  exemplars (full span trees kept): {ex}", file=out)


def summarize_events(events: list[dict], out=None, peak_flops=None,
                     peak_gbps=None) -> None:
    out = out or sys.stdout
    digest = collect(events)
    if digest["spans"]:
        print("Span tree (wall-clock, aggregated):", file=out)
        _render_span_tree(digest["spans"], out)

    counters = digest["counters"]
    if counters:
        print("\nCounters:", file=out)
        for name in sorted(counters):
            v = counters[name]
            print(f"  {name:<40} {v:g}", file=out)

    gauges = digest["gauges"]
    if gauges:
        print("\nGauges (last value):", file=out)
        for name in sorted(gauges):
            print(f"  {name:<40} {gauges[name]:g}", file=out)

    hists = digest["hists"]
    buckets = digest.get("hist_buckets", {})
    if hists or buckets:
        print("\nHistograms:", file=out)
        for name in sorted(hists):
            vs = hists[name]
            print(f"  {name:<34} n={len(vs):<5} p50={percentile(vs, 0.5):g} "
                  f"p95={percentile(vs, 0.95):g} max={max(vs):g}", file=out)
        # Bucketed (hist_bulk) entries: percentiles are bucket upper
        # bounds (~ marks the ladder resolution, one 10^(1/4) step).
        for name in sorted(buckets):
            agg = buckets[name]
            print(f"  {name:<34} n={agg['count']:<5} "
                  f"p50~{bucket_percentile(agg, 0.5):.4g} "
                  f"p95~{bucket_percentile(agg, 0.95):.4g} "
                  f"max={agg['max']:g}", file=out)

    _render_roofline(digest, out, peak_flops, peak_gbps)

    traces = digest["traces"]
    if traces:
        print("\nKMeans convergence traces:", file=out)
        # Display index is stream-wide; grouping stays per (run, call) so
        # appended runs never merge their traces.
        for call, key in enumerate(sorted(traces), start=1):
            steps = sorted(traces[key], key=lambda e: e["step"])
            first, last = steps[0], steps[-1]
            backend = first.get("backend", "?")
            k = first.get("k", "?")
            inertia = ""
            if first.get("inertia") is not None:
                inertia = (f", inertia {first['inertia']:.6g} -> "
                           f"{last['inertia']:.6g}")
            print(f"  call {call} [{first.get('kernel', '?')} backend="
                  f"{backend} k={k}]: {len(steps)} iterations"
                  f"{inertia}, final shift {last['shift']:.3g}", file=out)

    _render_audit(digest["audits"], out)
    _render_alerts(digest["windows"], out)
    _render_cells(digest.get("cells") or [], out)
    _render_checkpoint(digest, out)
    _render_daemon(digest, out)
    _render_serving(digest["windows"], out)
    _render_storage(digest["windows"], out)
    _render_durability(digest["windows"], out)
    _render_integrity(digest["windows"], out)

    windows = digest["windows"]
    if windows:
        n_events = sum(int(w.get("n_events", 0)) for w in windows)
        recl = [w for w in windows if w.get("recluster")]
        moved = sum(int(w.get("bytes_migrated", 0)) for w in windows)
        print(f"\nController windows: {len(windows)} ({n_events} events, "
              f"{len(recl)} reclusters, {moved} bytes migrated)", file=out)
        pacing = pacing_digest(windows)
        if pacing:
            line = f"End-to-end: {pacing['windows_per_sec']:.3f} windows/sec"
            if "plan_p50_seconds" in pacing:
                line += (f" (plan p50 "
                         f"{pacing['plan_p50_seconds'] * 1e3:.2f} ms/window, "
                         f"{pacing['plan_seconds_fraction']:.1%} "
                         f"of host time)")
            if "devices" in pacing:
                # Mesh runs: windows/sec must be readable against mesh
                # size and the per-iteration collective traffic it buys.
                line += (f" across {pacing['devices']} devices "
                         f"(~{pacing['collective_bytes_per_iter']} B/iter "
                         f"collectives)")
            print(line, file=out)


# -- export ------------------------------------------------------------------

# The exposition renderer lives in obs/prom.py now (ONE renderer shared
# with the daemon's live /metrics endpoint, obs/httpz.py); these aliases
# keep the long-standing import surface of this module working.
from .prom import meta_lines  # noqa: E402
from .prom import prom_name as _prom_name  # noqa: E402,F401
from .prom import prometheus_lines  # noqa: E402,F401


# -- tail --------------------------------------------------------------------


def _tail_line(e: dict) -> str:
    kind = e.get("kind", "?")
    if kind == "span":
        return f"span {e['name']} dur={e['dur']:.6f}s id={e['id']}" + (
            f" parent={e['parent']}" if e.get("parent") is not None else "")
    if kind in ("counter", "gauge", "hist"):
        return f"{kind} {e['name']} = {e['value']:g}"
    if kind == "hist_bulk":
        return (f"hist_bulk {e['name']} n={e.get('count')} "
                f"min={e.get('min', 0):g} max={e.get('max', 0):g}")
    if kind == "kmeans_iter":
        inertia = e.get("inertia")
        istr = "" if inertia is None else f" inertia={inertia:.6g}"
        return (f"kmeans_iter call={e.get('call')} step={e['step']}"
                f"{istr} shift={e['shift']:.3g}")
    if kind == "window":
        return (f"window {e.get('window')} events={e.get('n_events')} "
                f"recluster={e.get('recluster')} "
                f"moves={e.get('moves_applied')}")
    if kind == "lineage":
        return (f"lineage window={e.get('window')} cause={e.get('cause')} "
                f"files={e.get('files')} bytes={e.get('bytes')}")
    if kind == "decision_trace":
        return (f"decision {e.get('trace')} window={e.get('window')} "
                f"total={int(e.get('total_ns', 0)) / 1e9:.4g}s "
                f"epoch={e.get('epoch_id')}"
                + (" exemplar" if e.get("exemplar") else ""))
    if kind == "epoch_pin":
        p2p = e.get("publish_to_pin_ns")
        return (f"epoch_pin epoch={e.get('epoch_id')} "
                f"trace={e.get('trace')}"
                + (f" publish_to_pin={p2p / 1e9:.4g}s"
                   if p2p is not None else ""))
    if kind == "audit":
        sil = e.get("silhouette")
        sil = "" if sil is None else f" silhouette={sil:.3f}"
        flags = f" flags={','.join(e['flags'])}" if e.get("flags") else ""
        return f"audit window={e.get('window')}{sil}{flags}"
    if kind == "kernel":
        secs = e.get("seconds")
        return (f"kernel {e.get('event')} {e.get('kernel')} "
                f"ops={e.get('flops', 0):.4g} bytes={e.get('bytes', 0):.4g} "
                + ("seconds=not measured" if secs is None else f"seconds={secs:.4g}"))
    return json.dumps(e)


# -- watch -------------------------------------------------------------------


def watch(path: str, *, interval: float = 1.0, poll: float | None = None,
          max_seconds: float | None = None, once: bool = False,
          out=None) -> int:
    """Live terminal view of a growing stream.

    Tails ``path`` through ``obs.sink.iter_events`` and redraws a compact
    dashboard — windows processed, re-clusters, migrated bytes, last audit
    verdict, top counters, event rate — every ``interval`` seconds while
    the producer (e.g. ``cdrs control --metrics``) appends.  ``poll``
    sets the file-poll cadence separately from the redraw ``interval``
    (default: same) — a sub-second poll against a live daemon keeps
    tail latency low without redrawing the terminal at that rate.
    ``once`` renders the current state a single time (no follow);
    ``max_seconds`` bounds a follow session (tests, CI).  Ctrl-C exits
    cleanly.
    """
    import time as _time

    from .sink import iter_events

    out = out or sys.stdout
    t0 = _time.monotonic()
    events: list[dict] = []
    rendered_at = -1
    #: Retained-event cap: the dashboard is a live view, not an archive —
    #: a multi-hour controller stream must not grow the re-aggregated
    #: list (and each redraw's cost) without bound.  Past the cap the
    #: oldest half is dropped; last-wins window/audit dedup means the
    #: digest of the trailing stream stays correct for everything the
    #: dashboard shows except all-time totals, which fall back to
    #: trailing-window totals.
    cap = 200_000
    if poll is None:
        poll = interval
    interactive = (not once) and getattr(out, "isatty", lambda: False)()

    def render():
        digest = collect(events)
        lines = [f"cdrs metrics watch — {path}  "
                 f"({len(events)} events, "
                 f"{_time.monotonic() - t0:.0f}s)"]
        windows = digest["windows"]
        if windows:
            recl = sum(1 for w in windows if w.get("recluster"))
            moved = sum(int(w.get("bytes_migrated", 0)) for w in windows)
            last = windows[-1]
            lines.append(
                f"windows: {len(windows)} (last #{last.get('window')}, "
                f"{recl} reclusters, {_fmt_bytes(moved)} migrated)")
        audits = digest["audits"]
        if audits:
            lines.append("audit:   " + _tail_line(audits[-1]))
        for name in sorted(digest["gauges"])[:6]:
            lines.append(f"gauge:   {name} = {digest['gauges'][name]:g}")
        flagged = [a for a in audits if a.get("flags")]
        if flagged:
            lines.append(f"flags:   {len(flagged)} windows flagged "
                         f"(last: {', '.join(flagged[-1]['flags'])})")
        if windows:
            # Streaming alert verdicts over the (deduplicated) trailing
            # windows — FIRING lines appear while a rule is hot and
            # clear to a resolved note once the stream heals.
            from .alerts import evaluate_records

            res = [r for r in evaluate_records(windows) if r["fired"]]
            for r in res:
                if r["firing"]:
                    lines.append(f"ALERT FIRING: {r['name']} "
                                 f"[{r['severity']}] since window "
                                 f"{r['since']}")
            resolved = [r for r in res if not r["firing"]]
            if resolved:
                lines.append("alerts resolved: " + ", ".join(
                    r["name"] for r in resolved))
        if interactive:
            print("\x1b[2J\x1b[H" + "\n".join(lines), file=out, flush=True)
        else:
            print("\n".join(lines) + "\n", file=out, flush=True)

    last_draw = -float("inf")

    def stop() -> bool:
        nonlocal rendered_at, last_draw
        now = _time.monotonic()
        # Redraw only on new data, at most once per ``interval`` — the
        # file may be polled much faster (--poll) than the terminal
        # should repaint.
        if len(events) != rendered_at and now - last_draw >= interval:
            render()
            rendered_at = len(events)
            last_draw = now
        return max_seconds is not None \
            and _time.monotonic() - t0 >= max_seconds

    try:
        for e in iter_events(path, follow=not once, poll=poll,
                             stop=stop):
            events.append(e)
            if len(events) > cap:
                del events[:cap // 2]
    except KeyboardInterrupt:
        pass
    except FileNotFoundError:
        print(f"error: no such stream {path}", file=sys.stderr)
        return 1
    render()
    return 0


# -- watch --url (live daemon endpoint) --------------------------------------


def base_url(spec: str) -> str:
    """Normalize ``HOST:PORT`` / ``http://host:port[/]`` into a scheme'd
    base URL with no trailing slash (the ``cdrs status`` / ``watch
    --url`` address argument)."""
    u = spec.strip().rstrip("/")
    if not u.startswith(("http://", "https://")):
        u = "http://" + u
    return u


def fetch_statusz(base: str, timeout: float = 5.0) -> dict:
    """One GET of a live daemon's ``/statusz`` (obs/httpz.py), parsed.
    Raises OSError/ValueError on unreachable or malformed endpoints —
    callers render the one-line error."""
    import urllib.request

    with urllib.request.urlopen(base + "/statusz",
                                timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


def statusz_lines(base: str, doc: dict) -> list[str]:
    """Human rendering of one /statusz document — shared by ``cdrs
    status`` and ``cdrs metrics watch --url``."""
    lines = [f"cdrs daemon @ {base}  (snapshot seq {doc.get('seq')}, "
             f"up {doc.get('uptime_seconds', 0):.0f}s)"]
    state = "ready" if doc.get("ready") else (
        "draining" if doc.get("draining") else "not ready")
    lines.append(f"state:    {state}")
    lines.append(
        f"epoch:    {doc.get('epoch_id')} "
        f"(window {doc.get('window')}, "
        f"{doc.get('epochs_published')} published)")
    lines.append(
        f"ingest:   {doc.get('events_ingested')} events, "
        f"{doc.get('windows_processed')} windows, backlog "
        f"{(doc.get('backlog') or {}).get('events', 0)} events / "
        f"{_fmt_bytes((doc.get('backlog') or {}).get('bytes', 0))}")
    dec = doc.get("decision") or {}
    if dec.get("count"):
        p50 = dec.get("p50_seconds")
        p99 = dec.get("p99_seconds")
        lines.append(
            f"decide:   n={dec['count']} p50="
            f"{'-' if p50 is None else f'{p50 * 1e3:.2f}ms'} p99="
            f"{'-' if p99 is None else f'{p99 * 1e3:.2f}ms'}")
    stages = doc.get("stages") or []
    if stages:
        top = sorted(stages, key=lambda s: -s.get("share", 0))[:4]
        lines.append("stages:   " + "  ".join(
            f"{s['stage']} {s.get('share', 0):.1%}" for s in top))
    lines.append(
        f"moves:    {doc.get('reclusters')} reclusters, "
        f"{_fmt_bytes(doc.get('bytes_migrated', 0))} migrated, "
        f"{doc.get('checkpoints_written')} checkpoints")
    for a in doc.get("alerts") or []:
        if a.get("firing"):
            lines.append(f"ALERT FIRING: {a['name']} [{a['severity']}] "
                         f"since window {a.get('since')} "
                         f"(streak {a.get('streak')})")
    return lines


def watch_url(url: str, *, interval: float = 1.0,
              max_seconds: float | None = None, once: bool = False,
              out=None) -> int:
    """``watch`` against a live daemon's /statusz endpoint instead of a
    sink file: no shared filesystem needed, and the view is the daemon's
    own atomic snapshot rather than a re-aggregated tail."""
    import time as _time

    out = out or sys.stdout
    base = base_url(url)
    t0 = _time.monotonic()
    interactive = (not once) and getattr(out, "isatty", lambda: False)()
    code = 0
    try:
        while True:
            try:
                lines = statusz_lines(base, fetch_statusz(base))
                code = 0
            except (OSError, ValueError) as e:
                lines = [f"cdrs metrics watch — {base} unreachable: "
                         f"{e}"]
                code = 1
            if interactive:
                print("\x1b[2J\x1b[H" + "\n".join(lines), file=out,
                      flush=True)
            else:
                print("\n".join(lines) + "\n", file=out, flush=True)
            if once:
                return code
            if max_seconds is not None \
                    and _time.monotonic() - t0 >= max_seconds:
                return code
            _time.sleep(interval)
    except KeyboardInterrupt:
        return code
    except BrokenPipeError:
        # The downstream pipe reader hung up (``| grep -q``, ``| head``):
        # end of session, not an error.  Point stdout at devnull so the
        # interpreter's exit flush does not raise the same error again.
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return code


# -- alerts ------------------------------------------------------------------


def _load_rules(spec: str | None):
    """Rules from --rules (inline JSON list or a file path); None = the
    built-in default set."""
    from .alerts import default_rules, rules_from_json

    if not spec:
        return default_rules()
    text = spec
    if not text.lstrip().startswith("["):
        with open(text, encoding="utf-8") as f:
            text = f.read()
    return rules_from_json(text)


def _print_transition(t: dict, out) -> None:
    w = t.get("window")
    where = f"window {w}" if w is not None else "stream"
    if t["state"] == "firing":
        v = f" value={t['value']:g}" if "value" in t else ""
        print(f"{where}: FIRING {t['alert']} [{t['severity']}]{v}",
              file=out)
    else:
        print(f"{where}: resolved {t['alert']}", file=out)


def alerts_cmd(path: str, *, rules=None, follow: bool = False,
               interval: float = 1.0, poll: float | None = None,
               max_seconds: float | None = None,
               fail_firing: bool = False, out=None) -> int:
    """Evaluate alert rules over a stream: batch (transition timeline +
    final verdicts) or live follow (transitions print as they land,
    staleness checked per poll).  ``poll`` overrides the file-poll
    cadence separately from ``interval`` (default: same) — paging on a
    live daemon wants sub-second detection latency.  ``--fail_firing``
    turns a still-firing end state into a nonzero exit — the CI/script
    gate."""
    import time as _time

    from .alerts import AlertEngine
    from .sink import iter_events, read_events

    out = out or sys.stdout
    eng = AlertEngine(rules)
    if follow:
        t0 = _time.monotonic()
        if poll is None:
            poll = interval

        def stop() -> bool:
            for t in eng.check_staleness():
                _print_transition(t, out)
            return max_seconds is not None \
                and _time.monotonic() - t0 >= max_seconds

        try:
            for e in iter_events(path, follow=True, poll=poll,
                                 stop=stop):
                for t in eng.observe(e):
                    _print_transition(t, out)
        except KeyboardInterrupt:
            pass
    else:
        try:
            events = read_events(path)
        except OSError as e:
            print(f"error: cannot read {path}: {e}", file=sys.stderr)
            return 1
        if not events:
            print(f"error: {path}: no telemetry events (missing, "
                  f"empty, or corrupt stream)", file=sys.stderr)
            return 1
        # Last-wins window dedup BEFORE evaluation: a crash/resume tail
        # repeats windows (sink contract), and the verdicts must match
        # what summarize/report/watch evaluate over the same file —
        # stale pre-crash records must not fire, and repeats must not
        # double-count streaks or burn-rate means.
        from .aggregate import dedup_windows

        for e in dedup_windows(events):
            for t in eng.observe(e):
                _print_transition(t, out)
        for t in eng.finish():
            _print_transition(t, out)
    res = eng.results()
    fired = [r for r in res if r["fired"]]
    firing = [r for r in fired if r["firing"]]
    print(f"alerts: {len(fired)} fired over {eng.windows_seen} windows, "
          f"{len(firing)} firing at end"
          + (f" ({', '.join(r['name'] for r in firing)})" if firing
             else ""), file=out)
    return 1 if fail_firing and firing else 0


# -- entry -------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cdrs metrics", description="inspect a telemetry JSONL stream")
    sub = parser.add_subparsers(dest="action", required=True)

    p = sub.add_parser("summarize", help="span tree, counters, p50/p95, "
                                         "roofline, audit digest, traces")
    p.add_argument("file")
    p.add_argument("--peak_flops", type=float, default=None,
                   help="card peak operations/s for the roofline lines "
                        "(default: obs/kprof.DEVICE_PEAKS by the card's name)")
    p.add_argument("--peak_gbps", type=float, default=None,
                   help="card peak memory GB/s for the roofline lines")

    p = sub.add_parser("tail", help="print the last N events")
    p.add_argument("file")
    p.add_argument("-n", type=int, default=20)

    p = sub.add_parser("export", help="export aggregates for scrapers")
    p.add_argument("file")
    p.add_argument("--format", choices=["prometheus"], default="prometheus")
    p.add_argument("--out", default=None,
                   help="write here (default stdout); point your "
                        "node_exporter textfile collector at it")

    p = sub.add_parser("report", help="self-contained static HTML report "
                                      "(span tree, sparklines, audit "
                                      "timeline, roofline table)")
    p.add_argument("file")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: <file>.html)")
    p.add_argument("--title", default=None)

    p = sub.add_parser("watch", help="live terminal view tailing a running "
                                     "producer's stream (or polling a "
                                     "daemon's --http endpoint via --url)")
    p.add_argument("file", nargs="?", default=None)
    p.add_argument("--url", default=None, metavar="HOST:PORT|URL",
                   help="poll a live daemon's /statusz endpoint "
                        "(cdrs daemon --http) instead of tailing a "
                        "sink file")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--poll", type=float, default=None, metavar="SECONDS",
                   help="file-poll cadence, decoupled from the redraw "
                        "--interval (default: same) — sub-second polls "
                        "track a live daemon without repainting at "
                        "that rate")
    p.add_argument("--max_seconds", type=float, default=None,
                   help="stop after this long (default: until Ctrl-C)")
    p.add_argument("--once", action="store_true",
                   help="render the current state once and exit")

    p = sub.add_parser("alerts", help="evaluate AlertRules over the "
                                      "stream: thresholds, SRE burn-"
                                      "rate pairs, staleness — batch "
                                      "timeline or live --follow")
    p.add_argument("file")
    p.add_argument("--rules", default=None, metavar="JSON|FILE",
                   help="declarative rule list (obs/alerts.py schema); "
                        "default: the built-in ruleset")
    p.add_argument("--follow", action="store_true",
                   help="tail the stream live, printing transitions as "
                        "they land (staleness rules active)")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--poll", type=float, default=None, metavar="SECONDS",
                   help="file-poll cadence override (default: "
                        "--interval) — sub-second detection latency "
                        "against a live daemon")
    p.add_argument("--max_seconds", type=float, default=None,
                   help="bound a follow session (tests, CI)")
    p.add_argument("--fail_firing", action="store_true",
                   help="exit nonzero when any alert is still firing "
                        "at the end")

    sub.add_parser("regress", add_help=False,
                   help="compare a bench run against the recorded "
                        "trajectory bands; nonzero exit on regression")

    # Delegate regress wholesale (its options would otherwise be eaten by
    # this parser — argparse.REMAINDER does not capture leading options).
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "regress":
        from ..benchmarks.regress import main as regress_main

        return regress_main(list(argv[1:]))

    args = parser.parse_args(argv)
    if args.action == "watch":
        if args.url:
            return watch_url(args.url, interval=args.interval,
                             max_seconds=args.max_seconds,
                             once=args.once)
        if not args.file:
            print("error: watch needs a stream FILE or --url",
                  file=sys.stderr)
            return 2
        return watch(args.file, interval=args.interval, poll=args.poll,
                     max_seconds=args.max_seconds, once=args.once)
    if args.action == "alerts":
        try:
            rules = _load_rules(args.rules)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: bad --rules: {e}", file=sys.stderr)
            return 2
        return alerts_cmd(args.file, rules=rules, follow=args.follow,
                          interval=args.interval, poll=args.poll,
                          max_seconds=args.max_seconds,
                          fail_firing=args.fail_firing)

    try:
        events = read_events(args.file)
    except OSError as e:
        print(f"error: cannot read {args.file}: {e}", file=sys.stderr)
        return 1
    if not events and args.action in ("summarize", "tail", "report"):
        # One clean line naming the path — a missing stream, an empty
        # file and an all-torn (corrupt) file all land here; none of
        # them should traceback or silently render nothing.
        print(f"error: {args.file}: no telemetry events (missing, "
              f"empty, or corrupt stream)", file=sys.stderr)
        return 1

    try:
        if args.action == "summarize":
            summarize_events(events, peak_flops=args.peak_flops,
                             peak_gbps=args.peak_gbps)
            return 0
        if args.action == "tail":
            if args.n > 0:  # [-0:] would be the whole stream
                for e in events[-args.n:]:
                    print(_tail_line(e))
            return 0
        if args.action == "report":
            from .report import render_html

            out_path = args.out or (args.file + ".html")
            html = render_html(events, title=args.title
                               or f"cdrs report — {args.file}")
            with open(out_path, "w", encoding="utf-8") as f:
                f.write(html)
            print(f"wrote {out_path}", file=sys.stderr)
            return 0
        # export — aggregate exposition plus the meta series every
        # Prometheus surface carries (start-time gauge for rate() over
        # resume-reset counters, build info; obs/prom.py).
        text = "\n".join(prometheus_lines(events) + meta_lines()) + "\n"
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(text)
        else:
            sys.stdout.write(text)
        return 0
    except BrokenPipeError:
        # `cdrs metrics ... | head` closing the pipe is a clean exit, not
        # a traceback.
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0
