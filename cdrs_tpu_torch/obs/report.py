"""Static HTML report of a telemetry stream, ``cdrs metrics report``
(``cdrs_tpu/obs/report.py``).

One self-contained file (inline CSS and SVG, no external request): the span
tree with duration bars, counters and gauges with sparklines, histogram
p50/p95, the kernels' cost and roofline table (``obs/kprof.py``: work,
card, timed launch and its share of the bound, "not measured" without a
device time), the audit timeline with its flags, the alert, serving,
storage, durability, integrity and critical-path sections and the
controller window digest.  Every number comes from ``obs/aggregate.py``,
so the HTML agrees with ``cdrs metrics summarize``.  Rendering is
deterministic for a given stream and, on a stream without kernel events,
the reference's byte for byte.
"""

from __future__ import annotations

import html as _html

from .aggregate import (
    bucket_percentile,
    collect,
    fmt_bytes,
    ordered_span_paths,
    percentile,
    roofline_rows,
    serve_digest,
    storage_digest,
)

__all__ = ["render_html"]

_CSS = """
:root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f1f0ee;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e3e2df;
  --series-1: #2a78d6; --series-1-soft: #cde2fb;
  --status-good: #0ca30c; --status-serious: #ec835a;
  --status-critical: #d03b3b;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #242422;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #3a3936;
    --series-1: #3987e5; --series-1-soft: #1c5cab;
  }
}
body { background: var(--surface-1); color: var(--text-primary);
  font: 14px/1.45 system-ui, sans-serif; margin: 2rem auto;
  max-width: 72rem; padding: 0 1rem; }
h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 2rem; }
table { border-collapse: collapse; width: 100%; }
th, td { text-align: left; padding: .3rem .6rem;
  border-bottom: 1px solid var(--grid); font-variant-numeric: tabular-nums; }
th { color: var(--text-secondary); font-weight: 600; }
td.num, th.num { text-align: right; }
.tiles { display: flex; flex-wrap: wrap; gap: .8rem; margin: 1rem 0; }
.tile { background: var(--surface-2); border-radius: 8px;
  padding: .6rem 1rem; min-width: 8rem; }
.tile .v { font-size: 1.4rem; font-weight: 650; }
.tile .l { color: var(--text-secondary); font-size: .8rem; }
.bar { display: inline-block; height: 8px; border-radius: 0 4px 4px 0;
  background: var(--series-1); vertical-align: middle; }
.spark polyline { fill: none; stroke: var(--series-1); stroke-width: 2; }
.spark { vertical-align: middle; }
.indent { color: var(--text-secondary); }
.flag { font-weight: 600; }
.flag.serious { color: var(--status-serious); }
.flag.critical { color: var(--status-critical); }
.ok { color: var(--status-good); }
.muted { color: var(--text-secondary); }
code { background: var(--surface-2); padding: 0 .25rem; border-radius: 4px; }
"""


def _esc(x) -> str:
    return _html.escape(str(x))


def _fmt(v, digits: int = 4) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.{digits}g}"
    return str(v)


def _fmt_bytes(b) -> str:
    # \u202f: narrow no-break space keeps value+unit on one line in cells.
    return fmt_bytes(b, sep="\u202f")


def _sparkline(values: list[float], width: int = 120, height: int = 26
               ) -> str:
    """Inline single-series SVG sparkline (2px line, no axes; the row's
    text cells carry the numbers).  Hover shows the min/max range."""
    vs = [float(v) for v in values]
    if len(vs) < 2:
        return '<span class="muted">—</span>'
    lo, hi = min(vs), max(vs)
    span = (hi - lo) or 1.0
    pad = 2
    pts = []
    for i, v in enumerate(vs):
        x = pad + i * (width - 2 * pad) / (len(vs) - 1)
        y = height - pad - (v - lo) / span * (height - 2 * pad)
        pts.append(f"{x:.1f},{y:.1f}")
    return (f'<svg class="spark" width="{width}" height="{height}" '
            f'role="img" aria-label="{len(vs)} samples, '
            f'{_fmt(lo)} to {_fmt(hi)}">'
            f'<title>{len(vs)} samples, min {_fmt(lo)}, max {_fmt(hi)}'
            f'</title><polyline points="{" ".join(pts)}"/></svg>')


def _tiles(digest: dict, n_events: int) -> str:
    windows = digest["windows"]
    audits = digest["audits"]
    tiles = [("events in stream", f"{n_events}")]
    if windows:
        tiles.append(("controller windows", f"{len(windows)}"))
        tiles.append(("reclusters",
                      f"{sum(1 for w in windows if w.get('recluster'))}"))
        tiles.append(("bytes migrated", _fmt_bytes(
            sum(int(w.get("bytes_migrated", 0)) for w in windows))))
        dur = [w for w in windows if w.get("durability")]
        if dur:
            tiles.append(("max files lost",
                          f"{max(w['durability']['lost'] for w in dur)}"))
            tiles.append(("repair bytes", _fmt_bytes(
                sum(int(w.get("repair_bytes", 0)) for w in windows))))
    if audits:
        flagged = sum(1 for a in audits if a.get("flags"))
        tiles.append(("flagged windows", f"{flagged}"))
        sils = [a["silhouette"] for a in audits
                if a.get("silhouette") is not None]
        if sils:
            tiles.append(("final silhouette", _fmt(sils[-1], 3)))
    sd = serve_digest(windows)
    if sd is not None:
        tiles.append(("reads routed", f"{sd['reads_routed']}"))
        p99 = sd["latency_p99_ms_last"]
        tiles.append(("p99 latency (last)",
                      "—" if p99 is None else f"{p99:g} ms"))
        tiles.append(("SLO burn (max)", _fmt(sd["slo_burn_max"], 3)))
    if digest["kernels"]:
        tiles.append(("kernel signatures captured", f"{len(digest['kernels'])}"))
    cells = "".join(
        f'<div class="tile"><div class="v">{_esc(v)}</div>'
        f'<div class="l">{_esc(label)}</div></div>'
        for label, v in tiles)
    return f'<div class="tiles">{cells}</div>'


def _span_section(digest: dict) -> str:
    agg = digest["spans"]
    if not agg:
        return ""
    total = max((n["total"] for n in agg.values()), default=0.0) or 1.0
    rows = []
    for path in ordered_span_paths(agg):
        node = agg[path]
        indent = "&nbsp;" * 4 * (len(path) - 1)
        bar_w = max(2, int(round(160 * node["total"] / total)))
        calls = f' <span class="muted">&times;{node["count"]}</span>' \
            if node["count"] > 1 else ""
        rows.append(
            f'<tr><td>{indent}<span class="indent"></span>'
            f'{_esc(path[-1])}{calls}</td>'
            f'<td class="num">{node["total"]:.3f} s</td>'
            f'<td><span class="bar" style="width:{bar_w}px"></span></td>'
            f"</tr>")
    return ("<h2>Span tree (wall-clock, aggregated)</h2><table>"
            "<tr><th>span</th><th class=num>total</th><th></th></tr>"
            + "".join(rows) + "</table>")


def _counter_section(digest: dict) -> str:
    counters = digest["counters"]
    if not counters:
        return ""
    rows = "".join(
        f"<tr><td><code>{_esc(n)}</code></td>"
        f'<td class="num">{counters[n]:g}</td></tr>'
        for n in sorted(counters))
    return ("<h2>Counters</h2><table><tr><th>counter</th>"
            "<th class=num>value</th></tr>" + rows + "</table>")


def _gauge_section(digest: dict) -> str:
    gauges = digest["gauges"]
    if not gauges:
        return ""
    rows = []
    for name in sorted(gauges):
        series = digest["gauge_series"].get(name, [])
        rows.append(
            f"<tr><td><code>{_esc(name)}</code></td>"
            f'<td class="num">{gauges[name]:g}</td>'
            f"<td>{_sparkline(series)}</td></tr>")
    return ("<h2>Gauges</h2><table><tr><th>gauge</th><th class=num>last"
            "</th><th>trend</th></tr>" + "".join(rows) + "</table>")


def _hist_section(digest: dict) -> str:
    hists = digest["hists"]
    buckets = digest.get("hist_buckets", {})
    if not hists and not buckets:
        return ""
    rows = []
    for name in sorted(hists):
        vs = hists[name]
        rows.append(
            f"<tr><td><code>{_esc(name)}</code></td>"
            f'<td class="num">{len(vs)}</td>'
            f'<td class="num">{percentile(vs, 0.5):g}</td>'
            f'<td class="num">{percentile(vs, 0.95):g}</td>'
            f'<td class="num">{max(vs):g}</td>'
            f"<td>{_sparkline(vs)}</td></tr>")
    # Bucketed (hist_bulk) names: percentiles are bucket upper bounds
    # (the ~ marks the ladder's 10^(1/4) resolution).
    for name in sorted(buckets):
        agg = buckets[name]
        rows.append(
            f"<tr><td><code>{_esc(name)}</code></td>"
            f'<td class="num">{agg["count"]}</td>'
            f'<td class="num">~{_fmt(bucket_percentile(agg, 0.5))}</td>'
            f'<td class="num">~{_fmt(bucket_percentile(agg, 0.95))}</td>'
            f'<td class="num">{agg["max"]:g}</td>'
            f'<td><span class="muted">bucketed</span></td></tr>')
    return ("<h2>Histograms</h2><table><tr><th>histogram</th>"
            "<th class=num>n</th><th class=num>p50</th><th class=num>p95"
            "</th><th class=num>max</th><th>observations</th></tr>"
            + "".join(rows) + "</table>")


def _kernel_section(digest: dict) -> str:
    """The kernels' cost and roofline table: one row per signature."""
    rows_data = roofline_rows(digest)
    if not rows_data:
        return ""
    head = ("<tr><th>kernel</th><th>type</th><th>card</th><th class=num>operations</th>"
            "<th class=num>bytes</th><th class=num>intensity (op/B)</th>"
            "<th class=num>time</th><th class=num>achieved GB/s</th>"
            "<th class=num>bound</th><th>bound by</th><th class=num>share</th></tr>")
    rows = []
    for r in rows_data:
        secs = r.get("exec_seconds")
        pf = r.get("peak_fraction")
        bound_s = r.get("bound_seconds")
        cells = [
            f"<td><code>{_esc(r['kernel'])}</code></td>",
            f"<td>{_esc(r.get('dtype', '—'))}</td>",
            f"<td>{_esc(r.get('device', '—'))}</td>",
            f'<td class="num">{_fmt(r.get("flops"))}</td>',
            f'<td class="num">{_fmt_bytes(r.get("bytes"))}</td>',
            f'<td class="num">{_fmt(r.get("intensity"), 3)}</td>',
            f'<td class="num">{"not measured" if secs is None else _fmt(secs * 1e3, 4) + " ms"}'
            f"</td>",
            f'<td class="num">{_fmt(r.get("gbps"), 4)}</td>',
            f'<td class="num">{"—" if bound_s is None else _fmt(bound_s * 1e3, 4) + " ms"}'
            f"</td>",
            f"<td>{_esc(r.get('bound', '—'))}</td>",
            f'<td class="num">{"not measured" if pf is None else _fmt(100 * pf, 3) + " %"}'
            f"</td>",
        ]
        rows.append("<tr>" + "".join(cells) + "</tr>")
    return ("<h2>Kernel costs (roofline)</h2><table>" + head + "".join(rows)
            + "</table>")


def _audit_flag_html(flags: list[str]) -> str:
    if not flags:
        return '<span class="ok">✓ clean</span>'
    spans = [f'<span class="flag {"critical" if f == "drift_no_gain" else "serious"}">'  # noqa: E501
             f"⚠ {_esc(f)}</span>" for f in flags]
    return " ".join(spans)


def _audit_section(digest: dict) -> str:
    audits = digest["audits"]
    if not audits:
        return ""
    sils = [a.get("silhouette") for a in audits]
    sil_series = [s for s in sils if s is not None]
    spark = (f"<p>silhouette trend {_sparkline(sil_series)}</p>"
             if len(sil_series) >= 2 else "")
    rows = []
    for a in audits:
        rows.append(
            f"<tr><td>{_esc(a.get('window'))}</td>"
            f'<td class="num">{_fmt(a.get("silhouette"), 3)}</td>'
            f'<td class="num">{_fmt(a.get("davies_bouldin"), 3)}</td>'
            f'<td class="num">{_fmt(a.get("category_entropy"), 3)}</td>'
            f'<td class="num">{_fmt(a.get("population_tv"), 3)}</td>'
            f'<td class="num">{_fmt(a.get("locality"), 3)}</td>'
            f'<td class="num">'
            f'{_fmt_bytes(a.get("replication_bytes"))}</td>'
            f"<td>{_audit_flag_html(a.get('flags', []))}</td></tr>")
    return ("<h2>Decision-quality audit timeline</h2>" + spark
            + "<table><tr><th>window</th><th class=num>silhouette</th>"
            "<th class=num>Davies-Bouldin</th><th class=num>entropy</th>"
            "<th class=num>pop. TV</th><th class=num>locality</th>"
            "<th class=num>repl. bytes</th><th>flags</th></tr>"
            + "".join(rows) + "</table>")


def _alerts_section(digest: dict) -> str:
    """Streaming-alert timeline: the default AlertRules (obs/alerts.py)
    evaluated over the stream's window records — fired alerts with their
    firing/resolved spans.  Absent when nothing fired, so quiet streams
    render unchanged."""
    from .alerts import evaluate_records, firing_spans

    windows = digest["windows"]
    if not windows:
        return ""
    res = [r for r in evaluate_records(windows) if r["fired"]]
    if not res:
        return ""
    rows = []
    for r in res:
        spans = [f"w{a} → w{b}" if b is not None
                 else f"w{a} → still firing"
                 for a, b in firing_spans(r["transitions"])]
        state = ('<span class="flag critical">⚠ firing</span>'
                 if r["firing"] else '<span class="ok">✓ resolved</span>')
        rows.append(
            f"<tr><td>{_esc(r['name'])}</td>"
            f"<td>{_esc(r['severity'])}</td>"
            f"<td>{state}</td>"
            f"<td>{_esc('; '.join(spans))}</td></tr>")
    return ("<h2>Alerts</h2>"
            "<table><tr><th>alert</th><th>severity</th><th>state</th>"
            "<th>spans</th></tr>" + "".join(rows) + "</table>")


def _window_section(digest: dict) -> str:
    windows = digest["windows"]
    if not windows:
        return ""
    rows = []
    for w in windows:
        rows.append(
            f"<tr><td>{_esc(w.get('window'))}</td>"
            f'<td class="num">{_fmt(w.get("n_events"))}</td>'
            f'<td class="num">{_fmt(w.get("drift"), 3)}</td>'
            f"<td>{_esc(w.get('recluster_mode') or '—')}</td>"
            f'<td class="num">{_fmt(w.get("moves_applied"))}</td>'
            f'<td class="num">{_fmt_bytes(w.get("bytes_migrated"))}</td>'
            f'<td class="num">{_fmt(w.get("locality_after"), 3)}</td>'
            f"</tr>")
    return ("<h2>Controller windows</h2><table><tr><th>window</th>"
            "<th class=num>events</th><th class=num>drift</th>"
            "<th>recluster</th><th class=num>moves</th>"
            "<th class=num>migrated</th><th class=num>locality</th></tr>"
            + "".join(rows) + "</table>")


def _durability_section(digest: dict) -> str:
    """Fault-mode timeline (window records carrying ``durability``):
    tiers per window, repair traffic, fault events.  Absent for streams
    without fault accounting — pre-fault reports render unchanged."""
    windows = [w for w in digest["windows"] if w.get("durability")]
    if not windows:
        return ""
    # Length-normalized unavailability (see metrics_cli._render_durability
    # for the n_reads/n_events fallback rationale).
    unavail = sum(int(w.get("unavailable_reads", 0)) for w in windows)
    note = ""
    if unavail:
        reads = sum(int(w.get("n_reads", 0)) for w in windows)
        denom = reads or sum(int(w.get("n_events", 0)) for w in windows)
        frac = f" (fraction {_fmt(unavail / denom, 3)})" if denom else ""
        note = (f'<p class="muted">{unavail} reads hit unreadable files'
                f"{frac}</p>")
    rows = []
    for w in windows:
        d = w["durability"]
        faults = ", ".join(w.get("fault_events") or ()) or "—"
        rows.append(
            f"<tr><td>{_esc(w.get('window'))}</td>"
            f"<td><code>{_esc(faults)}</code></td>"
            f'<td class="num">{_fmt(d.get("nodes_up"))}</td>'
            f'<td class="num">{_fmt(d.get("lost"))}</td>'
            f'<td class="num">{_fmt(d.get("at_risk"))}</td>'
            f'<td class="num">{_fmt(d.get("under_replicated"))}</td>'
            f'<td class="num">{_fmt(w.get("repair_moves"))}</td>'
            f'<td class="num">{_fmt_bytes(w.get("repair_bytes"))}</td>'
            f'<td class="num">{_fmt(w.get("repair_backlog"))}</td>'
            f"</tr>")
    return ("<h2>Durability (fault mode)</h2>" + note
            + "<table><tr><th>window</th>"
            "<th>fault events</th><th class=num>nodes up</th>"
            "<th class=num>lost</th><th class=num>at risk</th>"
            "<th class=num>under-repl.</th><th class=num>repairs</th>"
            "<th class=num>repair bytes</th><th class=num>backlog</th>"
            "</tr>" + "".join(rows) + "</table>")


def _integrity_section(digest: dict) -> str:
    """Silent-corruption vs detection timeline (window records carrying
    ``integrity`` — a corrupt-fault / scrub-enabled run): ground-truth
    rot and true losses the blind durability tiers cannot see, the
    per-path detection totals, and the scrub scan's progress.  Absent
    for pre-integrity streams — older reports render unchanged."""
    from .aggregate import integrity_digest

    d = integrity_digest(digest["windows"])
    if d is None:
        return ""
    tiles = "".join(
        f'<div class="tile"><div class="v">{v}</div>'
        f'<div class="l">{_esc(label)}</div></div>'
        for label, v in (
            ("corrupt copies (max)", _fmt(d["corrupt_copies_max"])),
            ("true losses (max)", _fmt(d["true_lost_max"])),
            ("detected", _fmt(d["detected_total"])),
            ("corrupt reads served", _fmt(d["corrupt_reads_served"])),
            ("scrub read", _fmt_bytes(d["scrub_bytes_total"])),
        ))
    note = (f'<p class="muted">detections: scrub {d["detected_scrub"]}, '
            f'read {d["detected_read"]}, repair {d["detected_repair"]}'
            + (f' · scrub starved {d["scrub_starved_windows"]} windows'
               if d["scrub_starved_windows"] else "") + "</p>")
    rows = []
    for w in digest["windows"]:
        integ = w.get("integrity")
        if integ is None:
            continue
        sc = w.get("scrub") or {}
        rows.append(
            f"<tr><td>{_esc(w.get('window'))}</td>"
            f'<td class="num">{_fmt(integ.get("corrupt_copies"))}</td>'
            f'<td class="num">{_fmt(integ.get("true_lost"))}</td>'
            f'<td class="num">{_fmt(integ.get("detected_scrub"))}</td>'
            f'<td class="num">{_fmt(integ.get("detected_read"))}</td>'
            f'<td class="num">{_fmt(integ.get("detected_repair"))}</td>'
            f'<td class="num">{_fmt(w.get("reads_corrupt_served"))}</td>'
            f'<td class="num">{_fmt_bytes(sc.get("bytes"))}</td>'
            f"<td>{'⚠ starved' if sc.get('starved') else '—'}</td></tr>")
    return ("<h2>Data integrity (silent corruption)</h2>"
            f'<div class="tiles">{tiles}</div>' + note
            + "<table><tr><th>window</th><th class=num>corrupt</th>"
            "<th class=num>true lost</th><th class=num>det. scrub</th>"
            "<th class=num>det. read</th><th class=num>det. repair</th>"
            "<th class=num>served rotten</th><th class=num>scrub bytes"
            "</th><th>scrub</th></tr>" + "".join(rows) + "</table>")


def _storage_section(digest: dict) -> str:
    """Tier/byte-cost digest (window records carrying ``storage`` — a
    ``ControllerConfig.storage`` run): stored vs raw bytes, overhead
    ratio, per-tier split, EC stripe count.  Absent for pre-storage
    streams — older reports render unchanged."""
    sd = storage_digest(digest["windows"])
    if sd is None:
        return ""
    tiles = "".join(
        f'<div class="tile"><div class="v">{v}</div>'
        f'<div class="l">{_esc(label)}</div></div>'
        for label, v in (
            ("stored bytes", _fmt_bytes(sd["bytes_stored_final"])),
            ("raw bytes", _fmt_bytes(sd["bytes_raw"])),
            ("overhead", f'{_fmt(sd["overhead_ratio_final"], 4)}×'),
            ("cost units", _fmt(sd["cost_units_final"], 5)),
            ("EC files", _fmt(sd["ec_files_final"])),
        ))
    rows = "".join(
        f"<tr><td>{_esc(t)}</td>"
        f'<td class="num">{_fmt_bytes(b)}</td></tr>'
        for t, b in sorted(sd["per_tier_bytes_final"].items()))
    cat_rows = "".join(
        f"<tr><td>{_esc(c)}</td>"
        f'<td class="num">{_fmt_bytes(b)}</td></tr>'
        for c, b in sorted(sd["per_category_bytes_final"].items()))
    return ("<h2>Storage (tiers &amp; erasure coding)</h2>"
            f'<div class="tiles">{tiles}</div>'
            "<table><tr><th>tier</th><th class=num>stored</th></tr>"
            + rows + "</table>"
            "<table><tr><th>category</th><th class=num>stored</th></tr>"
            + cat_rows + "</table>")


def _serve_section(digest: dict) -> str:
    """Read-path SLO timeline (serving window records from a
    ``ControllerConfig.serve`` / ``cdrs serve`` run): per-window latency
    percentiles, utilization, SLO burn, unavailable fraction, hotspots.
    Absent for pre-serve streams — older reports render unchanged."""
    sd = serve_digest(digest["windows"])
    if sd is None:
        return ""
    sw = [w for w in digest["windows"]
          if w.get("reads_routed") is not None]
    p99s = [float(w["latency_p99_ms"]) for w in sw
            if w.get("latency_p99_ms") is not None]
    spark = (f"<p>p99 latency trend {_sparkline(p99s)} · unavailable "
             f"fraction {_fmt(sd['unavailable_fraction'], 3)} · hotspot "
             f"windows {sd['hotspot_windows']} · hotspot-triggered "
             f"reclusters {sd['hotspot_reclusters']}</p>"
             if len(p99s) >= 2 else "")
    rows = []
    for w in sw:
        hot = w.get("hotspot_files") or ()
        hot_s = ", ".join(str(f) for f in hot) if hot else "—"
        trig = w.get("recluster_trigger")
        rows.append(
            f"<tr><td>{_esc(w.get('window'))}</td>"
            f'<td class="num">{_fmt(w.get("reads_routed"))}</td>'
            f'<td class="num">{_fmt(w.get("reads_unavailable"))}</td>'
            f'<td class="num">{_fmt(w.get("latency_p50_ms"), 3)}</td>'
            f'<td class="num">{_fmt(w.get("latency_p99_ms"), 3)}</td>'
            f'<td class="num">{_fmt(w.get("utilization_max"), 3)}</td>'
            f'<td class="num">{_fmt(w.get("slo_burn"), 3)}</td>'
            f"<td>{_esc(hot_s)}</td>"
            f"<td>{_esc(trig) if trig else '—'}</td></tr>")
    return ("<h2>Serving (read-path SLO)</h2>" + spark
            + "<table><tr><th>window</th><th class=num>routed</th>"
            "<th class=num>unavail.</th><th class=num>p50 ms</th>"
            "<th class=num>p99 ms</th><th class=num>util. max</th>"
            "<th class=num>SLO burn</th><th>hotspots</th><th>trigger</th>"
            "</tr>" + "".join(rows) + "</table>")


def _critical_path_section(digest: dict) -> str:
    """Decision critical-path attribution (``decision_trace`` records
    from a traced daemon run — obs/trace.py): event-to-decision tail,
    time-weighted stage shares, exemplar decisions.  Absent for
    untraced streams — older reports render unchanged."""
    from .aggregate import critical_path_digest, daemon_digest

    cp = critical_path_digest(digest.get("decisions") or [],
                              digest.get("windows") or [])
    if cp is None:
        return ""
    dd = daemon_digest(digest.get("decisions") or [],
                       digest.get("epoch_pins") or []) or {}
    recon = ("reconciled" if cp["reconciled"]
             else f"RECONCILIATION BROKEN ×{cp['reconcile_mismatches']}")
    tiles = "".join(
        f'<div class="tile"><div class="v">{v}</div>'
        f'<div class="l">{_esc(label)}</div></div>'
        for label, v in (
            ("traced decisions", _fmt(cp["decisions"])),
            ("epochs published", _fmt(dd.get("epochs_published"))),
            ("epochs pinned", _fmt(dd.get("epochs_pinned"))),
            ("decision p50", f"{cp['total_p50_seconds']:.4g}s"),
            ("decision p99", f"{cp['total_p99_seconds']:.4g}s"),
            ("segments", _esc(recon)),
        ))
    rows = "".join(
        f"<tr><td><code>{_esc(k)}</code></td>"
        f'<td class="num">{v:.1%}</td></tr>'
        for k, v in cp["stage_shares"].items() if v >= 0.001)
    ex = "".join(
        f"<tr><td><code>{_esc(e['trace'])}</code></td>"
        f'<td class="num">{_esc(e["window"])}</td>'
        f'<td class="num">{e["total_seconds"]:.4g}s</td></tr>'
        for e in cp["exemplars"][:8])
    ex_tbl = ("<h3>Exemplars (full span trees kept)</h3>"
              "<table><tr><th>trace</th><th class=num>window</th>"
              "<th class=num>total</th></tr>" + ex + "</table>"
              if ex else "")
    return ("<h2>Decision critical path</h2>"
            f'<div class="tiles">{tiles}</div>'
            "<table><tr><th>stage</th><th class=num>share of "
            "event-to-decision time</th></tr>" + rows + "</table>"
            + ex_tbl)


def _trace_section(digest: dict) -> str:
    traces = digest["traces"]
    if not traces:
        return ""
    rows = []
    for i, key in enumerate(sorted(traces), start=1):
        steps = sorted(traces[key], key=lambda e: e["step"])
        first, last = steps[0], steps[-1]
        inertias = [e["inertia"] for e in steps
                    if e.get("inertia") is not None]
        rows.append(
            f"<tr><td>{i}</td><td><code>{_esc(first.get('kernel', '?'))}"
            f"</code></td><td>{_esc(first.get('backend', '?'))}</td>"
            f'<td class="num">{_esc(first.get("k", "?"))}</td>'
            f'<td class="num">{len(steps)}</td>'
            f'<td class="num">{_fmt(last.get("shift"), 3)}</td>'
            f"<td>{_sparkline(inertias)}</td></tr>")
    return ("<h2>KMeans convergence traces</h2><table><tr><th>call</th>"
            "<th>kernel</th><th>backend</th><th class=num>k</th>"
            "<th class=num>iterations</th><th class=num>final shift</th>"
            "<th>inertia</th></tr>" + "".join(rows) + "</table>")


def _meta_section(digest: dict) -> str:
    meta = digest["meta"]
    if not meta:
        return ""
    items = " · ".join(f"{_esc(k)}=<code>{_esc(v)}</code>"
                       for k, v in sorted(meta.items()))
    return f'<p class="muted">{items}</p>'


def render_html(events: list[dict], title: str = "cdrs telemetry report"
                ) -> str:
    """The whole report as one self-contained HTML string."""
    digest = collect(events)
    body = (
        f"<h1>{_esc(title)}</h1>"
        + _meta_section(digest)
        + _tiles(digest, len(events))
        + _span_section(digest)
        + _kernel_section(digest)
        + _audit_section(digest)
        + _alerts_section(digest)
        + _serve_section(digest)
        + _storage_section(digest)
        + _durability_section(digest)
        + _integrity_section(digest)
        + _critical_path_section(digest)
        + _window_section(digest)
        + _trace_section(digest)
        + _gauge_section(digest)
        + _hist_section(digest)
        + _counter_section(digest)
    )
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_esc(title)}</title>"
            "<meta name='viewport' content='width=device-width, "
            "initial-scale=1'>"
            f"<style>{_CSS}</style></head><body>{body}</body></html>")
