"""Bench trajectory regression gate — ``metrics regress``: the port's copy
of ``cdrs_tpu/benchmarks/regress.py``.

* **ingest** — bench captures (the round captures ``BENCH_r*.json`` and raw
  detail JSON of ``python -m cdrs_tpu_torch.benchmarks`` or ``bench.py``)
  flatten into one append-only history, one line per (round, metric) with
  the value, unit, direction and the platform it was measured on.  A
  capture whose ``parsed`` is null is scraped from its ``tail`` text.
* **check** — a fresh run is compared per metric against a tolerance band
  anchored at the BEST of the trailing ``window`` history values (±
  ``tolerance``).  Bands only form between runs on the SAME platform: the
  port's records take theirs from ``device_name`` (the card's name;
  "torch-cpu" for the plain version on the CPU), the reference's from
  ``jax_platform``.  So a port run never bands against the TPU trajectory:
  it reports ``no_baseline`` and passes.  A regression (worse than the band
  in the metric's bad direction: ``iter/s`` down, seconds up) exits
  nonzero; an improvement is reported as such.

The port's history is ``data/bench_history_torch.jsonl`` (``DEFAULT_HISTORY``),
read as empty until a ``--round`` append creates it; the reference's
``data/bench_history.jsonl`` is only ever read.  Reading the reference's
captures gives the reference's records.  No torch or jax import: the gate
runs on any host that can read JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

__all__ = ["extract_records", "ingest_files", "load_history", "check_run",
           "append_history", "history_key", "add_history_argument",
           "resolve_history_path", "main", "DEFAULT_HISTORY"]

#: The port's trajectory history (never the reference's).
DEFAULT_HISTORY = "data/bench_history_torch.jsonl"

#: Units where smaller is better (wall-clock style metrics); everything
#: else (iter/s, files/s, events/s) is throughput, larger is better.
_LOWER_BETTER_UNITS = {"s", "seconds", "ms"}

_NESTED_BLOCKS = ("config3", "config4_rehearsal")


def _direction(metric: str, unit: str | None) -> str:
    if (unit or "") in _LOWER_BETTER_UNITS or metric.startswith("e2e_"):
        return "lower"
    return "higher"


def _platform(detail: dict) -> str | None:
    """The platform a record bands on: the port's ``device_name``, the
    reference's ``jax_platform``, or the CPU backend a record names."""
    backend = detail.get("backend")
    return (detail.get("device_name") or detail.get("jax_platform")
            or (backend if backend in ("numpy", "torch-cpu") else None))


def _record_from(detail: dict, source: str, round_no: int | None
                 ) -> dict | None:
    """One history record from a bench detail dict (a capture's ``parsed`` or a
    nested config block); None when it is not a completed capture."""
    if not isinstance(detail, dict) or "metric" not in detail \
            or "value" not in detail:
        return None
    if "error" in detail or "skipped" in detail:
        return None
    rec = {
        "round": round_no,
        "source": source,
        "metric": detail["metric"],
        "value": float(detail["value"]),
        "unit": detail.get("unit"),
        # An explicit direction wins: the scenario sweep pins e.g. churn
        # bytes as lower-is-better, which no unit heuristic can know.
        "direction": detail.get("direction")
        or _direction(detail["metric"], detail.get("unit")),
        "platform": _platform(detail),
        "devices": detail.get("device_count", detail.get("jax_devices")),
        "backend": detail.get("backend"),
    }
    if detail.get("vs_baseline") is not None:
        rec["vs_baseline"] = float(detail["vs_baseline"])
    return rec


_METRIC_RE = re.compile(
    r'"metric":\s*"(?P<metric>[^"]+)",\s*"value":\s*'
    r'(?P<value>[-+0-9.eE]+),\s*"unit":\s*"(?P<unit>[^"]+)"'
    r'(?:,\s*"vs_baseline":\s*(?P<vsb>[-+0-9.eE]+))?')
_PLATFORM_RE = re.compile(r'"(?:device_name|jax_platform)":\s*"([^"]+)"')


def _scrape_tail(tail: str, source: str, round_no: int | None
                 ) -> list[dict]:
    """Records regex-scraped from a truncated capture's ``tail``.

    The stdout contract line and the detail JSON both carry the
    metric/value/unit(/vs_baseline) quadruple; nested config blocks carry
    their own.  Platform association: the detail JSON stamps
    ``device_name`` (``jax_platform`` in the reference's) after each
    metric's fields, so each match takes the first platform occurrence
    following it.  Duplicate (metric, value)
    pairs (contract line + detail line) collapse to one record.
    """
    platforms = [(m.start(), m.group(1))
                 for m in _PLATFORM_RE.finditer(tail)]
    seen: set[tuple] = set()
    records = []
    for m in _METRIC_RE.finditer(tail):
        key = (m.group("metric"), m.group("value"))
        if key in seen:
            continue
        seen.add(key)
        platform = next((p for pos, p in platforms if pos > m.end()), None)
        rec = {
            "round": round_no,
            "source": source,
            "metric": m.group("metric"),
            "value": float(m.group("value")),
            "unit": m.group("unit"),
            "direction": _direction(m.group("metric"), m.group("unit")),
            "platform": platform,
            "scraped": True,
        }
        if m.group("vsb") is not None:
            rec["vs_baseline"] = float(m.group("vsb"))
        records.append(rec)
    return records


def extract_records(doc, source: str) -> list[dict]:
    """Flatten one bench artifact (round capture or raw detail JSON) into
    history records: the headline metric plus completed nested config
    blocks (``config3``, ``config4_rehearsal``) and — for artifacts that
    carry several comparable metrics, like ``data/serve_bench.json`` —
    every entry of a top-level ``bench_records`` list."""
    round_no = None
    m = re.search(r"r(\d+)", os.path.basename(source))
    if m:
        round_no = int(m.group(1))
    # Artifacts whose filename carries no round (data/serve_bench.json)
    # stamp it explicitly — ingest stays reproducible from the file alone.
    if isinstance(doc, dict) and isinstance(doc.get("round"), int):
        round_no = doc["round"]
    if isinstance(doc, dict) and "n" in doc and "cmd" in doc:
        round_no = int(doc["n"])
        detail = doc.get("parsed")
        if detail is None:
            return _scrape_tail(doc.get("tail") or "", source, round_no)
    else:
        detail = doc
    if not isinstance(detail, dict):
        return []
    records = []
    rec = _record_from(detail, source, round_no)
    if rec:
        records.append(rec)
    for block in _NESTED_BLOCKS:
        rec = _record_from(detail.get(block), source, round_no)
        if rec:
            records.append(rec)
    for entry in detail.get("bench_records") or ():
        rec = _record_from(entry, source, round_no)
        if rec:
            records.append(rec)
    return records


def ingest_files(paths: list[str]) -> list[dict]:
    records = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        # Basename only: the history must not bake in the ingesting
        # machine's directory layout.
        records.extend(extract_records(doc, os.path.basename(path)))
    records.sort(key=lambda r: ((r.get("round") is None, r.get("round")),
                                str(r.get("metric"))))
    return records


def write_history(path: str, records: list[dict]) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for r in records:
            f.write(json.dumps(r, sort_keys=True) + "\n")


def history_key(rec: dict) -> tuple:
    """The identity of one history row: (round, metric, platform).

    One bench measurement per PR round per platform — re-ingesting the
    same artifact (or re-running a sweep) must be a no-op, and a
    re-measured value for an existing key keeps the ORIGINAL row (the
    history is an append-only ledger, not a cache)."""
    return (rec.get("round"), rec.get("metric"), rec.get("platform"))


def append_history(path: str, records: list[dict]) -> int:
    """Append ``records`` to the history, deduplicated on
    ``history_key``: the one writer behind ``--round`` (``metrics
    regress`` and the scenario sweep) and ``--ingest``.  Existing rows are
    never rewritten or re-sorted (the append-only artifact-order contract);
    new rows append in the given order.  Returns the number of rows
    actually appended."""
    have: set[tuple] = set()
    if os.path.exists(path):
        have = {history_key(r) for r in load_history(path)}
    fresh = []
    for rec in records:
        key = history_key(rec)
        if key in have:
            continue
        have.add(key)
        fresh.append(rec)
    if not fresh:
        return 0
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        for r in fresh:
            f.write(json.dumps(r, sort_keys=True) + "\n")
    return len(fresh)


def add_history_argument(parser) -> None:
    """The shared ``--history`` flag of the auto-appending benches: one
    definition so the ledger policy cannot drift between them."""
    parser.add_argument(
        "--history", default=None, metavar="JSONL",
        help="append the bench_records here (regress.append_history: "
             "deduped on (round, metric, platform), so re-runs never "
             f"double-append). Default: {DEFAULT_HISTORY} for full runs, "
             "DISABLED for --quick (a smoke-scale measurement must never "
             "become the ledger row a real run is then deduped against); "
             "'' disables explicitly")


def resolve_history_path(args) -> str:
    """The ledger path the parsed ``--history`` flag means: the given
    path verbatim when set ('' = disabled), else the default ledger —
    unless the run is ``--quick``, which never auto-appends."""
    if args.history is not None:
        return args.history
    return "" if getattr(args, "quick", False) else DEFAULT_HISTORY


def load_history(path: str) -> list[dict]:
    records = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def _parse_run_text(text: str):
    """A run artifact as JSON, tolerating surrounding noise.

    The bench entry prints the one-line stdout contract (metric/value
    only) and the FULL detail record — the one carrying the platform the
    banding needs — to stderr, where warnings interleave.  A clean JSON document parses directly; otherwise the
    LAST line holding a JSON object with a ``metric`` key wins (the
    detail record is printed after the contract line)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(doc, dict) and ("metric" in doc or "parsed" in doc):
            return doc
    raise ValueError("no JSON bench record found in the run artifact")


def check_run(run_records: list[dict], history: list[dict], *,
              tolerance: float = 0.15, window: int = 3) -> list[dict]:
    """Per-metric verdicts of a fresh run against the history bands.

    Band anchor: the BEST of the trailing ``window`` same-(metric,
    platform) history values — "do not regress from what the trajectory
    recently demonstrated", the same posture as pytest-benchmark's
    compare-against-best.  A trajectory mid-improvement (the recorded
    config-2 history quadruples over three rounds) makes a mean or median
    anchor uselessly loose; ``tolerance`` (default 15%) absorbs the
    observed ~6% round-to-round noise.  Statuses: ``regression`` (outside
    the band, bad side), ``improved`` (beyond the anchor by the same
    margin, good side), ``pass`` (inside), ``no_baseline`` (no comparable
    history — different platform or a new metric; always passes).
    """
    by_key: dict[tuple, list[dict]] = {}
    for h in history:
        by_key.setdefault((h.get("metric"), h.get("platform")),
                          []).append(h)
    verdicts = []
    for rec in run_records:
        key = (rec.get("metric"), rec.get("platform"))
        hist = by_key.get(key, [])
        v: dict = {"metric": rec.get("metric"),
                   "platform": rec.get("platform"),
                   "value": rec.get("value"), "unit": rec.get("unit")}
        if not hist:
            v["status"] = "no_baseline"
            verdicts.append(v)
            continue
        hist = sorted(hist, key=lambda h: (h.get("round") is None,
                                           h.get("round")))
        recent = [float(h["value"]) for h in hist[-max(1, window):]]
        direction = rec.get("direction") or _direction(
            rec.get("metric", ""), rec.get("unit"))
        baseline = max(recent) if direction == "higher" else min(recent)
        value = float(rec["value"])
        v.update({"baseline": baseline, "direction": direction,
                  "n_history": len(hist), "tolerance": tolerance})
        if direction == "higher":
            band_low = baseline * (1.0 - tolerance)
            v["band_low"] = band_low
            if value < band_low:
                v["status"] = "regression"
            elif value > baseline * (1.0 + tolerance):
                v["status"] = "improved"
            else:
                v["status"] = "pass"
        else:
            band_high = baseline * (1.0 + tolerance)
            v["band_high"] = band_high
            if value > band_high:
                v["status"] = "regression"
            elif value < baseline * (1.0 - tolerance):
                v["status"] = "improved"
            else:
                v["status"] = "pass"
        verdicts.append(v)
    return verdicts


def _print_verdicts(verdicts: list[dict], out=None) -> None:
    out = out or sys.stdout
    for v in verdicts:
        status = v["status"]
        line = f"  [{status:<11}] {v['metric']} = {v['value']:g}"
        if "baseline" in v:
            arrow = "<" if "band_low" in v else ">"
            band = v.get("band_low", v.get("band_high"))
            line += (f" {v.get('unit', '')} (baseline {v['baseline']:g}, "
                     f"regression when {arrow} {band:g}, "
                     f"{v['n_history']} rounds of history)")
        else:
            line += (f" {v.get('unit', '')} (no comparable history on "
                     f"platform {v.get('platform')!r})")
        print(line, file=out)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cdrs_tpu_torch metrics regress",
        description="compare a bench run against the recorded trajectory "
                    "bands (nonzero exit on regression)")
    parser.add_argument("run", nargs="?", default=None,
                        help="fresh bench artifact (round capture or raw "
                             "bench detail JSON); '-' reads stdin")
    parser.add_argument("--history", default=None, metavar="JSONL",
                        help=f"trajectory history (default: {DEFAULT_HISTORY}, "
                             "read as empty until a --round append creates it)")
    parser.add_argument("--round", type=int, default=None, dest="round_no",
                        help="stamp the records with this round and append "
                             "them to the history (deduped on (round, metric, "
                             "platform)): the checked run's after its check, "
                             "or the --ingest artifacts' in place of their "
                             "own round")
    parser.add_argument("--ingest", nargs="+", default=None,
                        metavar="JSON",
                        help="ingest these BENCH artifacts into the "
                             "history instead of checking a run: an "
                             "existing history is appended to, deduped "
                             "on (round, metric, platform) — idempotent "
                             "— and built fresh when absent")
    parser.add_argument("--tolerance", type=float, default=0.15,
                        help="band half-width as a fraction of the "
                             "baseline (default 0.15)")
    parser.add_argument("--window", type=int, default=3,
                        help="trailing history rounds whose BEST value "
                             "anchors the band (default 3)")
    parser.add_argument("--report-only", action="store_true",
                        help="print verdicts but exit 0 even on "
                             "regression (CI before a stable runner "
                             "baseline exists)")
    parser.add_argument("--json", action="store_true",
                        help="emit the verdicts as JSON")
    args = parser.parse_args(argv)
    history_path = args.history or DEFAULT_HISTORY

    def stamped(records):
        if args.round_no is not None:
            for rec in records:
                rec["round"] = int(args.round_no)
        return records

    if args.ingest:
        records = stamped(ingest_files(args.ingest))
        if not records:
            print("error: no bench records found in the given files",
                  file=sys.stderr)
            return 2
        # Idempotent by (round, metric, platform) on BOTH paths: an
        # existing history is appended to (never re-sorted — the
        # append-only artifact-order contract), a fresh one is built
        # with the same within-batch dedup, and re-ingesting the same
        # artifacts is a no-op either way.
        appended = append_history(history_path, records)
        skipped = len(records) - appended
        print(f"ingested {appended} records from "
              f"{len(args.ingest)} files -> {history_path}"
              + (f" ({skipped} already present)" if skipped else ""))
        return 0

    if not args.run:
        parser.error("a RUN.json to check (or --ingest) is required")
    try:
        if args.run == "-":
            text = sys.stdin.read()
        else:
            with open(args.run, encoding="utf-8") as f:
                text = f.read()
        doc = _parse_run_text(text)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        print(f"error: cannot read run {args.run}: {e}", file=sys.stderr)
        return 2
    run_records = stamped(extract_records(
        doc, os.path.basename(args.run) if args.run != "-" else "stdin"))
    if not run_records:
        print("error: no metric records in the run artifact",
              file=sys.stderr)
        return 2
    if args.history is None and not os.path.exists(history_path):
        history = []   # the port's ledger before its first append
    else:
        try:
            history = load_history(history_path)
        except OSError as e:
            print(f"error: cannot read history {history_path}: {e}",
                  file=sys.stderr)
            return 2

    verdicts = check_run(run_records, history, tolerance=args.tolerance,
                         window=args.window)
    if args.json:
        print(json.dumps(verdicts, indent=2))
    else:
        print(f"bench regression check vs {history_path} "
              f"(tolerance {args.tolerance:g}, window {args.window}):")
        _print_verdicts(verdicts)
    if args.round_no is not None:
        appended = append_history(history_path, run_records)
        print(f"appended {appended} records of round {args.round_no} -> "
              f"{history_path}", file=sys.stderr)
    regressions = [v for v in verdicts if v["status"] == "regression"]
    if regressions:
        print(f"REGRESSION: {len(regressions)} metric(s) below the "
              f"trajectory band", file=sys.stderr)
        if not args.report_only:
            return 1
        print("(report-only mode: exiting 0)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
