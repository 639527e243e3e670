"""Prometheus text-format rendering: ``cdrs_tpu/obs/prom.py``.

One renderer for every surface: the primitives (``counter_lines``,
``gauge_lines``, ``summary_lines``, ``histogram_lines``, ``alerts_lines``)
are what the daemon's live ``/metrics`` endpoint (obs/httpz.py) emits, and
:func:`prometheus_lines` renders a telemetry stream's final aggregates the
same way.  Every exposition also carries the two meta series of
:func:`meta_lines`: ``cdrs_process_start_time_seconds`` (counters restart
with the process, so ``rate()`` must see the restart) and the constant
``cdrs_build_info``.

:func:`lint` is the promtool-style format check run against live scrapes:
TYPE before samples, valid metric and label syntax, parseable values, no
duplicate TYPE, a final newline.
"""

from __future__ import annotations

import re
import time

from .aggregate import dedup_windows, final_counters, merge_hist_buckets, percentile

__all__ = ["prom_name", "prometheus_lines", "meta_lines", "lint", "counter_lines",
           "gauge_lines", "summary_lines", "histogram_lines", "alerts_lines",
           "PROCESS_START_TIME"]

#: Unix seconds at which this process started observing (first import).
PROCESS_START_TIME = time.time()

_VERSION = None


def _build_version() -> str:
    global _VERSION
    if _VERSION is None:
        try:
            from importlib.metadata import version

            _VERSION = version("clustering-driven-replication-strategy-tpu")
        except Exception:
            _VERSION = "unknown"
    return _VERSION


def prom_name(name: str, prefix: str = "cdrs_") -> str:
    """A valid Prometheus metric name (``[a-zA-Z_:][a-zA-Z0-9_:]*``) from an
    event name: other characters map to ``_``, a leading digit is escaped."""
    full = prefix + re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if full and full[0].isdigit():
        full = "_" + full
    return full


def _labels(labels: dict | None) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels.items()) + "}"


# -- primitive renderers ------------------------------------------------------

def counter_lines(name: str, value: float, labels: dict | None = None) -> list[str]:
    m = prom_name(name)
    return [f"# TYPE {m} counter", f"{m}{_labels(labels)} {value:g}"]


def gauge_lines(name: str, value: float, labels: dict | None = None) -> list[str]:
    m = prom_name(name)
    return [f"# TYPE {m} gauge", f"{m}{_labels(labels)} {value:g}"]


def summary_lines(name: str, values: list[float]) -> list[str]:
    """A summary over raw samples: p50 and p95 quantiles, sum, count."""
    m = prom_name(name)
    return [
        f"# TYPE {m} summary",
        f'{m}{{quantile="0.5"}} {percentile(values, 0.5):g}',
        f'{m}{{quantile="0.95"}} {percentile(values, 0.95):g}',
        f"{m}_sum {sum(values):g}",
        f"{m}_count {len(values)}",
    ]


def histogram_lines(name: str, agg: dict) -> list[str]:
    """A native histogram from a merged ``hist_bulk`` aggregate: cumulative
    ``le`` buckets closed by ``+Inf``."""
    m = prom_name(name)
    lines = [f"# TYPE {m} histogram"]
    cum = 0
    for le in sorted(k for k in agg["buckets"] if k != float("inf")):
        cum += agg["buckets"][le]
        lines.append(f'{m}_bucket{{le="{le:g}"}} {cum}')
    lines += [
        f'{m}_bucket{{le="+Inf"}} {agg["count"]}',
        f"{m}_sum {agg['sum']:g}",
        f"{m}_count {agg['count']}",
    ]
    return lines


def alerts_lines(firing: list[dict]) -> list[str]:
    """``ALERTS`` gauges, one series per firing alert (rows with ``name``
    and ``severity``)."""
    if not firing:
        return []
    lines = ["# TYPE ALERTS gauge"]
    for r in firing:
        lines.append(f'ALERTS{{alertname="{r["name"]}",alertstate="firing",'
                     f'severity="{r["severity"]}"}} 1')
    return lines


def meta_lines(start_time: float | None = None, version: str | None = None) -> list[str]:
    """The process-start gauge and the build-info gauge; ``start_time`` and
    ``version`` default to this process's."""
    st = PROCESS_START_TIME if start_time is None else float(start_time)
    ver = _build_version() if version is None else version
    return [
        "# TYPE cdrs_process_start_time_seconds gauge",
        f"cdrs_process_start_time_seconds {st:.3f}",
        "# TYPE cdrs_build_info gauge",
        f'cdrs_build_info{{version="{ver}"}} 1',
    ]


# -- the stream renderer --------------------------------------------------------

def prometheus_lines(events: list[dict]) -> list[str]:
    """Exposition of a telemetry stream's final aggregates: counters,
    gauges, summaries of raw histograms and spans, native histograms, and
    the ``ALERTS`` of the deduplicated window records."""
    from .alerts import evaluate_records

    lines: list[str] = []
    counters = final_counters(events)
    gauges: dict[str, float] = {}
    hists: dict[str, list[float]] = {}
    bulk: dict[str, dict] = {}
    for e in events:
        kind = e.get("kind")
        if kind == "gauge":
            gauges[e["name"]] = e["value"]
        elif kind == "hist":
            hists.setdefault(e["name"], []).append(float(e["value"]))
        elif kind == "hist_bulk":
            merge_hist_buckets(bulk.setdefault(e["name"], {}), e)
        elif kind == "span":
            hists.setdefault(f"span.{e['name']}.seconds", []).append(float(e.get("dur", 0.0)))
    for name in sorted(counters):
        lines += counter_lines(name, counters[name])
    for name in sorted(gauges):
        lines += gauge_lines(name, gauges[name])
    for name in sorted(hists):
        lines += summary_lines(name, hists[name])
    for name in sorted(bulk):
        lines += histogram_lines(name, bulk[name])
    windows = dedup_windows(events)
    if windows:
        lines += alerts_lines([r for r in evaluate_records(windows) if r["firing"]])
    return lines


# -- format lint ----------------------------------------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?P<labels>\{[^{}]*\})?"
                        r" (?P<value>\S+)$")
_LABEL_RE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')
_TYPES = ("counter", "gauge", "summary", "histogram", "untyped")


def _base_name(name: str) -> str:
    """A sample's family: summary and histogram suffixes map back."""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def lint(text: str) -> list[str]:
    """Format errors of one exposition (empty = clean)."""
    errors: list[str] = []
    if text and not text.endswith("\n"):
        errors.append("exposition must end with a newline")
    typed: dict[str, str] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) != 4:
                    errors.append(f"line {i}: malformed TYPE comment")
                    continue
                _, _, name, mtype = parts
                if not _NAME_RE.match(name):
                    errors.append(f"line {i}: invalid metric name {name!r}")
                if mtype not in _TYPES:
                    errors.append(f"line {i}: unknown type {mtype!r}")
                if name in typed:
                    errors.append(f"line {i}: duplicate TYPE for {name}")
                typed[name] = mtype
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {i}: unparseable sample {line!r}")
            continue
        labels = m.group("labels")
        if labels:
            for pair in _split_labels(labels[1:-1]):
                if pair and not _LABEL_RE.match(pair):
                    errors.append(f"line {i}: bad label {pair!r}")
        try:
            float(m.group("value"))
        except ValueError:
            errors.append(f"line {i}: non-numeric value {m.group('value')!r}")
        if _base_name(m.group("name")) not in typed and m.group("name") not in typed:
            errors.append(f"line {i}: sample {m.group('name')} has no preceding TYPE")
    return errors


def _split_labels(inner: str) -> list[str]:
    """Split ``k="v",k2="v2"`` on the commas outside quotes."""
    out, buf, in_q, esc = [], [], False, False
    for ch in inner:
        if esc:
            buf.append(ch)
            esc = False
            continue
        if ch == "\\":
            buf.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
        if ch == "," and not in_q:
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf:
        out.append("".join(buf))
    return out
