"""Streaming alert rules over window records: ``cdrs_tpu/obs/alerts.py``.

Declarative :class:`AlertRule` s are evaluated incrementally, one
``AlertEngine.observe`` per window record, as the daemon produces them.
Three kinds:

* ``threshold`` — a dotted ``field`` path into the record (or a tuple of
  paths, summed) against ``value``; fires after ``for_windows``
  consecutive matching windows and resolves at the first that does not.
* ``burn_rate`` — the short/long pair of trailing means of ``slo_burn``;
  fires when both reach ``factor`` and resolves when the short mean drops
  below it.  Windows without the field are skipped.
* ``absence`` — staleness of the stream; any arriving window resolves it.

A record that lacks a rule's field leaves the rule alone (neither fires
nor resolves): the rules on fields of unported subsystems (serving) stay in
the table and never apply to the port's records, as in the reference when
those subsystems are off.  :func:`evaluate_records` is the batch verdict
over a list of window records (the scenario harness's alert gates); its
``finish`` fires the absence rules of a stream with no window at all.  The
wall-clock staleness poll of the reference belongs to ``cdrs metrics
alerts``, which the port does not have yet (ROADMAP A10b).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

__all__ = ["AlertRule", "AlertEngine", "default_rules", "rules_from_json", "evaluate_records",
           "DEFAULT_RULE_NAMES", "SEVERE_ALERTS"]

_KINDS = ("threshold", "burn_rate", "absence")
_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
}

#: Alerts whose firing means data went missing: the page-severity set on
#: which the daemon lands a protective checkpoint.
SEVERE_ALERTS = frozenset({"files_lost", "true_lost"})


@dataclass(frozen=True)
class AlertRule:
    """One declarative rule (see the module docstring for the kinds)."""

    name: str
    kind: str = "threshold"
    #: Dotted path into the window record, or a tuple of paths summed
    #: (missing components count 0; all missing = the rule does not apply).
    field: str | tuple[str, ...] | None = None
    op: str = ">"
    value: float = 0.0
    #: Consecutive matching windows before a threshold rule fires.
    for_windows: int = 1
    #: Burn-rate pair, in windows.
    short_windows: int = 1
    long_windows: int = 1
    factor: float = 1.0
    #: Absence rule: staleness bound of a follow session, seconds.
    stale_seconds: float = 600.0
    #: ``page`` or ``ticket``.
    severity: str = "ticket"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"alert {self.name!r}: unknown kind {self.kind!r} "
                             f"(want one of {_KINDS})")
        if self.kind == "threshold":
            if self.field is None:
                raise ValueError(f"alert {self.name!r}: threshold rules need a field")
            if self.op not in _OPS:
                raise ValueError(f"alert {self.name!r}: unknown op {self.op!r} "
                                 f"(want one of {sorted(_OPS)})")
            if self.for_windows < 1:
                raise ValueError(f"alert {self.name!r}: for_windows must be >= 1")
        if self.kind == "burn_rate":
            if not 1 <= self.short_windows <= self.long_windows:
                raise ValueError(
                    f"alert {self.name!r}: need 1 <= short_windows <= long_windows, "
                    f"got {self.short_windows}/{self.long_windows}")
            if self.factor <= 0:
                raise ValueError(f"alert {self.name!r}: factor must be > 0")
        if self.kind == "absence" and self.stale_seconds <= 0:
            raise ValueError(f"alert {self.name!r}: stale_seconds must be > 0")
        if self.severity not in ("page", "ticket"):
            raise ValueError(f"alert {self.name!r}: severity must be 'page' or 'ticket', "
                             f"got {self.severity!r}")
        if isinstance(self.field, list):
            object.__setattr__(self, "field", tuple(self.field))

    def to_dict(self) -> dict:
        d = asdict(self)
        if isinstance(d["field"], tuple):
            d["field"] = list(d["field"])
        return d


def default_rules() -> tuple[AlertRule, ...]:
    """The reference's built-in rule set, in its order."""
    R = AlertRule
    return (
        R("files_lost", field="durability.lost", severity="page"),
        R("true_lost", field="integrity.true_lost", severity="page"),
        R("durability_degraded",
          field=("durability.lost", "durability.at_risk", "durability.under_replicated")),
        R("unreachable_stranded", field="durability.unreachable"),
        R("correlated_risk", field="durability.correlated_risk", for_windows=2),
        R("repair_backlog", field="repair_backlog", for_windows=3),
        R("budget_saturated", field="deferred_budget", for_windows=3),
        # Only brownout daemon records carry ``daemon.lag_windows``.
        R("daemon_lagging", field="daemon.lag_windows", value=2.0, op=">=", for_windows=2),
        R("scrub_starved", field="scrub.starved", for_windows=2),
        R("corruption_detected",
          field=("integrity.detected_scrub", "integrity.detected_read",
                 "integrity.detected_repair"), severity="page"),
        R("reads_unavailable", field="reads_unavailable", severity="page"),
        R("slo_burn_fast", kind="burn_rate", field="slo_burn", short_windows=1,
          long_windows=3, factor=2.0, severity="page"),
        R("slo_burn_slow", kind="burn_rate", field="slo_burn", short_windows=2,
          long_windows=6, factor=1.0),
        R("stage_plan_latency", field="seconds.plan", value=2.0, for_windows=3),
        R("decision_latency", field="seconds.total", value=10.0, for_windows=3),
        R("no_data", kind="absence", stale_seconds=600.0),
    )


#: Names of the built-in rules (scenario specs validate their alert axes
#: against them).
DEFAULT_RULE_NAMES: frozenset = frozenset(r.name for r in default_rules())


def rules_from_json(obj) -> tuple[AlertRule, ...]:
    """Rules from a JSON list of :meth:`AlertRule.to_dict` objects (or its
    text); unknown keys and duplicate names raise."""
    if isinstance(obj, str):
        obj = json.loads(obj)
    if not isinstance(obj, list):
        raise ValueError("alert rules JSON must be a list of rule objects")
    allowed = set(AlertRule.__dataclass_fields__)
    rules = []
    for d in obj:
        unknown = set(d) - allowed
        if unknown:
            raise ValueError(f"alert rule {d.get('name', '?')!r}: unknown keys "
                             f"{sorted(unknown)}")
        rules.append(AlertRule(**d))
    names = [r.name for r in rules]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate alert rule names in {names}")
    return tuple(rules)


def _resolve(rec: dict, path) -> float | None:
    """The value of a dotted path (or the sum of a tuple of paths) in a
    record; None when the record does not carry it."""
    if isinstance(path, tuple):
        live = [v for v in (_resolve(rec, p) for p in path) if v is not None]
        return sum(live) if live else None
    cur = rec
    for part in str(path).split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    if cur is None:
        return None
    if isinstance(cur, bool):
        return 1.0 if cur else 0.0
    try:
        return float(cur)
    except (TypeError, ValueError):
        return None


class _RuleState:
    __slots__ = ("streak", "window_values", "firing", "fired", "since", "transitions")

    def __init__(self):
        self.streak = 0
        self.window_values: list[float] = []
        self.firing = False
        self.fired = False
        self.since: int | None = None
        self.transitions: list[dict] = []


class AlertEngine:
    """Incremental evaluator: ``observe`` events, read ``results``."""

    def __init__(self, rules=None):
        self.rules: tuple[AlertRule, ...] = tuple(rules) if rules is not None \
            else default_rules()
        self._st = {r.name: _RuleState() for r in self.rules}
        self.windows_seen = 0

    def _fire(self, rule: AlertRule, st: _RuleState, window, value) -> dict:
        st.firing = True
        st.fired = True
        st.since = window
        t = {"alert": rule.name, "state": "firing", "window": window,
             "severity": rule.severity}
        if value is not None:
            t["value"] = round(float(value), 6)
        st.transitions.append(t)
        return t

    def _resolve_alert(self, rule: AlertRule, st: _RuleState, window) -> dict:
        st.firing = False
        t = {"alert": rule.name, "state": "resolved", "window": window,
             "severity": rule.severity}
        st.transitions.append(t)
        return t

    def observe(self, event: dict) -> list[dict]:
        """Evaluate one stream event; returns the transitions it caused
        (none for events other than window records)."""
        if event.get("kind") != "window":
            return []
        self.windows_seen += 1
        w = event.get("window")
        out: list[dict] = []
        for rule in self.rules:
            st = self._st[rule.name]
            if rule.kind == "threshold":
                v = _resolve(event, rule.field)
                hit = v is not None and _OPS[rule.op](v, rule.value)
                st.streak = st.streak + 1 if hit else 0
                if not st.firing and st.streak >= rule.for_windows:
                    out.append(self._fire(rule, st, w, v))
                elif st.firing and not hit:
                    out.append(self._resolve_alert(rule, st, w))
            elif rule.kind == "burn_rate":
                v = _resolve(event, rule.field or "slo_burn")
                if v is None:
                    continue
                st.window_values.append(v)
                del st.window_values[:-rule.long_windows]
                vals = st.window_values
                if len(vals) < rule.long_windows:
                    continue  # no long-window history yet: a first spike must not page
                short = sum(vals[-rule.short_windows:]) / rule.short_windows
                long_ = sum(vals) / len(vals)
                if not st.firing and short >= rule.factor and long_ >= rule.factor:
                    out.append(self._fire(rule, st, w, short))
                elif st.firing and short < rule.factor:
                    out.append(self._resolve_alert(rule, st, w))
            elif st.firing:
                out.append(self._resolve_alert(rule, st, w))
        return out

    def finish(self) -> list[dict]:
        """End of a batch stream: absence rules fire iff it carried no window
        record at all."""
        out = []
        if self.windows_seen == 0:
            for rule in self.rules:
                st = self._st[rule.name]
                if rule.kind == "absence" and not st.firing:
                    out.append(self._fire(rule, st, None, None))
        return out

    def results(self) -> list[dict]:
        """Per-rule verdicts in rule order: ``{name, severity, kind, firing,
        fired, since, streak, transitions}``."""
        return [{"name": r.name, "severity": r.severity, "kind": r.kind,
                 "firing": self._st[r.name].firing, "fired": self._st[r.name].fired,
                 "since": self._st[r.name].since, "streak": self._st[r.name].streak,
                 "transitions": list(self._st[r.name].transitions)}
                for r in self.rules]


def evaluate_records(records: list[dict], rules=None) -> list[dict]:
    """Batch verdicts (:meth:`AlertEngine.results`) over window records:
    each record is observed as a window event, then the stream finishes."""
    eng = AlertEngine(rules)
    for r in records:
        eng.observe(r if r.get("kind") == "window" else {"kind": "window", **r})
    eng.finish()
    return eng.results()
