"""Coverage-guided failure-space search: mutate, measure, shrink; the port of
``cdrs_tpu/scenarios/search.py``, host numpy over the port's harness.

The scenario matrix only checks the combinations an author wrote; this
module searches the same axes (Yuan et al., OSDI 2014: most catastrophic
failures live in error paths never exercised, and reproduce with at most
three input events):

* **mutate** — ``mutate_spec`` applies seeded, validity-preserving
  mutations to a corpus cell (fault-schedule event edits, workload and
  drift changes, topology / storage / serve / scrub / budget / scale
  toggles); every candidate revalidates through ``ScenarioSpec`` and a
  schedule preflight.
* **measure** — each candidate runs through ``run_cell`` (on ``device``:
  the controller's re-clusters run the Lloyd kernel) and is scored by its
  coverage fingerprint; cells lighting up new bits join the corpus.
* **shrink** — a violation (or harness crash) goes through
  ``shrink_cell``: delta debugging (ddmin) over the fault-schedule events,
  ending in the one-line ``repro_line``.

The corpus is banked as JSON (one file per kept cell, violations under
``violations/``); ``distill_corpus`` picks a small cell set covering the
frontier and ``triage_corpus`` reruns the banked violations under
``triage-*`` names.  Search cells are named ``search-s<seed>-<fp8>``.
Everything is deterministic in ``seed`` for a fixed cell budget (the
mutations draw from the reference's ``default_rng([seed, 19, i])``
streams, so they equal its mutations); a wall-clock budget only truncates
the same sequence.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..cluster.placement import ClusterTopology
from ..faults.schedule import FaultEvent, FaultSchedule
from ..obs.aggregate import coverage_fingerprint
from .harness import build_schedule, repro_line, run_cell
from .presets import PRESETS, preset
from .spec import ScenarioSpec

__all__ = ["SEARCH_BASE", "distill_corpus", "load_corpus", "mutate_spec",
           "planted_violation_spec", "run_search", "search_cell_name",
           "shrink_cell", "triage_corpus"]

#: Cell-name prefixes reserved for generated cells; presets must never
#: use them (regress/history keys are ``scenario_<name>_*`` — a preset
#: named like a generated cell would alias its baselines).
RESERVED_NAME_PREFIXES = ("random-", "search-", "triage-")

#: Seed corpus of the search: cheap, numpy-only presets spanning the
#: fault / partition / storage / integrity / serve / drift domains.
#: (Expensive axes — daemon, mesh, kill/resume sampling — are stripped
#: by ``_sanitize``; the search optimizes cells-per-second.)
SEARCH_BASE: tuple[str, ...] = (
    "chaos-kill", "rack-partition", "cascade", "rolling-decommission",
    "storage-ec", "serve-chaos", "integrity-scrub", "diurnal",
    "gradual-drift")

_RACKS6 = "r0=dn1,dn2;r1=dn3,dn4;r2=dn5,dn6"
_NODES6 = ("dn1", "dn2", "dn3", "dn4", "dn5", "dn6")
#: Small inline EC config valid on any >= 3-node cell (the named
#: ``ec_archival`` preset stripes wider than small topologies allow).
_EC_SMALL = {"strategies": {"Archival": {"k": 2, "m": 1, "tier": "cold"}}}


def search_cell_name(seed: int, fingerprint: str) -> str:
    """``search-s<seed>-<fp8>``: the cell IS a function of the search
    seed and its behaviour set, so the name (and with it every
    ``scenario_<name>_*`` history key) can never alias a preset or a
    ``random-s<seed>-<i>`` cell."""
    return f"search-s{int(seed)}-{fingerprint[:8]}"


def _sanitize(spec: ScenarioSpec, name: str | None = None) -> ScenarioSpec:
    """A search-ready copy of ``spec``: drop the axes whose gates encode
    per-preset AUTHOR expectations (alert expect/forbid lists, tuned
    p99/burn bounds) — a mutant tripping those is stale tuning, not a
    robustness finding — and the expensive sampling axes (daemon,
    kill/resume triple-runs, jax mesh) that would cut cells-per-second
    without adding fault-space reach.  Alert FIRING stays a coverage
    signal either way (``alert:*`` bits come from evaluate_records, not
    from the alerts axis).  A mesh cell runs on one device (the mesh
    axis is what the port refuses)."""
    serve = spec.serve
    if serve is not None:
        serve = {k: v for k, v in serve.items()
                 if k not in ("p99_max_ms", "burn_max")}
    kw = dict(alerts=None, resume_window=None, daemon=False, serve=serve)
    if spec.mesh is not None:
        kw.update(mesh=None, backend="numpy")
    if name is not None:
        kw["name"] = name
    out = spec.replace(**kw)
    return out


def _frozen_faults(spec: ScenarioSpec) -> ScenarioSpec:
    """The spec with its faults axis decomposed to explicit event specs
    (templates and the seeded random generator frozen into the concrete
    events they produce), so event-level edits can apply."""
    if spec.faults is None:
        return spec
    sched = build_schedule(spec)
    return spec.replace(faults={"specs": [e.spec() for e in sched]})


def _preflight(spec: ScenarioSpec) -> None:
    """Reject a candidate the harness would reject, without running it:
    the schedule must build, and after domain-scope expansion every
    event node must exist in the topology."""
    sched = build_schedule(spec)
    if sched is None:
        return
    if spec.topology is not None:
        sched = sched.expand_domains(
            ClusterTopology.from_hierarchy(spec.topology))
    sched.validate_nodes(spec.nodes)


# -- mutation operators ------------------------------------------------------
# Each operator takes (spec, rng) and returns a mutated spec or None
# (not applicable).  Operators may raise ValueError (spec revalidation);
# mutate_spec treats that as "try another draw".

def _events_of(spec: ScenarioSpec) -> list[FaultEvent]:
    sched = build_schedule(spec)
    return sched.events() if sched is not None else []


def _with_events(spec: ScenarioSpec,
                 events: list[FaultEvent]) -> ScenarioSpec | None:
    if not events:
        if spec.scrub is not None:
            return None  # scrub requires a faults axis
        return spec.replace(faults=None)
    sched = FaultSchedule.from_events(events)
    return spec.replace(faults={"specs": [e.spec() for e in sched]})


def _op_fault_add(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    events = _events_of(spec)
    nw = int(spec.n_windows)
    # Healing faults (spans) may land anywhere that heals by the end;
    # destructive ones (decommission) stay in the first ~60% so repair
    # has windows to act — a "loses data because nothing could ever
    # repair it" cell is noise, not a finding.
    kind = ("crash", "partition", "flaky", "degrade", "corrupt",
            "decommission")[int(rng.integers(6))]
    node = str(spec.nodes[int(rng.integers(len(spec.nodes)))])
    if kind == "decommission":
        n_dec = sum(1 for e in events if e.kind == "decommission")
        if n_dec + 1 >= max(len(spec.nodes) // 2, 1):
            return None  # keep the cluster survivable by construction
        w = 1 + int(rng.integers(max(int(nw * 0.6), 2)))
        ev = [FaultEvent(w, "decommission", node)]
    elif kind == "corrupt":
        w = 1 + int(rng.integers(max(nw - 3, 2)))
        if rng.random() < 0.25:
            ev = [FaultEvent(w, "corrupt", node,
                             file=int(rng.integers(spec.n_files)))]
        else:
            ev = [FaultEvent(w, "corrupt", node,
                             fail_prob=round(float(
                                 rng.uniform(0.05, 0.6)), 3))]
    else:
        lo = 1 + int(rng.integers(max(nw - 4, 2)))
        hi = min(lo + int(rng.integers(1, 4)) - 1, nw - 2)
        hi = max(hi, lo)
        if kind == "partition":
            group = node
            if len(spec.nodes) > 2 and rng.random() < 0.5:
                other = str(spec.nodes[int(rng.integers(len(spec.nodes)))])
                if other != node:
                    group = f"{node}+{other}"
            ev = [FaultEvent(lo, "partition", group),
                  FaultEvent(hi + 1, "heal", group)]
        elif kind == "crash":
            ev = [FaultEvent(lo, "crash", node),
                  FaultEvent(hi + 1, "recover", node)]
        elif kind == "flaky":
            ev = [FaultEvent(lo, "flaky", node,
                             fail_prob=round(float(
                                 rng.uniform(0.2, 0.9)), 3)),
                  FaultEvent(hi + 1, "unflaky", node)]
        else:
            ev = [FaultEvent(lo, "degrade", node,
                             factor=round(float(
                                 rng.uniform(0.1, 0.6)), 3)),
                  FaultEvent(hi + 1, "restore", node)]
    return _with_events(spec, events + ev)


def _op_fault_storm(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    """Correlated multi-node outage: overlapping crash spans on a
    random 2..4-node subset (healing by the end).  One draw reaches the
    states only SIMULTANEOUS failures produce — transient blind loss,
    repairs with no live source/target — that single-event edits need
    many lucky iterations to stack up."""
    if len(spec.nodes) < 3:
        return None
    events = _events_of(spec)
    n_hit = int(rng.integers(2, min(len(spec.nodes) - 1, 4) + 1))
    hit = list(rng.choice(len(spec.nodes), size=n_hit, replace=False))
    nw = int(spec.n_windows)
    lo = 1 + int(rng.integers(max(nw - 5, 2)))
    for j, ni in enumerate(hit):
        w0 = min(lo + int(rng.integers(2)), nw - 3)
        w1 = max(min(w0 + int(rng.integers(1, 3)), nw - 2), w0)
        node = str(spec.nodes[int(ni)])
        events += [FaultEvent(w0, "crash", node),
                   FaultEvent(w1 + 1, "recover", node)]
    return _with_events(spec, events)


def _op_fault_scope(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    """Add a whole-DOMAIN correlated event (geo cells only): crash or
    partition a random level:name scope — the failure mode a hierarchy
    exists to survive."""
    if spec.topology is None:
        return None
    events = _events_of(spec)
    levels = list(spec.topology.get("levels") or ())
    if not levels:
        return None
    level = levels[int(rng.integers(len(levels)))]
    domains = sorted(spec.topology.get(level) or ())
    if not domains:
        return None
    dom = domains[int(rng.integers(len(domains)))]
    nw = int(spec.n_windows)
    lo = 1 + int(rng.integers(max(nw - 5, 2)))
    hi = max(min(lo + int(rng.integers(1, 4)) - 1, nw - 2), lo)
    kind = "crash" if rng.random() < 0.5 else "partition"
    ev = [FaultEvent(lo, kind, f"{level}:{dom}"),
          FaultEvent(hi + 1,
                     "recover" if kind == "crash" else "heal",
                     f"{level}:{dom}")]
    return _with_events(spec, events + ev)


def _op_fault_drop(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    events = _events_of(spec)
    if not events:
        return None
    del events[int(rng.integers(len(events)))]
    return _with_events(spec, events)


def _op_fault_retime(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    events = _events_of(spec)
    if not events:
        return None
    i = int(rng.integers(len(events)))
    shift = int(rng.integers(1, 4)) * (1 if rng.random() < 0.5 else -1)
    w = max(events[i].window + shift, 0)
    sched = FaultSchedule.from_events(events).retime(i, w)
    return _with_events(spec, sched.events())


def _op_workload(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    kind = ("poisson", "diurnal", "flash_crowd")[int(rng.integers(3))]
    wl: dict = {"kind": kind}
    if kind == "diurnal":
        wl.update(amplitude=round(float(rng.uniform(0.3, 0.95)), 3),
                  phase=round(float(rng.uniform(0.0, 6.28)), 3))
    elif kind == "flash_crowd":
        wl.update(start_frac=round(float(rng.uniform(0.2, 0.6)), 3),
                  duration_frac=round(float(rng.uniform(0.05, 0.3)), 3),
                  boost=round(float(rng.uniform(15.0, 60.0)), 1),
                  cohort=("archival", "hot")[int(rng.integers(2))])
    drift = spec.drift if kind == "poisson" else None
    return spec.replace(workload=wl, drift=drift)


def _op_drift(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    if (spec.workload or {}).get("kind", "poisson") != "poisson":
        return None
    if spec.drift is not None and rng.random() < 0.3:
        return spec.replace(drift=None)
    kind = ("flip", "gradual", "adversarial")[int(rng.integers(3))]
    d: dict = {"kind": kind}
    if kind == "flip":
        d["at_frac"] = round(float(rng.uniform(0.3, 0.7)), 3)
    else:
        d.update(start_frac=round(float(rng.uniform(0.2, 0.4)), 3),
                 end_frac=round(float(rng.uniform(0.6, 0.85)), 3))
        if kind == "gradual":
            d["steps"] = int(rng.integers(2, 5))
        else:
            d["cycles"] = int(rng.integers(2, 5))
    return spec.replace(drift=d, drift_threshold=0.02)


def _op_serve(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    if spec.serve is not None:
        if spec.elastic is not None:
            return None  # elastic requires the serve axis
        return spec.replace(serve=None)
    return spec.replace(serve={
        "policy": ("p2c", "least_loaded", "random")[int(rng.integers(3))],
        "verify_reads": bool(rng.random() < 0.5)})


def _op_scrub(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    if spec.scrub is not None:
        return spec.replace(scrub=None)
    if spec.faults is None:
        return None
    return spec.replace(
        scrub=int(rng.integers(50, 500)) * 1_000_000)


def _op_storage(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    cur = spec.storage
    options: list = [None, "replicate"]
    if len(spec.nodes) >= 3:
        options.append(_EC_SMALL)
    options = [o for o in options if o != cur]
    return spec.replace(
        storage=options[int(rng.integers(len(options)))])


def _op_budget(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    return spec.replace(
        budget_frac=round(float(rng.uniform(0.08, 0.5)), 3))


def _op_racks(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    if spec.topology is not None:
        return None  # geo hierarchy subsumes the rack axis
    if spec.racks is None:
        # flat -> racked: the 5-node default grows to the racked 6.
        if set(spec.nodes) - set(_NODES6):
            return None
        return spec.replace(nodes=_NODES6, racks=_RACKS6)
    # racked -> flat: keep the node set, drop the domain map.
    return spec.replace(racks=None)


def _op_scale(spec: ScenarioSpec, rng) -> ScenarioSpec | None:
    if rng.random() < 0.5:
        return spec.replace(n_files=int(rng.integers(150, 450)))
    nw = int(np.clip(spec.n_windows + int(rng.integers(-2, 3)), 8, 20))
    return spec.replace(n_windows=nw)


#: (name, operator) — name order is the deterministic draw space.
MUTATORS: tuple = (
    ("fault_add", _op_fault_add),
    ("fault_add", _op_fault_add),      # double weight: the fault axis
    ("fault_storm", _op_fault_storm),  # is the failure-space frontier
    ("fault_scope", _op_fault_scope),
    ("fault_drop", _op_fault_drop),
    ("fault_retime", _op_fault_retime),
    ("workload", _op_workload),
    ("drift", _op_drift),
    ("serve", _op_serve),
    ("scrub", _op_scrub),
    ("storage", _op_storage),
    ("budget", _op_budget),
    ("racks", _op_racks),
    ("scale", _op_scale),
)


def mutate_spec(spec: ScenarioSpec, rng,
                n_ops: int = 1, max_tries: int = 24
                ) -> tuple[ScenarioSpec, list[str]] | None:
    """Apply ``n_ops`` seeded mutations to ``spec``, revalidating after
    each (ScenarioSpec invariants + schedule preflight).  Returns
    ``(mutant, [operator names])`` or None when ``max_tries`` draws
    could not produce a valid mutant.  Deterministic in ``rng``."""
    cur = _frozen_faults(_sanitize(spec))
    applied: list[str] = []
    tries = 0
    while len(applied) < int(n_ops) and tries < max_tries:
        tries += 1
        name, op = MUTATORS[int(rng.integers(len(MUTATORS)))]
        try:
            cand = op(cur, rng)
            if cand is None or cand.to_dict() == cur.to_dict():
                continue
            _preflight(cand)
        except ValueError:
            continue
        cur = cand
        applied.append(name)
    if not applied:
        return None
    return cur, applied


# -- shrinking (delta debugging over the fault schedule) ---------------------

def _failure_signature(spec: ScenarioSpec, device=None) -> frozenset | None:
    """What the cell did wrong: the set of failed invariants, or the
    exception class for harness crashes; None = the cell is green."""
    try:
        res = run_cell(spec, device=device)
    except Exception as err:  # a crash is a finding, not an abort
        return frozenset({f"error:{type(err).__name__}"})
    failed = frozenset(k for k, v in res["invariants"].items() if not v)
    return failed or None


def shrink_cell(spec: ScenarioSpec, *, max_runs: int = 200, device=None) -> dict:
    """Minimize a failing cell's fault schedule by delta debugging
    (ddmin): find a 1-minimal event subset that still reproduces the
    original failure (at least one originally-failed invariant still
    fails, or the same exception class).  Everything but the fault
    axis stays fixed — the OSDI-2014 claim is about EVENT count, and
    the schedule is the cell's event dimension.

    Returns ``{"spec", "events", "n_events", "failed", "repro",
    "oracle_runs"}``; deterministic for a given spec."""
    frozen = _frozen_faults(spec)
    original = _failure_signature(frozen, device)
    if original is None:
        raise ValueError(
            f"cell {spec.name!r} is green — nothing to shrink")
    events = _events_of(frozen)
    cache: dict[tuple, bool] = {}
    runs = 0

    def fails(subset: list[FaultEvent]) -> bool:
        nonlocal runs
        key = tuple(e.spec() for e in subset)
        if key in cache:
            return cache[key]
        if runs >= max_runs:
            return False  # budget exhausted: stop reducing
        cand = _with_events(frozen, subset)
        if cand is None:
            cache[key] = False
            return False
        runs += 1
        sig = _failure_signature(cand, device)
        out = sig is not None and bool(sig & original)
        cache[key] = out
        return out

    # ddmin (Zeller & Hildebrandt 2002): try subsets, then complements,
    # refining granularity until 1-minimal.
    n = 2
    while len(events) >= 2:
        chunk = max(len(events) // n, 1)
        subsets = [events[i:i + chunk]
                   for i in range(0, len(events), chunk)]
        reduced = False
        for sub in subsets:
            if len(sub) < len(events) and fails(sub):
                events, n, reduced = sub, 2, True
                break
        if not reduced:
            for i in range(len(subsets)):
                comp = [e for j, s in enumerate(subsets) if j != i
                        for e in s]
                if 0 < len(comp) < len(events) and fails(comp):
                    events, n, reduced = comp, max(n - 1, 2), True
                    break
        if not reduced:
            if n >= len(events):
                break
            n = min(len(events), 2 * n)

    shrunk = _with_events(frozen, events)
    final_sig = _failure_signature(shrunk, device)
    return {
        "spec": shrunk.to_dict(),
        "events": [e.spec() for e in events],
        "n_events": len(events),
        "failed": sorted(final_sig or ()),
        "repro": repro_line(shrunk),
        "oracle_runs": runs,
    }


def planted_violation_spec(seed: int = 0) -> ScenarioSpec:
    """The designed-bad oracle cell: on a 2-node rf-2 cluster, silent
    corruption of EVERY copy on dn2 (nothing verifies reads, no scrub)
    followed by decommission of dn1 — the last clean holder — leaves
    every file with only rotten bytes: ``true_lost`` = all files and
    ``zero_silent_loss`` fails, while the blind tiers still count dn2's
    copies as live.  Either event alone is survivable.  The noise spans
    (flaky/degrade/an early healed crash) are what the shrinker must
    strip: the known-minimal cause is exactly
    ``{corrupt:dn2@3:1, decommission:dn1@5}``."""
    return ScenarioSpec(
        name="planted-silent-loss", n_files=80, seed=int(seed),
        duration=960.0, n_windows=8, k=6, nodes=("dn1", "dn2"),
        faults={"specs": [
            "crash:dn2@1-1",
            "flaky:dn2@2-3:0.5",
            "degrade:dn1@2-4:0.5",
            "corrupt:dn2@3:1",
            "decommission:dn1@5",
        ]})


# -- corpus ------------------------------------------------------------------

def load_corpus(corpus_dir: str) -> list[dict]:
    """Banked corpus entries (green cells only), name-sorted for
    determinism.  Missing directory = empty corpus."""
    out = []
    if not os.path.isdir(corpus_dir):
        return out
    for fn in sorted(os.listdir(corpus_dir)):
        if not fn.endswith(".json") or fn == "distilled.json":
            continue
        path = os.path.join(corpus_dir, fn)
        if not os.path.isfile(path):
            continue
        with open(path, encoding="utf-8") as f:
            e = json.load(f)
        if "spec" in e and "coverage" in e:
            out.append(e)
    return out


def _bank(corpus_dir: str, entry: dict, sub: str | None = None) -> str:
    d = os.path.join(corpus_dir, sub) if sub else corpus_dir
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{entry['name']}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(entry, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def triage_corpus(corpus_dir: str, progress=None, device=None) -> dict:
    """Promote banked violations into named regression-locked cells.

    Every entry under ``<corpus_dir>/violations/`` is a bug the search
    once found; after the fix lands it must rerun GREEN forever.  This
    reruns each one (preferring the shrunk minimal spec) under a stable
    ``triage-*`` name and returns the same ``{"cells", "names"}`` shape
    ``distill_corpus`` emits — so the triage file plugs straight into
    the sweep's extra-cells slot and CI regression-locks the whole
    violation history.  ``ok`` is False while ANY violation still
    reproduces (the fix has not actually landed)."""
    vdir = os.path.join(corpus_dir, "violations")
    entries = []
    if os.path.isdir(vdir):
        for fn in sorted(os.listdir(vdir)):
            path = os.path.join(vdir, fn)
            if not fn.endswith(".json") or not os.path.isfile(path):
                continue
            with open(path, encoding="utf-8") as f:
                e = json.load(f)
            if isinstance(e, dict) and "spec" in e:
                entries.append(e)
    t0 = time.perf_counter()
    results, cells, names = [], [], []
    ok = True
    for e in entries:
        src = str(e.get("name") or "unnamed")
        name = "triage-" + (src[len("search-"):]
                            if src.startswith("search-") else src)
        doc = dict((e.get("shrunk") or {}).get("spec") or e["spec"])
        doc["name"] = name
        spec = ScenarioSpec.from_dict(doc)
        cell = run_cell(spec, device=device)
        green = bool(cell["ok"])
        ok = ok and green
        results.append({
            "name": name,
            "source": src,
            "ok": green,
            "failed": sorted(k for k, v in cell["invariants"].items()
                             if not v),
            "repro": cell["repro"],
            "seconds": cell["seconds"],
        })
        if progress is not None:
            progress(f"  [{'ok  ' if green else 'FAIL'}] {name} "
                     f"(from {src})")
        cells.append(spec.to_dict())
        names.append(name)
    return {
        "cells": cells,
        "names": names,
        "results": results,
        "n_violations": len(entries),
        "ok": ok,
        "seconds": round(time.perf_counter() - t0, 3),
    }


def distill_corpus(entries: list[dict]) -> dict:
    """Deterministic greedy set cover over the banked corpus: the
    minimal-ish cell list whose union covers every coverage bit any
    entry exhibits.  Ties break toward cheaper (seconds) then
    lexicographically earlier names, so the same corpus always distills
    to the same list."""
    remaining = {b for e in entries for b in e.get("coverage") or ()}
    covered: set[str] = set()
    chosen: list[dict] = []
    pool = list(entries)
    while remaining:
        scored = sorted(
            pool,
            key=lambda e: (-len(set(e.get("coverage") or ()) & remaining),
                           float(e.get("seconds", 0.0)),
                           str(e.get("name"))))
        best = scored[0] if scored else None
        if best is None or not (set(best.get("coverage") or ())
                                & remaining):
            break
        chosen.append(best)
        pool.remove(best)
        got = set(best.get("coverage") or ())
        covered |= got
        remaining -= got
    return {
        "cells": [e["spec"] for e in chosen],
        "names": [e["name"] for e in chosen],
        "coverage_bits": len(covered),
        "fingerprint": coverage_fingerprint(covered),
    }


# -- the search loop ---------------------------------------------------------

def run_search(*, seed: int = 0, budget_cells: int = 50,
               budget_seconds: float | None = None,
               corpus_dir: str = "data/search_corpus",
               base: tuple = SEARCH_BASE, shrink: bool = True,
               bank: bool = True, progress=None, device=None) -> dict:
    """The coverage-guided search loop (see module docstring).

    Deterministic in ``seed`` for a fixed ``budget_cells`` (per-
    iteration rng streams are ``[seed, 19, i]``); ``budget_seconds``
    only truncates the same sequence.  ``bank=False`` runs without
    touching ``corpus_dir`` (an A/B comparison's mode).  ``device`` is
    where every cell runs (CUDA unless "cpu" is asked for)."""
    t0 = time.perf_counter()
    say = progress or (lambda line: None)

    for name in PRESETS:
        if name.startswith(RESERVED_NAME_PREFIXES):  # pragma: no cover
            raise ValueError(
                f"preset {name!r} uses a reserved generated-cell prefix")

    # Seed corpus: banked entries (already measured) + base presets.
    banked = load_corpus(corpus_dir) if bank else []
    frontier: set[str] = set()
    parents: list[ScenarioSpec] = []
    for e in banked:
        frontier |= set(e["coverage"])
        parents.append(ScenarioSpec.from_dict(e["spec"]))
    baseline_banked = set(frontier)
    for name in base:
        sp = _sanitize(preset(name), name=name)
        res = run_cell(sp, device=device)
        frontier |= set(res["coverage"])
        parents.append(sp)
    baseline = set(frontier)
    say(f"seed corpus: {len(parents)} cells "
        f"({len(banked)} banked), {len(baseline)} coverage bits")

    discovered: list[ScenarioSpec] = []
    kept: list[dict] = []
    violations: list[dict] = []
    cells_run = 0
    iterations = 0
    for i in range(int(budget_cells)):
        if budget_seconds is not None \
                and time.perf_counter() - t0 > float(budget_seconds):
            say(f"wall budget hit after {i} iterations")
            break
        iterations = i + 1
        rng = np.random.default_rng([int(seed), 19, i])
        # AFL-ish queue bias: half the draws mutate a recent discovery.
        if discovered and rng.random() < 0.5:
            parent = discovered[int(rng.integers(len(discovered)))]
        else:
            parent = parents[int(rng.integers(len(parents)))]
        m = mutate_spec(parent, rng, n_ops=1 + int(rng.integers(4)))
        if m is None:
            continue
        cand, ops = m
        cand = cand.replace(name=f"search-cand-{i}")
        try:
            res = run_cell(cand, device=device)
        except Exception as err:
            cells_run += 1
            v = {"name": f"search-s{seed}-err-{i}", "iteration": i,
                 "parent": parent.name, "ops": ops,
                 "error": f"{type(err).__name__}: {err}",
                 "spec": cand.to_dict(), "repro": repro_line(cand)}
            if shrink:
                v["shrunk"] = shrink_cell(cand, device=device)
            violations.append(v)
            if bank:
                _bank(corpus_dir, v, sub="violations")
            say(f"[{i}] CRASH {type(err).__name__} via {parent.name} "
                f"({'+'.join(ops)})")
            continue
        cells_run += 1
        bits = set(res["coverage"])
        new = bits - frontier
        frontier |= new
        if not res["ok"]:
            fp = res["fingerprint"]
            vname = search_cell_name(seed, fp) + "-bad"
            final = cand.replace(name=vname)
            v = {"name": vname, "iteration": i, "parent": parent.name,
                 "ops": ops, "spec": final.to_dict(),
                 "failed": sorted(k for k, ok in res["invariants"].items()
                                  if not ok),
                 "coverage": sorted(bits), "fingerprint": fp,
                 "repro": repro_line(final)}
            if shrink:
                v["shrunk"] = shrink_cell(final, device=device)
            violations.append(v)
            if bank:
                _bank(corpus_dir, v, sub="violations")
            say(f"[{i}] VIOLATION {','.join(v['failed'])} "
                f"via {parent.name} ({'+'.join(ops)})"
                + (f" -> {v['shrunk']['n_events']} events"
                   if shrink else ""))
            continue
        if new:
            fp = res["fingerprint"]
            cname = search_cell_name(seed, fp)
            final = cand.replace(name=cname)
            entry = {"name": cname, "iteration": i,
                     "parent": parent.name, "ops": ops,
                     "spec": final.to_dict(),
                     "coverage": sorted(bits), "fingerprint": fp,
                     "new_bits": sorted(new),
                     "seconds": res["seconds"],
                     "repro": repro_line(final)}
            kept.append(entry)
            discovered.append(final)
            parents.append(final)
            if bank:
                _bank(corpus_dir, entry)
            say(f"[{i}] +{len(new)} bits ({cname}) via {parent.name} "
                f"({'+'.join(ops)}): "
                + ", ".join(sorted(new)[:4])
                + ("..." if len(new) > 4 else ""))
    return {
        "seed": int(seed),
        "budget_cells": int(budget_cells),
        "budget_seconds": budget_seconds,
        "iterations": iterations,
        "cells_run": cells_run,
        "base": list(base),
        "baseline_bits": len(baseline),
        "baseline_banked_bits": len(baseline_banked),
        "coverage_bits": len(frontier),
        "coverage": sorted(frontier),
        "fingerprint": coverage_fingerprint(frontier),
        "new_coverage_cells": len(kept),
        "kept": kept,
        "violations": violations,
        "seconds": round(time.perf_counter() - t0, 3),
    }
