"""Seeded, deterministic fault schedules keyed to controller windows: the
port of ``cdrs_tpu/faults/schedule.py``, host numpy, the same events for
the same specs and seeds.

A ``FaultSchedule`` is an ordered list of infrastructure events, each
pinned to a window index of the controller's grid, so a replay over the
same log gives the same failure trajectory and a kill/resume mid-fault is
bit-identical (the schedule is configuration; its consequences live in
``ClusterState`` and ride the checkpoint).

Event kinds:

* ``crash`` / ``recover`` — node down (replicas unavailable, not
  destroyed) / back with its replicas;
* ``decommission`` — node removed for good, its replicas destroyed;
* ``flaky`` / ``unflaky`` — repair copies to the node fail with the given
  probability (seeded, stateless rolls in ``faults/repair.py``);
* ``partition`` / ``heal`` — a ``+``-joined node set becomes unreachable
  as a group, replicas intact;
* ``degrade`` / ``restore`` — straggler: the node moves data at
  ``factor`` times its nominal throughput;
* ``corrupt`` — silent rot of a seeded fraction of the node's copies
  (``corrupt:dn2@3:0.25``) or of one file's copy (``corrupt:dn2#17@3``).

Specs: ``crash:dn2@3``, ``crash:dn2@3-7`` (crash at 3, recover at 8),
``flaky:dn1@2-6:0.5``, ``partition:dn2+dn3@4-6``, ``degrade:dn3@2-6:0.25``,
``corrupt:dn2@3:0.25``; crash, recover, decommission, partition and heal
also take a domain scope (``crash:rack:r0@3``), resolved against a
topology by ``expand_domains``.  ``random`` draws a schedule from a numpy
generator and never downs the last node up.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace

import numpy as np

__all__ = ["FaultEvent", "FaultSchedule"]

#: Within one window, events apply in this order (healing kinds first).
KINDS: tuple[str, ...] = ("recover", "heal", "unflaky", "restore", "crash", "partition",
                          "flaky", "degrade", "decommission", "corrupt")
_KIND_ORDER = {k: i for i, k in enumerate(KINDS)}
#: Kinds whose span form (``@lo-hi``) expands to (start kind, end kind).
_SPAN_END = {"crash": "recover", "flaky": "unflaky", "partition": "heal",
             "degrade": "restore"}
#: Kinds that accept a ``level:name`` domain scope.
_SCOPE_KINDS = ("crash", "recover", "decommission", "partition", "heal")


@dataclass(frozen=True)
class FaultEvent:
    """One infrastructure event at a window boundary."""

    window: int
    kind: str       # one of KINDS
    #: Node name; partition/heal accept a ``+``-joined group.
    node: str
    #: flaky: failure probability of a repair copy to the node; corrupt:
    #: the seeded fraction of its copies that rot.
    fail_prob: float = 0.0
    #: degrade: throughput multiplier in (0, 1].
    factor: float = 1.0
    #: corrupt: the one file whose copy rots (-1: the seeded fraction).
    file: int = -1

    def __post_init__(self):
        if self.kind not in _KIND_ORDER:
            raise ValueError(f"unknown fault kind {self.kind!r} (want one of {KINDS})")
        if self.window < 0:
            raise ValueError(f"fault window must be >= 0, got {self.window}")
        if not 0.0 <= self.fail_prob <= 1.0:
            raise ValueError(f"fail_prob must be in [0, 1], got {self.fail_prob}")
        if not 0.0 < self.factor <= 1.0:
            raise ValueError(f"degrade factor must be in (0, 1], got {self.factor}")
        if "+" in self.node and self.kind not in ("partition", "heal"):
            raise ValueError(f"node groups ('+') are only valid for partition/heal, "
                             f"not {self.kind!r} ({self.node!r})")
        if ":" in self.node and self.kind not in _SCOPE_KINDS:
            raise ValueError(f"domain scopes ('level:name', e.g. 'region:eu') are only "
                             f"valid for {'/'.join(_SCOPE_KINDS)}, not {self.kind!r} "
                             f"({self.node!r})")
        if self.file >= 0 and self.kind != "corrupt":
            raise ValueError(f"file targeting is only valid for corrupt, not {self.kind!r}")

    @property
    def node_list(self) -> tuple[str, ...]:
        """The event's nodes (partition/heal groups split on ``+``)."""
        return tuple(self.node.split("+"))

    def spec(self) -> str:
        if self.kind == "corrupt":
            if self.file >= 0:
                return f"corrupt:{self.node}#{self.file}@{self.window}"
            return f"corrupt:{self.node}@{self.window}:{self.fail_prob:g}"
        s = f"{self.kind}:{self.node}@{self.window}"
        if self.kind == "flaky":
            s += f":{self.fail_prob:g}"
        elif self.kind == "degrade":
            s += f":{self.factor:g}"
        return s


class _EventsView(tuple):
    """The schedule's event tuple; calling it gives a mutable list copy."""

    def __call__(self) -> list:
        return list(self)


class FaultSchedule:
    """Immutable, window-sorted event list (see the module docstring)."""

    def __init__(self, events=()):
        evs = tuple(sorted(events, key=lambda e: (e.window, _KIND_ORDER[e.kind], e.node)))
        self.events: tuple[FaultEvent, ...] = _EventsView(evs)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def for_window(self, w: int) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.window == int(w))

    @property
    def max_window(self) -> int:
        return max((e.window for e in self.events), default=-1)

    def nodes(self) -> tuple[str, ...]:
        return tuple(sorted({n for e in self.events for n in e.node_list}))

    def validate_nodes(self, topology_nodes) -> None:
        scoped = sorted(n for n in self.nodes() if ":" in n)
        if scoped:
            raise ValueError(f"fault schedule still carries unexpanded domain scopes "
                             f"{scoped}; resolve them against the topology first "
                             "(FaultSchedule.expand_domains)")
        unknown = sorted(set(self.nodes()) - set(topology_nodes))
        if unknown:
            raise ValueError(f"fault schedule names nodes outside the topology "
                             f"{tuple(topology_nodes)}: {unknown}")

    def expand_domains(self, topology) -> "FaultSchedule":
        """Resolve ``level:name`` scopes against a topology: one event per
        node of the domain, or one atomic group for partition/heal.
        Scope-free schedules return ``self``."""
        if not any(":" in n for e in self.events for n in e.node_list):
            return self
        events: list[FaultEvent] = []
        for e in self.events:
            if not any(":" in n for n in e.node_list):
                events.append(e)
                continue
            resolved: list[str] = []
            for token in e.node_list:
                if ":" not in token:
                    resolved.append(token)
                    continue
                level, dom = token.split(":", 1)
                try:
                    resolved.extend(topology.nodes_in(level, dom))
                except (ValueError, AttributeError) as err:
                    raise ValueError(f"fault event {e.spec()!r}: {err}") from None
            kw = {"fail_prob": e.fail_prob, "factor": e.factor, "file": e.file}
            if e.kind in ("partition", "heal"):
                events.append(FaultEvent(e.window, e.kind, "+".join(resolved), **kw))
            else:
                events.extend(FaultEvent(e.window, e.kind, n, **kw) for n in resolved)
        return FaultSchedule(events)

    # -- event-level editing --------------------------------------------------
    @classmethod
    def from_events(cls, events) -> "FaultSchedule":
        """A schedule from ``FaultEvent``s or ``to_json`` dicts."""
        rows = list(events)
        if rows and isinstance(rows[0], dict):
            return cls.from_json(rows)
        return cls(rows)

    def drop(self, index: int) -> "FaultSchedule":
        rows = self.events()
        del rows[index]
        return FaultSchedule(rows)

    def splice(self, event: FaultEvent) -> "FaultSchedule":
        return FaultSchedule((*self.events, event))

    def retime(self, index: int, window: int) -> "FaultSchedule":
        return self.mutate(index, window=int(window))

    def mutate(self, index: int, **changes) -> "FaultSchedule":
        rows = self.events()
        rows[index] = _dc_replace(rows[index], **changes)
        return FaultSchedule(rows)

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_specs(cls, specs) -> "FaultSchedule":
        """Parse ``kind:node@window`` specs (see the module docstring).
        Spans are inclusive; flaky's probability defaults to 0.5, degrade's
        factor to 0.5 and corrupt's fraction to 0.1."""
        events: list[FaultEvent] = []
        for spec in specs:
            try:
                kind, rest = spec.split(":", 1)
                if kind in ("flaky", "degrade", "corrupt") and rest.count(":") == 1:
                    rest, prob_s = rest.rsplit(":", 1)
                    prob = float(prob_s)
                else:
                    prob = 0.1 if kind == "corrupt" else 0.5
                node, span = rest.split("@", 1)
                file_idx = -1
                if kind == "corrupt" and "#" in node:
                    node, fid_s = node.split("#", 1)
                    file_idx = int(fid_s)
                    if file_idx < 0:
                        raise ValueError
                if "-" in span:
                    lo, hi = (int(s) for s in span.split("-", 1))
                else:
                    lo = hi = int(span)
            except ValueError:
                raise ValueError(
                    f"bad fault spec {spec!r} (want kind:node@window, e.g. 'crash:dn2@3', "
                    f"'crash:dn2@3-7', 'flaky:dn1@2-6:0.5', 'partition:dn2+dn3@4-6', "
                    f"'degrade:dn3@2-6:0.25', 'corrupt:dn2@3:0.25', 'corrupt:dn2#17@3')"
                ) from None
            kw = {}
            if kind == "flaky":
                kw["fail_prob"] = prob
            elif kind == "degrade":
                kw["factor"] = prob
            elif kind == "corrupt":
                kw["fail_prob"] = prob
                kw["file"] = file_idx
            if "-" in span:
                if hi < lo:
                    raise ValueError(f"bad fault span in {spec!r}: {hi} < {lo}")
                if kind not in _SPAN_END:
                    raise ValueError(f"spans are only valid for {'/'.join(_SPAN_END)}, "
                                     f"not {kind!r} ({spec!r})")
                events += [FaultEvent(lo, kind, node, **kw),
                           FaultEvent(hi + 1, _SPAN_END[kind], node)]
            else:
                events.append(FaultEvent(lo, kind, node, **kw))
        return cls(events)

    @classmethod
    def cascade(cls, nodes, start: int, spacing: int = 1,
                recover_after: int | None = None) -> "FaultSchedule":
        """``nodes[i]`` crashes at window ``start + i * spacing`` and, when
        ``recover_after`` is given, recovers that many windows later."""
        nodes = tuple(nodes)
        if not nodes:
            raise ValueError("cascade needs at least one node")
        if spacing < 1:
            raise ValueError(f"spacing must be >= 1, got {spacing}")
        events = []
        for i, n in enumerate(nodes):
            w = int(start) + i * int(spacing)
            events.append(FaultEvent(w, "crash", n))
            if recover_after is not None:
                if recover_after < 1:
                    raise ValueError(f"recover_after must be >= 1, got {recover_after}")
                events.append(FaultEvent(w + int(recover_after), "recover", n))
        return cls(events)

    @classmethod
    def rolling_decommission(cls, nodes, start: int, spacing: int = 2) -> "FaultSchedule":
        """``nodes[i]`` is decommissioned at window ``start + i * spacing``."""
        nodes = tuple(nodes)
        if not nodes:
            raise ValueError("rolling_decommission needs at least one node")
        if spacing < 1:
            raise ValueError(f"spacing must be >= 1, got {spacing}")
        return cls([FaultEvent(int(start) + i * int(spacing), "decommission", n)
                    for i, n in enumerate(nodes)])

    @classmethod
    def random(cls, nodes, n_windows: int, seed: int = 0, crash_rate: float = 0.08,
               recover_windows=(2, 5), flaky_rate: float = 0.04, flaky_prob: float = 0.5,
               degrade_rate: float = 0.0, degrade_factor: float = 0.25,
               corrupt_rate: float = 0.0, corrupt_frac: float = 0.05) -> "FaultSchedule":
        """Seeded random schedule: per window each up node crashes with
        ``crash_rate`` (recovering a uniform ``recover_windows`` span later),
        else turns flaky for one window with ``flaky_rate``, else (rates
        above 0 only) degrades for one window or rots ``corrupt_frac`` of
        its copies.  The last node up never crashes."""
        rng = np.random.default_rng(seed)
        nodes = tuple(nodes)
        up = {n: True for n in nodes}
        pending_recover: dict[str, int] = {}
        events: list[FaultEvent] = []
        for w in range(int(n_windows)):
            for n, rw in list(pending_recover.items()):
                if rw == w:
                    events.append(FaultEvent(w, "recover", n))
                    up[n] = True
                    del pending_recover[n]
            for n in nodes:
                if not up[n]:
                    continue
                if rng.random() < crash_rate and sum(up.values()) > 1:
                    span = int(rng.integers(recover_windows[0], recover_windows[1] + 1))
                    events.append(FaultEvent(w, "crash", n))
                    up[n] = False
                    pending_recover[n] = w + span
                elif rng.random() < flaky_rate:
                    events += [FaultEvent(w, "flaky", n, fail_prob=flaky_prob),
                               FaultEvent(w + 1, "unflaky", n)]
                elif degrade_rate and rng.random() < degrade_rate:
                    events += [FaultEvent(w, "degrade", n, factor=degrade_factor),
                               FaultEvent(w + 1, "restore", n)]
                elif corrupt_rate and rng.random() < corrupt_rate:
                    events.append(FaultEvent(w, "corrupt", n, fail_prob=corrupt_frac))
        # Recoveries past the horizon still land.
        for n, rw in sorted(pending_recover.items()):
            events.append(FaultEvent(rw, "recover", n))
        return cls(events)

    # -- serialization (the ``chaos --schedule`` JSON) -------------------------
    def to_json(self) -> list[dict]:
        return [{"window": e.window, "kind": e.kind, "node": e.node,
                 **({"fail_prob": e.fail_prob} if e.kind in ("flaky", "corrupt") else {}),
                 **({"factor": e.factor} if e.kind == "degrade" else {}),
                 **({"file": e.file} if e.kind == "corrupt" and e.file >= 0 else {})}
                for e in self.events]

    @classmethod
    def from_json(cls, rows) -> "FaultSchedule":
        return cls([FaultEvent(int(r["window"]), r["kind"], r["node"],
                               fail_prob=float(r.get("fail_prob", 0.0)),
                               factor=float(r.get("factor", 1.0)),
                               file=int(r.get("file", -1)))
                    for r in rows])

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FaultSchedule({[e.spec() for e in self.events]})"
