"""Brownout ladder: ``cdrs_tpu/daemon/brownout.py``, unchanged.

The daemon's load signal is its decision lag in windows (how far the
resume cursor trails the log head).  Five rungs of shed work engage in
order as the lag crosses each rung's threshold, and release in reverse,
one rung per ``hold`` calm windows at or below the rung's release
threshold:

====================  ==================================================
rung                  what it sheds
====================  ==================================================
``skip_minibatch``    the observability-only mini-batch Lloyd step
``defer_scrub``       background verification reads
``cap_trace``         span-tree exemplars (stage sums stay)
``coalesce``          window granularity: up to ``coalesce_max`` pending
                      windows merge into one decision
``shed_reads``        a seeded fraction of the window's reads
====================  ==================================================

The ladder is a function of the lag series alone (plus the optional SLO
burn trip wire), so the same log replays the same transitions, and its
level and calm count ride the daemon's checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["RUNGS", "BrownoutConfig", "BrownoutLadder"]

#: Shed order, mildest first; ``modes()`` is the engaged prefix.
RUNGS = ("skip_minibatch", "defer_scrub", "cap_trace", "coalesce", "shed_reads")


@dataclass(frozen=True)
class BrownoutConfig:
    """Thresholds of the ladder, in decision-lag windows per rung."""

    #: Lag at which each rung engages.
    engage: tuple = (2.0, 3.0, 4.0, 6.0, 8.0)
    #: Lag at or below which a rung counts a calm window (below engage).
    release: tuple = (1.0, 1.5, 2.0, 3.0, 4.0)
    #: Consecutive calm windows before one rung releases.
    hold: int = 2
    #: Fraction of a window's reads shed while ``shed_reads`` is engaged.
    shed_fraction: float = 0.2
    #: Seed of the per-window shed draw.
    shed_seed: int = 0
    #: Most consecutive windows merged into one decision under ``coalesce``.
    coalesce_max: int = 4
    #: SLO burn at or above which the whole ladder engages (None = lag only).
    burn_engage: float | None = None

    def __post_init__(self):
        n = len(RUNGS)
        if len(self.engage) != n or len(self.release) != n:
            raise ValueError(f"brownout thresholds must cover all {n} rungs, got "
                             f"engage={len(self.engage)} release={len(self.release)}")
        if any(e2 < e1 for e1, e2 in zip(self.engage, self.engage[1:])):
            raise ValueError(f"engage thresholds must be non-decreasing (the ladder "
                             f"engages in rung order), got {self.engage}")
        if any(r >= e for r, e in zip(self.release, self.engage)):
            raise ValueError(f"each release threshold must sit strictly below its engage "
                             f"threshold (hysteresis), got release={self.release} "
                             f"engage={self.engage}")
        if self.hold < 1:
            raise ValueError(f"hold must be >= 1, got {self.hold}")
        if not 0.0 < self.shed_fraction < 1.0:
            raise ValueError(f"shed_fraction must be in (0, 1), got {self.shed_fraction}")
        if self.coalesce_max < 2:
            raise ValueError(f"coalesce_max must be >= 2 (1 is no coalescing), got "
                             f"{self.coalesce_max}")


@dataclass
class BrownoutLadder:
    """The state machine: one :meth:`step` per processed window."""

    cfg: BrownoutConfig = field(default_factory=BrownoutConfig)
    #: Engaged rung count (modes() = RUNGS[:level]).
    level: int = 0
    #: Consecutive calm windows toward the next release.
    calm: int = 0

    def modes(self) -> frozenset:
        return frozenset(RUNGS[:self.level])

    def step(self, window: int, lag_windows: float, slo_burn: float = 0.0) -> list[dict]:
        """Advance one window; returns its transitions (``{"rung", "level",
        "state": "engage"|"release", "window", "lag_windows"}``)."""
        cfg = self.cfg
        lag = float(lag_windows)
        out: list[dict] = []
        want = 0
        for i, thr in enumerate(cfg.engage):
            if lag >= thr:
                want = i + 1
        if cfg.burn_engage is not None and float(slo_burn) >= float(cfg.burn_engage):
            want = len(RUNGS)
        if want > self.level:
            # A spike engages every rung it crosses in one window.
            for lv in range(self.level + 1, want + 1):
                out.append({"rung": RUNGS[lv - 1], "level": lv, "state": "engage",
                            "window": int(window), "lag_windows": round(lag, 3)})
            self.level = want
            self.calm = 0
            return out
        if self.level and lag <= cfg.release[self.level - 1] \
                and (cfg.burn_engage is None or float(slo_burn) < float(cfg.burn_engage)):
            self.calm += 1
            if self.calm >= cfg.hold:
                self.level -= 1
                self.calm = 0
                out.append({"rung": RUNGS[self.level], "level": self.level,
                            "state": "release", "window": int(window),
                            "lag_windows": round(lag, 3)})
        else:
            self.calm = 0
        return out

    def state_dict(self) -> dict:
        return {"level": int(self.level), "calm": int(self.calm)}

    def load_state_dict(self, d: dict) -> None:
        self.level = min(max(int(d.get("level", 0)), 0), len(RUNGS))
        self.calm = max(int(d.get("calm", 0)), 0)
