"""The one general traffic generator: points from the seed, the closed loop
that sends the next unit when the last one returns, the work each unit
asks of the kernels, and the check of what the loop produced.

A mix file (``mixes/<mix>.json``) holds only parameters; a string value
names a key of the configuration file (so ``"iters": "lloyd_iters"`` takes
the configuration's budget).  Two loops exist:

* ``solve``: back-to-back Lloyd solves, each from ``k`` distinct rows drawn
  from the seed, ``iters`` iterations at tol 0; a unit ends when the
  solve's centroids and labels are on the card.
* ``decide``: back-to-back decisions, each the init (its own seed), the
  Lloyd loop, the scoring and the categories on the host; unit ``i`` uses
  population ``i % pool``.  On the card each decision is also timed by a
  pair of CUDA events, recorded at its send and after its categories reach
  the host: a decision is shorter than the host clock's resolution allows.

Points are Gaussian blobs drawn on the card in blocks: ``blobs`` centres
scaled by ``center_scale``, noise ``noise``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import keyed, reference

#: Rows drawn at once (2 GiB of float32 noise at d = 128).
_POINT_BLOCK = 1 << 22


def param(spec, key, default=None):
    """Mix parameter ``key``; a string names a configuration key."""
    v = spec.mix.get(key, default)
    if isinstance(v, str) and v in spec.config:
        return spec.config[v]
    return v


def points(spec, seed: int, index: int, device) -> torch.Tensor:
    """(n, d) points of population ``index``, drawn on ``device`` from the seed."""
    cfg = spec.config
    n, d = cfg["n"], cfg["d"]
    gen = keyed.generator(seed, keyed.POINTS, index, device)
    centers = torch.randn((cfg["blobs"], d), generator=gen, device=device) * cfg["center_scale"]
    lab = torch.randint(0, cfg["blobs"], (n,), generator=gen, device=device)
    x = torch.empty((n, d), dtype=getattr(torch, cfg["dtype"]), device=device)
    for i in range(0, n, _POINT_BLOCK):
        j = min(n, i + _POINT_BLOCK)
        noise = torch.randn((j - i, d), generator=gen, device=device)
        x[i:j] = centers[lab[i:j]] + noise * cfg["noise"]
    return x


def scoring_tables(cfg: dict) -> dict:
    """The configuration's scoring tables, every feature weighted alike."""
    s, d = cfg["scoring"], cfg["d"]
    return {"categories": s["categories"], "rf": s["rf"], "band": s["moderate_band"],
            "W": [[w] * d for w in s["weight"]], "D": [[v] * d for v in s["direction"]],
            "is_moderate": [c == "Moderate" for c in s["categories"]],
            "bins": s["median_bins"], "median_method": s["median_method"]}


def bisect_iters(bins: int) -> int:
    return max(8, int(np.ceil(np.log2(max(bins, 2)))) + 1)


@dataclass
class Window:
    """What the loop did: each unit's send and done times and iterations,
    the kept answers of the sampled units, the wrappers' launch counters
    before and after, and the calls the units ask of the kernels (``b1``,
    ``b2``: [(n, d, k, flag, calls)])."""

    units: list = field(default_factory=list)
    kept: dict = field(default_factory=dict)
    t0: float = 0.0
    t1: float = 0.0
    launches: dict = field(default_factory=dict)
    work: dict = field(default_factory=lambda: {"b1": [], "b2": []})
    setup_s: float = 0.0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Traffic:
    """One cell's loop over its populations ``data`` on ``device``."""

    def __init__(self, spec, seed: int, device, data):
        self.spec, self.seed, self.device, self.data = spec, int(seed), device, data
        self.loop = spec.mix["loop"]
        if self.loop not in ("solve", "decide"):
            raise ValueError(f"unknown loop {self.loop!r}")
        cfg = spec.config
        self.n, self.d, self.k = cfg["n"], cfg["d"], cfg["k"]
        self.iters = int(param(spec, "iters"))
        self.init = param(spec, "init", "rows")
        self.rounds = int(cfg.get("init_rounds", 5))
        self.oversample = float(cfg.get("init_oversample", 2.0))
        self.tables = scoring_tables(cfg)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _kw(self):
        return dict(tol=0.0, init_method=self.init if self.init != "rows" else "kmeans||",
                    init_oversample=self.oversample, init_rounds=self.rounds)

    def _rows(self, i: int) -> torch.Tensor:
        idx = np.sort(keyed.rng(self.seed, keyed.INIT_ROWS, i).choice(self.n, self.k,
                                                                      replace=False))
        return torch.from_numpy(idx).to(self.device)

    def _unit_seed(self, i: int) -> int:
        return keyed.derived_seed(self.seed, keyed.DECISION_SEEDS, i)

    # -- one unit ---------------------------------------------------------------

    def unit(self, system, i: int, span, traced: bool) -> tuple[dict, dict]:
        """Run unit ``i``: (its record, its answers)."""
        X = self.data[i % len(self.data)]
        if self.loop == "solve":
            c0 = X[self._rows(i)].float() if self.init == "rows" else None
            seed = None if c0 is not None else self._unit_seed(i)
            t_send = time.perf_counter()
            with span("portbench.solve"):
                c, labels, it = system.solve(X, self.k, max_iter=self.iters, seed=seed,
                                             init_centroids=c0, **self._kw())
                self.sync()
            t_done = time.perf_counter()
            rec = {"send": t_send, "done": t_done, "iters": int(it)}
            return rec, {"c0": c0, "seed": seed, "c": c, "labels": labels, "it": int(it)}
        seed = self._unit_seed(i)
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        t_send = time.perf_counter()
        with span("portbench.kmeans_full"):
            c, labels, it = system.solve(X, self.k, max_iter=self.iters, seed=seed, **self._kw())
            if traced:
                self.sync()
        t_mid = time.perf_counter()
        with span("portbench.classify"):
            winner, med = system.classify(X, labels, self.k, self.tables)
            cats = winner.cpu().numpy()
        t_done = time.perf_counter()
        rec = {"send": t_send, "done": t_done, "iters": int(it)}
        if events is not None:
            events[1].record()
            rec["events"] = events
        if traced:
            rec.update(kmeans_s=t_mid - t_send, classify_s=t_done - t_mid)
        return rec, {"seed": seed, "c": c, "labels": labels, "it": int(it), "med": med,
                     "cats": cats}

    def work(self, it: int) -> dict:
        """The kernels' calls of one unit of ``it`` Lloyd iterations: B1 an
        iteration and a label pass (and the k-means|| weights pass), B2 a
        bisection step of a decision.  A roofline is read only where the
        wrappers counted exactly these calls."""
        n, d, k = self.n, self.d, self.k
        b1 = [(n, d, k, False, it), (n, d, k, True, 1)]
        b2 = []
        if self.init != "rows":
            per_round = max(1, int(math.ceil(self.oversample * k / self.rounds)))
            b1.append((n, d, 1 + self.rounds * per_round, False, 1))
        if self.loop == "decide":
            b2.append((n, d, k, True, bisect_iters(self.tables["bins"])))
        return {"b1": b1, "b2": b2}

    # -- the window -------------------------------------------------------------

    def sample(self, expected: int) -> set[int]:
        """Units whose answers are kept for the check: ``samples`` drawn from
        the seed among the first four fifths of the units expected."""
        count = int(self.spec.cell.get("samples", 2))
        top = max(1, int(0.8 * expected))
        picks = keyed.rng(self.seed, keyed.SAMPLE, 0).choice(top, min(count, top), replace=False)
        return {int(p) for p in picks}

    def run(self, system, seconds: float, expected: int, capture) -> Window:
        """Units back to back until ``seconds`` have passed; the unit under
        way then finishes and counts."""
        win = Window()
        keep = self.sample(expected)
        traced = capture.active
        win.launches["before"] = system.launches()
        last = None
        self.sync()
        with capture.window():
            win.t0 = time.perf_counter()
            i = 0
            while i == 0 or time.perf_counter() - win.t0 < seconds:
                rec, ans = self.unit(system, i, capture.span, traced)
                win.units.append(rec)
                if i in keep:
                    win.kept[i] = ans
                last = (i, ans)
                i += 1
            win.t1 = time.perf_counter()
        win.launches["after"] = system.launches()
        self.sync()
        for rec in win.units:
            if "events" in rec:
                start, end = rec.pop("events")
                rec["latency"] = start.elapsed_time(end) / 1e3
        if len(win.kept) < len(keep) and last[0] not in win.kept:
            win.kept[last[0]] = last[1]
        for rec in win.units:
            w = self.work(rec["iters"])
            win.work["b1"] += w["b1"]
            win.work["b2"] += w["b2"]
        return win

    # -- the check --------------------------------------------------------------

    def middle_step(self, i: int, it: int) -> int | None:
        """The step of unit ``i`` checked besides its first and last, drawn
        from the seed among 2 .. it - 1."""
        if it < 3:
            return None
        return int(keyed.rng(self.seed, keyed.SAMPLE, i + 1).integers(2, it))

    def check(self, system, win: Window) -> dict:
        """The numbers compared, each the worst over the kept units.

        A Lloyd step is checked from the program's own state: the labels
        it returned against the centroids it started from, and its
        centroids against the mean of their rows.  Lloyd's trajectory is
        chaotic under rounding, so the state before step ``s`` comes from
        the same entry run again for ``s - 1`` iterations (the program is
        deterministic).  Each kept unit's first, last and one middle step
        drawn from the seed are checked; a decision's k-means|| init by its
        label pass and by its inertia against the reference's init drawn
        from the same keyed noise (``init_excess``), and its medians and
        categories against the reference's.  Where the program launches
        kernels, each B1 call the window's units ask for (an iteration, a
        label pass, a k-means|| weights pass) needs a launch of B1
        (``b1_calls_missing``): the iterations a solve reports are run."""
        reference.no_tf32()
        out = {"label_gap": 0.0, "centroid_gap": 0.0}
        if self.loop == "decide":
            out.update(init_excess=-math.inf, median_gap=0.0, category_gap=0.0)
        if counts_launches(self.device):
            calls = sum(c[-1] for u in win.units for c in self.work(u["iters"])["b1"])
            launched = win.launches["after"]["b1"] - win.launches["before"]["b1"]
            out["b1_calls_missing"] = float(max(0, calls - launched))

        def worst(key, v):
            out[key] = max(out[key], v) if not math.isnan(v) else math.inf

        for i, ans in sorted(win.kept.items()):
            X = self.data[i % len(self.data)]
            it, c0, seed = ans["it"], ans.get("c0"), ans["seed"]
            kw = dict(seed=seed, init_centroids=c0, **self._kw())
            states = {it: (ans["c"], ans["labels"])}
            if c0 is not None:
                states[0] = (c0, None)

            def state(s):
                """(centroids after ``s`` steps, labels against those after s - 1)."""
                if s not in states:
                    states[s] = system.solve(X, self.k, max_iter=s, **kw)[:2]
                return states[s]

            if c0 is None:
                c_init, l_init = state(0)
                worst("label_gap", reference.label_gap(X, c_init, l_init))
                worst("init_excess", reference.init_excess(X, c_init, self.k, seed, self.rounds,
                                                           self.oversample))
            steps = {s for s in (1, self.middle_step(i, it), it) if s is not None and s >= 1}
            for s in sorted(steps):
                c_s, l_s = state(s)
                worst("label_gap", reference.label_gap(X, state(s - 1)[0], l_s))
                worst("centroid_gap", reference.centroid_gap(X, l_s, c_s, self.k, seed, s - 1))
            if self.loop == "decide":
                med, gm = reference.bisect_medians(X, ans["labels"], self.k, self.tables["bins"])
                worst("median_gap", reference.median_gap(ans["med"], med))
                worst("category_gap", reference.category_gap(ans["cats"], med, gm, self.tables))
        return out


def counts_launches(device) -> bool:
    """Whether the program launches its kernels on ``device``: its CPU path
    runs plain versions and counts nothing."""
    return device.type == "cuda"
