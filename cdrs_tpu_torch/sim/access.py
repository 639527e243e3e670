"""Poisson access-pattern simulator and its workload curves (host, numpy).

Makes the same numpy draws in the same order as ``cdrs_tpu/sim/access.py``,
so one seed gives a bit-identical event log in both packages.  Every curve
runs on one draw core, :func:`_poisson_stream`: jittered per-file rates,
Poisson counts over the span, per-event uniforms placed on the time axis by
the curve, op mix, a locality-biased client, then a stable global time sort.

* :func:`simulate_access` — the flat stream (uniform event times);
* :func:`simulate_diurnal` — the same counts re-timed through a sinusoidal
  intensity curve's inverse CDF (``amplitude=0`` is the flat stream);
* :func:`simulate_access_phased` — cumulative category flips at successive
  times, one flat stream a phase (phase ``i`` seeded ``seed + i * 0x5F17``);
  :func:`simulate_access_with_shift` is its one-shift case;
* :func:`simulate_flash_crowd` — the flat stream plus a read burst on a
  cohort (seeded ``seed + 0x9E37``).

``engine="native"`` draws the flat stream (and with it every phase of the
phased curves and a flash crowd's base) with the host library's threaded
engine (``runtime/native.py``): the same jittered rates and client
vocabulary, then its own deterministic C++ stream, bit-identical to the
JAX package's native engine on the same seed and invariant to the thread
count.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import SimulatorConfig
from ..io.events import EventLog, Manifest, client_vocabulary

__all__ = ["simulate_access", "simulate_access_with_shift", "simulate_access_phased",
           "simulate_diurnal", "simulate_flash_crowd", "jittered_rates"]


def jittered_rates(manifest: Manifest, cfg: SimulatorConfig,
                   rng: np.random.Generator):
    """Per-file (read_rate, write_rate, locality_bias) with Gaussian jitter;
    categories without a profile take the "moderate" one."""
    default = cfg.rate_profiles.get("moderate", {"read_rate": 0.1, "write_rate": 0.01,
                                                 "locality_bias": 0.5})
    names = list(cfg.rate_profiles)
    index = {c: i for i, c in enumerate(names)}
    table = np.asarray(
        [[p["read_rate"], p["write_rate"], p["locality_bias"]]
         for p in (cfg.rate_profiles[c] for c in names)]
        + [[default["read_rate"], default["write_rate"], default["locality_bias"]]],
        dtype=np.float64).reshape(-1, 3)
    codes = np.fromiter((index.get(c, len(names)) for c in manifest.category),
                        dtype=np.int64, count=len(manifest))
    read_mu, write_mu, loc_mu = table[codes].T

    read = np.maximum(
        0.0, rng.normal(read_mu, np.maximum(1e-4, read_mu * cfg.read_rate_jitter)))
    write = np.maximum(
        0.0, rng.normal(write_mu, np.maximum(1e-4, write_mu * cfg.write_rate_jitter)))
    loc = np.clip(rng.normal(loc_mu, cfg.locality_jitter_std), 0.0, 1.0)
    return read, write, loc


def _default_start(manifest: Manifest) -> float:
    """Just after the manifest's latest creation time."""
    return float(np.ceil(manifest.creation_ts.max())) + 1.0


def _poisson_stream(manifest: Manifest, cfg: SimulatorConfig, rng,
                    sim_start: float, time_of_u) -> EventLog:
    """The draw core of every curve; ``time_of_u`` places the per-event
    uniforms on the time axis (seconds after ``sim_start``)."""
    n = len(manifest)
    read, write, loc = jittered_rates(manifest, cfg, rng)
    lam = read + write
    counts = rng.poisson(lam * cfg.duration_seconds)
    total = int(counts.sum())

    path_id = np.repeat(np.arange(n, dtype=np.int32), counts)
    ts = sim_start + time_of_u(rng.random(total))

    p_read = read / (lam + 1e-12)
    op = (rng.random(total) >= p_read[path_id]).astype(np.int8)  # 1 = WRITE

    clients, client_pool = client_vocabulary(manifest, cfg.clients)
    use_primary = rng.random(total) < loc[path_id]
    random_client = client_pool[rng.integers(0, len(cfg.clients), size=total)]
    client_id = np.where(use_primary, manifest.primary_node_id[path_id],
                         random_client)

    order = np.argsort(ts, kind="stable")
    return EventLog(
        ts=ts[order],
        path_id=path_id[order],
        op=op[order],
        client_id=client_id[order].astype(np.int32),
        clients=clients,
    )


def simulate_access(manifest: Manifest, cfg: SimulatorConfig,
                    sim_start: float | None = None, engine: str = "numpy") -> EventLog:
    """Globally time-sorted event log over ``cfg.duration_seconds``,
    starting just after the manifest's latest creation time.
    ``engine="native"`` runs the host library's threaded generator."""
    rng = np.random.default_rng(cfg.seed)
    if sim_start is None:
        sim_start = _default_start(manifest)
    if engine == "native":
        from ..runtime.native import simulate_events_native

        read, write, loc = jittered_rates(manifest, cfg, rng)
        clients, pool = client_vocabulary(manifest, cfg.clients)
        # An unseeded run draws a fresh 64-bit seed from the (entropy-seeded)
        # generator, so unseeded runs stay independent.
        seed = int(cfg.seed) if cfg.seed is not None else int(rng.integers(0, 2**63 - 1))
        ts, pid, op, client = simulate_events_native(
            read, write, loc, manifest.primary_node_id, pool, cfg.duration_seconds,
            sim_start, seed=seed)
        return EventLog(ts=ts, path_id=pid, op=op, client_id=client, clients=clients)
    if engine != "numpy":
        raise ValueError(f"unknown simulator engine {engine!r}")
    return _poisson_stream(manifest, cfg, rng, sim_start,
                           lambda u: u * cfg.duration_seconds)


def simulate_diurnal(manifest: Manifest, cfg: SimulatorConfig, *,
                     period: float | None = None, amplitude: float = 0.8,
                     phase: float = 0.0, sim_start: float | None = None) -> EventLog:
    """The flat stream's counts re-timed through the intensity curve
    ``1 + amplitude * sin(2 pi t / period + phase)`` (inverse CDF on a
    4097-knot grid, over the same uniforms): total mass conserved, per-window
    volume swinging ``1 +- amplitude``.  ``period`` defaults to the span."""
    if not 0.0 <= float(amplitude) < 1.0:
        raise ValueError(
            f"amplitude must be in [0, 1) (the intensity must stay positive), got {amplitude}")
    duration = float(cfg.duration_seconds)
    period = duration if period is None else float(period)
    if period <= 0:
        raise ValueError(f"period must be > 0, got {period}")
    rng = np.random.default_rng(cfg.seed)
    if sim_start is None:
        sim_start = _default_start(manifest)
    grid = np.linspace(0.0, duration, 4097)
    dens = 1.0 + float(amplitude) * np.sin(2.0 * np.pi * grid / period + float(phase))
    cdf = np.concatenate([[0.0], np.cumsum((dens[1:] + dens[:-1]) * 0.5 * np.diff(grid))])
    cdf /= cdf[-1]
    return _poisson_stream(manifest, cfg, rng, sim_start, lambda u: np.interp(u, cdf, grid))


def simulate_access_phased(manifest: Manifest, cfg: SimulatorConfig, shifts, *,
                           sim_start: float | None = None,
                           engine: str = "numpy") -> tuple[EventLog, np.ndarray]:
    """N-phase workload: cumulative category flips at successive times.

    ``shifts`` are ``(shift_at, category_flip, cohort)`` tuples (cohort None
    = every file whose current category is a key), strictly increasing in
    time inside ``(0, duration)``.  Each phase is one flat stream seeded
    ``cfg.seed + i * 0x5F17`` over the manifest with the flips so far.
    Returns the concatenated log and the mask of files whose final category
    differs from the planted one."""
    duration = float(cfg.duration_seconds)
    shifts = list(shifts)
    times = [float(s[0]) for s in shifts]
    for t in times:
        if not 0.0 < t < duration:
            raise ValueError(f"shift_at must fall inside (0, {duration}), got {t}")
    if any(b <= a for a, b in zip(times, times[1:])):
        raise ValueError(f"shift times must be strictly increasing, got {times}")
    for _, flip, _ in shifts:
        unknown = (set(flip) | set(flip.values())) - set(cfg.rate_profiles)
        if unknown:
            raise ValueError(f"category_flip names categories without a rate profile: "
                             f"{sorted(unknown)}")
    if sim_start is None:
        sim_start = _default_start(manifest)

    cats = list(manifest.category)
    bounds = [0.0] + times + [duration]
    logs: list[EventLog] = []
    cur_manifest = manifest
    for i in range(len(bounds) - 1):
        if i > 0:
            _, flip, cohort = shifts[i - 1]
            in_cohort = np.ones(len(manifest), dtype=bool) if cohort is None \
                else np.asarray(cohort, dtype=bool)
            if in_cohort.shape != (len(manifest),):
                raise ValueError(f"cohort mask shape {in_cohort.shape} != ({len(manifest)},)")
            cats = [flip[c] if in_cohort[j] and c in flip and flip[c] != c else c
                    for j, c in enumerate(cats)]
            cur_manifest = dataclasses.replace(manifest, category=cats)
        seed_i = None if cfg.seed is None else int(cfg.seed) + i * 0x5F17
        cfg_i = dataclasses.replace(cfg, duration_seconds=bounds[i + 1] - bounds[i],
                                    seed=seed_i)
        logs.append(simulate_access(cur_manifest, cfg_i, sim_start=sim_start + bounds[i],
                                    engine=engine))
    # Phase i + 1 starts where phase i ends, and every phase interns clients
    # against the same vocabulary: the concatenation is time-sorted.
    changed = np.asarray([a != b for a, b in zip(manifest.category, cats)])
    return EventLog.concat(logs), changed


def simulate_flash_crowd(manifest: Manifest, cfg: SimulatorConfig, *, cohort: np.ndarray,
                         start: float, duration: float, boost: float,
                         sim_start: float | None = None,
                         engine: str = "numpy") -> tuple[EventLog, np.ndarray]:
    """The flat stream plus extra reads on a cohort over ``[start, start +
    duration)`` seconds of the span, at ``boost`` x its category's mean read
    rate, with the same locality bias.  Returns the merged time-sorted log
    and the cohort mask."""
    dur_total = float(cfg.duration_seconds)
    if not 0.0 <= float(start) < dur_total:
        raise ValueError(f"start must fall inside [0, {dur_total}), got {start}")
    if duration <= 0 or float(start) + float(duration) > dur_total:
        raise ValueError(f"burst [{start}, {start + duration}) must fit inside the "
                         f"{dur_total}s simulation span")
    if boost <= 0:
        raise ValueError(f"boost must be > 0, got {boost}")
    in_cohort = np.asarray(cohort, dtype=bool)
    if in_cohort.shape != (len(manifest),):
        raise ValueError(f"cohort mask shape {in_cohort.shape} != ({len(manifest)},)")
    if sim_start is None:
        sim_start = _default_start(manifest)

    base = simulate_access(manifest, cfg, sim_start=sim_start, engine=engine)

    rng = np.random.default_rng(None if cfg.seed is None else int(cfg.seed) + 0x9E37)
    ids = np.flatnonzero(in_cohort)
    default = cfg.rate_profiles.get("moderate", {"read_rate": 0.1, "locality_bias": 0.5})
    profiles = [cfg.rate_profiles.get(manifest.category[i], default) for i in ids]
    read_mu = np.asarray([p["read_rate"] for p in profiles])
    loc_mu = np.asarray([p["locality_bias"] for p in profiles])
    counts = rng.poisson(boost * read_mu * float(duration))
    total = int(counts.sum())
    pid = np.repeat(ids.astype(np.int32), counts)
    ts = sim_start + float(start) + rng.random(total) * float(duration)

    clients, client_pool = client_vocabulary(manifest, cfg.clients)
    use_primary = rng.random(total) < np.repeat(loc_mu, counts)
    random_client = client_pool[rng.integers(0, len(cfg.clients), size=total)]
    client_id = np.where(use_primary, manifest.primary_node_id[pid],
                         random_client).astype(np.int32)
    burst = EventLog(ts=ts, path_id=pid, op=np.zeros(total, dtype=np.int8),  # all reads
                     client_id=client_id, clients=clients)

    merged = EventLog.concat([base, burst])
    order = np.argsort(merged.ts, kind="stable")
    return EventLog(ts=merged.ts[order], path_id=merged.path_id[order],
                    op=merged.op[order], client_id=merged.client_id[order],
                    clients=merged.clients), in_cohort


def simulate_access_with_shift(manifest: Manifest, cfg: SimulatorConfig, shift_at: float,
                               category_flip: dict[str, str], cohort: np.ndarray | None = None,
                               sim_start: float | None = None,
                               engine: str = "numpy") -> tuple[EventLog, np.ndarray]:
    """Two-phase workload: planted categories flip at ``shift_at`` for a
    cohort (None = every file whose category is a key of the flip); the
    one-shift case of :func:`simulate_access_phased`."""
    return simulate_access_phased(manifest, cfg, [(float(shift_at), category_flip, cohort)],
                                  sim_start=sim_start, engine=engine)
