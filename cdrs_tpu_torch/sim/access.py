"""Poisson access-pattern simulator (host, numpy engine).

Makes the same numpy draws in the same order as
``cdrs_tpu/sim/access.py:simulate_access``, so one seed gives a
bit-identical event log in both packages: jittered per-file rates,
Poisson counts over the window, uniform event times, op mix, a
locality-biased client, then a stable global time sort.
"""

from __future__ import annotations

import numpy as np

from ..config import SimulatorConfig
from ..io.events import EventLog, Manifest, client_vocabulary

__all__ = ["simulate_access", "jittered_rates"]


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


def simulate_access(manifest: Manifest, cfg: SimulatorConfig,
                    sim_start: float | None = None) -> EventLog:
    """Globally time-sorted event log over ``cfg.duration_seconds``,
    starting just after the manifest's latest creation time."""
    rng = np.random.default_rng(cfg.seed)
    if sim_start is None:
        sim_start = float(np.ceil(manifest.creation_ts.max())) + 1.0

    n = len(manifest)
    read, write, loc = jittered_rates(manifest, cfg, rng)
    lam = read + write
    counts = rng.poisson(lam * cfg.duration_seconds)
    total = int(counts.sum())

    path_id = np.repeat(np.arange(n, dtype=np.int32), counts)
    ts = sim_start + rng.random(total) * cfg.duration_seconds

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
