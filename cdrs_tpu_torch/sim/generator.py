"""Synthetic file-population generator (host, numpy).

Makes the same numpy draws in the same order as
``cdrs_tpu/sim/generator.py``, so one seed gives a bit-identical manifest
in both packages: size ~ U{min, max}, creation = now - U(0, age_days_max)
days, primary node uniform, category from ``category_mix``.
``write_payloads`` also writes each file's ``os.urandom`` bytes under
``base_dir`` taken relative to the working directory (after the draws, so
the manifest is the same either way).
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..config import SEEDED_EPOCH, GeneratorConfig
from ..io.events import Manifest

__all__ = ["generate_population"]


def generate_population(cfg: GeneratorConfig, now: float | None = None) -> Manifest:
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_files
    if now is None:
        now = SEEDED_EPOCH if cfg.seed is not None else time.time()

    sizes = rng.integers(cfg.min_size, cfg.max_size + 1, size=n, dtype=np.int64)
    age_days = rng.random(n) * cfg.age_days_max
    creation = now - age_days * 86400.0
    primary = rng.integers(0, len(cfg.nodes), size=n).astype(np.int32)

    cats = list(cfg.category_mix.keys())
    probs = np.asarray(list(cfg.category_mix.values()), dtype=np.float64)
    probs = probs / probs.sum()
    cat_idx = rng.choice(len(cats), size=n, p=probs)
    category = [cats[i] for i in cat_idx]

    paths = [f"{cfg.base_dir}/synth_{i}.bin" for i in range(n)]
    if cfg.write_payloads:
        root = cfg.base_dir.lstrip("/")
        os.makedirs(root, exist_ok=True)
        for i in range(n):
            with open(os.path.join(root, f"synth_{i}.bin"), "wb") as f:
                f.write(os.urandom(int(sizes[i])))
    return Manifest(
        paths=paths,
        creation_ts=np.floor(creation),
        primary_node_id=primary,
        size_bytes=sizes,
        category=category,
        nodes=list(cfg.nodes),
    )
