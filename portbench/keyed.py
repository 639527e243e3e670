"""Keyed random streams: a ``torch.Generator`` or a numpy generator for a
(seed, stream, index) key, the key hashed through numpy's ``SeedSequence``.

The streams are the benchmark's own; the traffic and the reference draw
from them.  The k-means|| Gumbel noise and the reseed rows are keyed the
same way as the program keys them (seed, stream 0 / 2, index), so that the
reference, put in the program's place, draws what the program draws.
"""

from __future__ import annotations

import numpy as np
import torch

#: Streams of the benchmark's traffic (the points, the random-row inits,
#: the decisions' seeds, the checked sample) and of the algorithm's noise.
POINTS, INIT_ROWS, DECISION_SEEDS, SAMPLE = 16, 17, 18, 19
KMEANS_INIT, KMEANS_REDUCE, RESEED = 0, 1, 2


def _state(seed: int | None, stream: int, index: int) -> int:
    words = [0 if seed is None else int(seed), int(stream), int(index)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def generator(seed: int | None, stream: int, index: int, device) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` keyed by (seed, stream, index)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_state(seed, stream, index))
    return gen


def rng(seed: int, stream: int, index: int) -> np.random.Generator:
    """A numpy generator keyed by (seed, stream, index)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(stream), int(index)]))


def derived_seed(seed: int, stream: int, index: int) -> int:
    """A 62-bit seed keyed by (seed, stream, index)."""
    return _state(seed, stream, index) >> 2
