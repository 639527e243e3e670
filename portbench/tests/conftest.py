"""Fixtures of the benchmark's CPU tests: a cell shrunk to a toy size, and
the card for the tests marked ``chip``."""

from __future__ import annotations

import pytest

#: The toy size every CPU run of a cell takes.
TOY = dict(n=20_000, d=16, k=24, blobs=8, lloyd_iters=6, decide_iters=4, decide_pool=2)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with "
                    "`python3 -m pytest portbench/tests -m chip`")
    return torch.device("cuda", 0)


@pytest.fixture
def toy():
    """``toy(workload)``: the cell's spec at the toy size."""
    from portbench import spec

    def make(workload, root=spec.ROOT):
        sp = spec.load(workload, root)
        sp.config.update(TOY)
        return sp

    return make
