"""The port's ``benchmarks/search_bench`` against the reference's
``run_effectiveness`` and ``run_shrinker`` on the CPU.

The guided search, the blind arm's random cells and the base presets'
coverage run from the reference's cold init (``reference_init`` of
``test_torch_search.py``: a decay-1 cell against the reference's jax
backend from its D² init, a decay < 1 cell against its numpy backend from
the draws it made); every field but the wall clock must be the
reference's.  The planted violation must shrink to the reference's 2-event
cause, and its repro line, which names the port's CLI, must rerun red
through ``cdrs_tpu_torch.cli.main``."""

import functools

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.search_bench as ref  # noqa: E402
import cdrs_tpu.scenarios.search as ref_search  # noqa: E402
from test_torch_scenario_parity import NumpyDraws  # noqa: E402
from test_torch_search import port_repro, reference_cell, reference_init  # noqa: E402
from test_torch_search_2 import SEARCH_BASE_SMALL  # noqa: E402
from torch_bench_parity import assert_matches, one_torch_thread, round_trips  # noqa: E402

from cdrs_tpu_torch.benchmarks import search_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_effectiveness_matches_the_reference_from_its_init(monkeypatch, tmp_path):
    """At four cells from three base presets (``SEARCH_BASE_SMALL``: a
    fault cell, an EC cell and a decay-0.7 drift cell; the nine presets of
    ``SEARCH_BASE`` are the bench's own run): cells run, base, guided and
    blind bits exact; only ``seconds`` is wall clock."""
    draws = NumpyDraws()

    def cell(spec, **kw):
        return reference_cell(spec, draws, **kw)

    monkeypatch.setattr(ref_search, "run_cell", cell)
    monkeypatch.setattr(ref, "run_cell", cell)
    for mod in (ref, search_bench):
        monkeypatch.setattr(mod, "run_search", functools.partial(mod.run_search,
                                                                 base=SEARCH_BASE_SMALL))
    want = ref.run_effectiveness(seed=0, budget_cells=4)
    with reference_init(draws):
        got = search_bench.run_effectiveness(seed=0, budget_cells=4, device="cpu")
    assert_matches(got, want, rel=0.0)
    assert got["cells_run"] >= 1 and got["baseline_bits"] > 0
    assert got["blind_bits"] >= got["baseline_bits"]
    round_trips(got, tmp_path)


def test_shrinker_matches_the_reference_and_reruns_red(tmp_path):
    want = ref.run_shrinker(0)
    got = search_bench.run_shrinker(0, device="cpu")
    assert got["repro"] == port_repro(want["repro"])
    assert got["repro"].startswith("python -m cdrs_tpu_torch scenarios run --spec ")
    assert_matches(got, want, rel=0.0, skip={"repro"})
    assert got["shrunk_events"] == 2 and got["repro_reruns_red"] and got["repro_exit_code"] == 1
    assert got["shrunk_failed"] == got["repro_failed"] == ["zero_silent_loss"]
    round_trips(got, tmp_path)
