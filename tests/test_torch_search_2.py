"""The failure-space search loop of the port against the reference's (part
2 of ``test_torch_search.py``, whose helpers it uses): ``run_search`` at
six cells over three base presets, from the reference's cold init carried
in (``reference_init``), equals the reference's in kept names, coverage,
new bits and violations.  From the port's own init it takes another path
(ROADMAP Queue C6): ``test_torch_search_3.py``.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.scenarios.search as ref_search  # noqa: E402
from test_torch_scenario_parity import NumpyDraws  # noqa: E402
from test_torch_search import port_repro, reference_cell, reference_init  # noqa: E402

from cdrs_tpu_torch.scenarios import run_search  # noqa: E402

#: The three presets ``run_search`` starts from here: a fault cell, an EC
#: cell and a decay-0.7 drift cell.
SEARCH_BASE_SMALL = ("cascade", "storage-ec", "gradual-drift")


def test_run_search_matches_the_reference_from_its_init(monkeypatch):
    draws = NumpyDraws()
    monkeypatch.setattr(ref_search, "run_cell",
                        lambda spec, **kw: reference_cell(spec, draws, **kw))
    want = ref_search.run_search(seed=0, budget_cells=6, base=SEARCH_BASE_SMALL, bank=False,
                                 corpus_dir="")
    with reference_init(draws):
        got = run_search(seed=0, budget_cells=6, base=SEARCH_BASE_SMALL, bank=False,
                         corpus_dir="", device="cpu")
    for key in ("iterations", "cells_run", "baseline_bits", "coverage_bits", "coverage",
                "fingerprint", "new_coverage_cells"):
        assert got[key] == want[key], key
    for g, w in zip(got["kept"], want["kept"]):
        for key in ("name", "iteration", "parent", "ops", "spec", "coverage", "new_bits"):
            assert g[key] == w[key], key
        assert g["repro"] == port_repro(w["repro"])
    assert [v["name"] for v in got["violations"]] == [v["name"] for v in want["violations"]]
    assert [v.get("failed") for v in got["violations"]] == \
        [v.get("failed") for v in want["violations"]]
    assert got["iterations"] == 6 and got["cells_run"] >= 1
