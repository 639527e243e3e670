"""The committed search corpus on the port (part 1): each of the first four
of the eight banked ``search-s0-*`` cells of ``data/search_corpus`` through the port's
``run_cell`` equals the reference's ``run_cell`` in invariants, metrics,
coverage bits and fingerprint, from the reference's cold init carried in
(``test_torch_search.reference_init``), and holds its invariants on the
port's own init.

On the port's own init every corpus cell stays green, but the cells'
metrics and, for some, their coverage bits differ from the reference's
(ROADMAP Queue C6).  Part 2 (``test_torch_search_corpus_2.py``) holds the
other four banked cells, parts 3 and 4 the banked violations, part 5
triage and ``sweep --extra_cells``.
"""

import json
import os

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.scenarios import ScenarioSpec as RefSpec  # noqa: E402
from test_torch_scenario_parity import COMPARED, NumpyDraws  # noqa: E402
from test_torch_search import reference_cell, reference_init  # noqa: E402

from cdrs_tpu_torch.scenarios import ScenarioSpec, run_cell  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "search_corpus")
BANKED = sorted(fn[:-5] for fn in os.listdir(CORPUS) if fn.startswith("search-s0-"))


def corpus_pair(doc: dict):
    """(port cell, reference cell) of a corpus spec dict, the port from the
    reference's cold init."""
    draws = NumpyDraws()
    want = reference_cell(RefSpec.from_dict(doc), draws)
    with reference_init(draws):
        got = run_cell(ScenarioSpec.from_dict(doc), device="cpu")
    return got, want


def assert_corpus_cell_matches(doc: dict):
    got, want = corpus_pair(doc)
    assert got["cell"] == want["cell"] == doc["name"]
    for key in COMPARED:
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["ok"] and want["ok"], got["invariants"]
    own = run_cell(ScenarioSpec.from_dict(doc), device="cpu")
    assert own["ok"], {k: v for k, v in own["invariants"].items() if not v}
    assert set(own["invariants"]) == set(want["invariants"])


def test_the_corpus_has_its_eight_banked_cells():
    assert len(BANKED) == 8


@pytest.mark.parametrize("name", BANKED[:4])
def test_banked_cell_matches_the_reference(name):
    with open(os.path.join(CORPUS, f"{name}.json"), encoding="utf-8") as f:
        entry = json.load(f)
    assert entry["spec"]["name"] == name
    assert_corpus_cell_matches(entry["spec"])
