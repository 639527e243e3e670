"""The committed search corpus on the port (part 2): the last four of the
eight banked ``search-s0-*`` cells through the port's ``run_cell`` equal
the reference's from its cold init carried in, and hold their invariants
on the port's own init.  The helpers are part 1's
(``test_torch_search_corpus.py``).
"""

import json
import os

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_search_corpus import BANKED, CORPUS, assert_corpus_cell_matches  # noqa: E402


@pytest.mark.parametrize("name", BANKED[4:])
def test_banked_cell_matches_the_reference(name):
    with open(os.path.join(CORPUS, f"{name}.json"), encoding="utf-8") as f:
        entry = json.load(f)
    assert entry["spec"]["name"] == name
    assert_corpus_cell_matches(entry["spec"])
