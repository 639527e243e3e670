"""The committed search corpus on the port (part 4): the shrunk spec of
each of the last four of the nine banked violations, under its
``triage-*`` name, through the port's ``run_cell`` equals the reference's
from its cold init carried in, and is green on the port's own init.  The
helpers are part 1's (``test_torch_search_corpus.py``) and part 3's.
"""

import json
import os

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_search_corpus import CORPUS, assert_corpus_cell_matches  # noqa: E402
from test_torch_search_corpus_3 import VIOLATIONS  # noqa: E402


@pytest.mark.parametrize("name", VIOLATIONS[5:])
def test_shrunk_violation_matches_the_reference(name):
    with open(os.path.join(CORPUS, "violations", f"{name}.json"), encoding="utf-8") as f:
        entry = json.load(f)
    doc = dict(entry["shrunk"]["spec"])
    doc["name"] = "triage-" + name[len("search-"):]
    assert_corpus_cell_matches(doc)
