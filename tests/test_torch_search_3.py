"""ROADMAP Queue C6 (part 3 of ``test_torch_search.py``, whose helpers it
uses): from the port's own cold init the sanitized ``cascade`` base cell
lights ``alert:budget_saturated`` and the reference's does not, while the
reference carrying the port's init gives the port's record; so the search
from the port's own init takes another path than the reference's.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.scenarios.search as ref_search  # noqa: E402
from cdrs_tpu.scenarios import preset as ref_preset  # noqa: E402
from cdrs_tpu.scenarios import run_cell as ref_run_cell  # noqa: E402
from test_torch_scenario_parity import NumpyDraws  # noqa: E402
from test_torch_search import reference_cell  # noqa: E402
from test_torch_search_2 import SEARCH_BASE_SMALL  # noqa: E402

from cdrs_tpu_torch.scenarios import ScenarioSpec, run_cell, run_search  # noqa: E402


def test_cascade_base_cell_is_init_sensitive_on_both_sides():
    """ROADMAP Queue C6: the sanitized ``cascade`` base cell fires
    ``budget_saturated`` on the port's own cold init and not on the
    reference's; the reference carrying the port's init gives the port's
    record exactly."""
    from test_torch_scenario_parity_3 import port_init_in_reference

    spec = ref_search._sanitize(ref_preset("cascade"), name="cascade")
    own = run_cell(ScenarioSpec.from_dict(spec.to_dict()), device="cpu")
    want = ref_run_cell(spec.replace(backend="jax"))
    with port_init_in_reference():
        carried = ref_run_cell(spec.replace(backend="jax"))
    for key in ("invariants", "metrics", "coverage", "fingerprint"):
        assert own[key] == carried[key], key
    assert own["ok"] and want["ok"]
    assert sorted(set(own["coverage"]) ^ set(want["coverage"])) == ["alert:budget_saturated"]


@pytest.mark.xfail(strict=True, reason="ROADMAP Queue C6: from the port's own cold init the "
                   "cascade base cell lights alert:budget_saturated, so the search's frontier "
                   "and with it its trajectory differ from the reference's")
def test_run_search_on_the_port_init_matches_the_reference(monkeypatch):
    draws = NumpyDraws()
    monkeypatch.setattr(ref_search, "run_cell",
                        lambda spec, **kw: reference_cell(spec, draws, **kw))
    want = ref_search.run_search(seed=0, budget_cells=6, base=SEARCH_BASE_SMALL, bank=False,
                                 corpus_dir="", shrink=False)
    got = run_search(seed=0, budget_cells=6, base=SEARCH_BASE_SMALL, bank=False,
                     corpus_dir="", shrink=False, device="cpu")
    assert [e["name"] for e in got["kept"]] == [e["name"] for e in want["kept"]]
    assert got["fingerprint"] == want["fingerprint"]
