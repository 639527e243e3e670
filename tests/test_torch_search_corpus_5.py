"""The committed search corpus on the port (part 5): the port's
``triage_corpus`` on a temporary copy of the corpus gives the committed
``triage.json``, and ``scenarios sweep --extra_cells`` runs
``distilled.json`` and ``triage.json``, every cell green.
"""

import json
import os
import shutil

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_search_corpus import CORPUS  # noqa: E402

import cdrs_tpu_torch.scenarios.presets as port_presets  # noqa: E402
from cdrs_tpu_torch.cli import main as port_main  # noqa: E402
from cdrs_tpu_torch.scenarios.search import triage_corpus  # noqa: E402


def test_triage_of_a_corpus_copy_is_triage_json(tmp_path):
    copy = tmp_path / "corpus"
    shutil.copytree(CORPUS, copy)
    got = triage_corpus(str(copy), device="cpu")
    with open(os.path.join(CORPUS, "triage.json"), encoding="utf-8") as f:
        want = json.load(f)
    assert got["names"] == want["names"] and got["ok"] == want["ok"] is True
    assert got["cells"] == want["cells"] and got["n_violations"] == want["n_violations"] == 9
    assert [r["failed"] for r in got["results"]] == [r["failed"] for r in want["results"]]
    assert [r["source"] for r in got["results"]] == [r["source"] for r in want["results"]]
    # Triage reads the corpus and writes nothing into it.
    assert sorted(os.listdir(copy)) == sorted(os.listdir(CORPUS))


def test_sweep_runs_the_corpus_cell_files(tmp_path, capsys, monkeypatch):
    """``sweep --extra_cells distilled.json --extra_cells triage.json`` over a
    suite with no cells of its own: the twelve corpus cells, all green."""
    monkeypatch.setitem(port_presets.SUITES, "corpus-only", ((), 0))
    out = tmp_path / "sweep.json"
    rc = port_main(["scenarios", "sweep", "--suite", "corpus-only",
                    "--extra_cells", os.path.join(CORPUS, "distilled.json"),
                    "--extra_cells", os.path.join(CORPUS, "triage.json"),
                    "--out", str(out), "--device", "cpu"])
    digest = json.loads(capsys.readouterr().out)
    assert rc == 0 and digest["ok"] and digest["n_cells"] == 12
    names = [c["cell"] for c in json.loads(out.read_text())["cells"]]
    want = []
    for fn in ("distilled.json", "triage.json"):
        with open(os.path.join(CORPUS, fn), encoding="utf-8") as f:
            want += json.load(f)["names"]
    assert names == want
