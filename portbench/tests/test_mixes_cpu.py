"""Each cell's loop at a toy size on the CPU, through the program's plain
versions: sound runs come out correct; the control (the reference in
TF32) and each fault planted under the timed path come out not correct:
a step that returns its state unchanged, half of the rows left out of the
sums, the middle steps alone left unchanged, fewer steps run than
reported, a label or a category altered, the k-means|| init replaced by
rows."""

from __future__ import annotations

import json
import time

import pytest

torch = pytest.importorskip("torch")

from portbench import reference, run, spec, traffic  # noqa: E402
from portbench.control import RowsInit  # noqa: E402
from portbench.system import Program  # noqa: E402

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
CPU = torch.device("cpu")
SEED = 2 ** 33 + 7


def _run(sp, system, seconds=0.3):
    return run.run_cell(sp, SEED, seconds, False, CPU, system, time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, toy):
    res = _run(toy(cell), Program())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in toy(cell).end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_in_float32_is_correct_and_in_tf32_is_not(cell, toy):
    assert _run(toy(cell), reference.Reference("float32"))["correct"]
    res = _run(toy(cell), reference.Reference("tf32"))
    assert not res["correct"]
    assert res["checks"]["label_gap"]["value"] > res["checks"]["label_gap"]["limit"]


def _state_unchanged(real):
    def step(x, c, n_valid=None, with_labels=False):
        labels, sums, counts = real(x, c, n_valid, with_labels)
        return labels, c * counts[:, None], counts
    return step


def _half_batch(real):
    def step(x, c, n_valid=None, with_labels=False):
        n_valid = x.shape[0] if n_valid is None else n_valid
        if with_labels:
            return real(x, c, n_valid, with_labels)
        return real(x, c, n_valid // 2, with_labels)
    return step


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_broken_step_is_not_correct(cell, fault, toy, monkeypatch):
    from cdrs_tpu_torch.ops import kmeans

    monkeypatch.setattr(kmeans, "lloyd_assign_reduce", fault(kmeans.lloyd_assign_reduce))
    res = _run(toy(cell), Program())
    assert not res["correct"], res["checks"]


class _AlteredLabel(Program):
    def solve(self, *args, **kw):
        c, labels, it = super().solve(*args, **kw)
        labels = labels.clone()
        labels[len(labels) // 3] = (labels[len(labels) // 3] + 1) % c.shape[0]
        return c, labels, it


class _AlteredCategory(Program):
    def classify(self, *args):
        winner, med = super().classify(*args)
        winner = winner.clone()
        winner[1] = (winner[1] + 2) % 4
        return winner, med


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_label_is_not_correct(cell, toy):
    res = _run(toy(cell), _AlteredLabel())
    assert not res["correct"]
    assert res["checks"]["label_gap"]["value"] > res["checks"]["label_gap"]["limit"]


@pytest.mark.parametrize("cell", [c for c in CELLS if "decide" in c])
def test_an_altered_category_is_not_correct(cell, toy):
    res = _run(toy(cell), _AlteredCategory())
    assert not res["correct"]
    assert res["checks"]["category_gap"]["value"] > res["checks"]["category_gap"]["limit"]


def _middle_steps_unchanged(real, last):
    """``kmeans._lloyd`` whose steps 2 .. last - 1 of every solve return the
    state unchanged, whatever the solve's ``max_iter``."""
    def lloyd(step, *args, **kw):
        calls = [0]

        def stale(c):
            calls[0] += 1
            sums, counts = step(c)
            if 2 <= calls[0] < last:
                return c * counts[:, None], counts
            return sums, counts
        return real(stale, *args, **kw)
    return lloyd


@pytest.mark.parametrize("cell", CELLS)
def test_middle_steps_left_unchanged_are_not_correct(cell, toy, monkeypatch):
    from cdrs_tpu_torch.ops import kmeans

    sp = toy(cell)
    monkeypatch.setattr(kmeans, "_lloyd",
                        _middle_steps_unchanged(kmeans._lloyd, int(traffic.param(sp, "iters"))))
    res = _run(sp, Program())
    assert not res["correct"]
    assert res["checks"]["centroid_gap"]["value"] > res["checks"]["centroid_gap"]["limit"]


class _Counted(Program):
    """The program with B1's calls counted on the CPU, as the card's
    wrapper counts its launches."""

    calls = 0

    def launches(self):
        return {"b1": _Counted.calls, "b2": 0}


class _HalfSteps(_Counted):
    """Runs half the iterations asked for and reports them all."""

    def solve(self, X, k, *, max_iter, **kw):
        c, labels, _ = super().solve(X, k, max_iter=(max_iter + 1) // 2, **kw)
        return c, labels, max_iter


@pytest.fixture
def counted(monkeypatch):
    from cdrs_tpu_torch.ops import kmeans

    real = kmeans.lloyd_assign_reduce

    def step(*args, **kw):
        _Counted.calls += 1
        return real(*args, **kw)

    monkeypatch.setattr(kmeans, "lloyd_assign_reduce", step)
    monkeypatch.setattr(traffic, "counts_launches", lambda device: True)


@pytest.mark.parametrize("cell", CELLS)
def test_every_reported_step_needs_a_launch(cell, toy, counted):
    res = _run(toy(cell), _Counted())
    assert res["correct"], res["checks"]
    assert res["checks"]["b1_calls_missing"]["value"] == 0.0
    res = _run(toy(cell), _HalfSteps())
    assert not res["correct"]
    assert res["checks"]["b1_calls_missing"]["value"] > 0


@pytest.mark.parametrize("cell", [c for c in CELLS if "decide" in c])
def test_an_init_of_drawn_rows_is_not_correct(cell, toy):
    res = _run(toy(cell), RowsInit())
    assert not res["correct"]
    assert res["checks"]["init_excess"]["value"] > res["checks"]["init_excess"]["limit"]
