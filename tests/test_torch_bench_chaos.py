"""The port's ``benchmarks/chaos_bench`` against the reference's
``run_chaos_bench`` and ``run_rack_bench`` on the CPU (the rack criteria
from the port's own init, ``chaos_overhead`` and ``main``:
``test_torch_bench_chaos_2.py``).

Decay-1 controllers: the reference re-runs on ``backend="jax"`` and the
port's full re-clusters start from its D² init of the same snapshot
(``carried_init``); every field but wall clock must then be the
reference's.  The rack kill is ROADMAP C2's schedule, but C2 is the
scenario cell's ``alerts_expected`` rule, which the bench has not: from the
port's own CPU init every rack criterion holds too."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.chaos_bench as ref  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import (assert_matches, one_torch_thread,  # noqa: E402
                                reference_on_jax, round_trips)

from cdrs_tpu_torch.benchmarks import chaos_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: The reference's toy scales (tests/test_faults.py, tests/test_partitions.py
#: at CDRS_CHAOS_SEED 0).
KILL_TOY = dict(n_files=120, seed=7, duration=720.0, n_windows=8, kill_window=3, k=8,
                overhead=False)
RACK_TOY = dict(n_files=120, seed=17, duration=720.0, n_windows=8, kill_window=3,
                partition_windows=(2, 4))


def run_pair(fn, kw):
    with reference_on_jax(ref):
        want = getattr(ref, fn)(**kw)
    with carried_init():
        got = getattr(chaos_bench, fn)(**kw, device="cpu")
    return got, want


@pytest.mark.parametrize("fn,kw", [
    ("run_chaos_bench", KILL_TOY),
    ("run_chaos_bench", dict(overhead=False, resume_check=False)),
    ("run_rack_bench", RACK_TOY),
    ("run_rack_bench", dict(resume_check=False)),
], ids=["kill-toy", "kill-default", "rack-toy", "rack-default"])
def test_chaos_bench_matches_the_reference(fn, kw, tmp_path):
    got, want = run_pair(fn, kw)
    assert_matches(got, want)
    assert all(got["criteria"].values()), got["criteria"]
    round_trips(got, tmp_path)
