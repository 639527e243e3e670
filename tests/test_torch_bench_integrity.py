"""The port's ``benchmarks/integrity_bench`` against the reference's
``run_mttd_sweep``, ``run_overlap_bench`` and ``_lap_upper_bytes`` on the
CPU, from the reference's cold init (decay 1: the reference on
``backend="jax"``): detection latencies, residual rot, true and blind
losses, corrupt reads served and the mid-scrub kill/resume must be the
reference's.  The overhead block, ``main`` and the scrubbed side's loss at
``--quick``'s scale (ROADMAP C10): ``test_torch_bench_integrity_2.py``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.integrity_bench as ref  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import (assert_matches, one_torch_thread,  # noqa: E402
                                reference_on_jax, round_trips)

from cdrs_tpu_torch.benchmarks import integrity_bench  # noqa: E402
from cdrs_tpu_torch.config import GeneratorConfig  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: The reference's ``--quick`` scale.
QUICK = dict(n_files=160, seed=17, duration=720.0, n_windows=8, corrupt_window=2, k=8)


def run_pair(fn, kw):
    with reference_on_jax(ref):
        want = getattr(ref, fn)(**kw)
    with carried_init():
        got = getattr(integrity_bench, fn)(**kw, device="cpu")
    return got, want


@pytest.mark.parametrize("fn,kw", [
    ("run_mttd_sweep", dict(QUICK, budget_fracs=(0.25, 0.5))),
    ("run_mttd_sweep", {}),
    ("run_overlap_bench", dict(QUICK, kill_window=4)),
    ("run_overlap_bench", dict(resume_check=False)),
], ids=["mttd-quick", "mttd-default", "overlap-quick", "overlap-default"])
def test_integrity_bench_matches_the_reference(fn, kw, tmp_path):
    got, want = run_pair(fn, kw)
    assert_matches(got, want)
    round_trips(got, tmp_path)
    if fn == "run_mttd_sweep":
        assert all(s["detected_within_bound"] for s in got["sweep"])
    else:
        assert got["scrubbed"]["true_lost_final"] == 0
        assert got["unscrubbed"]["corrupt_reads_served"] > 0


def test_lap_upper_bytes_is_the_references():
    from cdrs_tpu.config import GeneratorConfig as RefGen
    from cdrs_tpu.sim.generator import generate_population as ref_gen

    from cdrs_tpu_torch.benchmarks.common import min_rf2_scoring

    man = generate_population(GeneratorConfig(n_files=300, seed=17))
    ref_man = ref_gen(RefGen(n_files=300, seed=17))
    got = integrity_bench._lap_upper_bytes(man, min_rf2_scoring(every_category=True), 2)
    assert got == ref._lap_upper_bytes(ref_man, ref._min_rf2_scoring(), 2) > 0
