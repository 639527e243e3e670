"""The port's ``benchmarks/geo_bench`` against the reference's
``run_geo_bench`` on the CPU, from the reference's cold init (decay 1: the
reference on ``backend="jax"``) and, as ``black-friday`` needs, the rows
its jax backend draws to reseed an emptied cluster (ROADMAP C3).

Black Friday (the WAN partition: ``test_torch_bench_geo_2.py``; region
loss: ``test_torch_bench_geo_regions.py``; ``main``:
``test_torch_bench_geo_3.py``) must be the reference's in every field but
wall clock; the chooser's rates are wall clock.  The WAN
partition is ROADMAP C5's schedule (an init-sensitive scenario cell): its
bench criteria hold from the port's own CPU init as well."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.geo_bench as ref  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from test_torch_scenario_parity_6 import jax_reseeds  # noqa: E402
from torch_bench_parity import assert_matches, one_torch_thread, reference_on_jax  # noqa: E402

from cdrs_tpu_torch.benchmarks import geo_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WALL = {"seconds", "hier_files_per_sec", "hier_placements_per_sec",
        "flat_placements_per_sec", "hier_vs_flat_cost"}


def run_pair(fn, *args):
    with reference_on_jax(ref):
        want = getattr(ref, fn)(*args)
    with carried_init(), jax_reseeds():
        got = getattr(geo_bench, fn)(*args, "cpu")
    return got, want


def check_scenario(fn, n_files, seed):
    """One geo scenario against the reference's, and its criteria."""
    got, want = run_pair(fn, n_files, seed)
    assert_matches(got, want, skip=WALL)
    if fn == "_bench_black_friday":
        assert got["rebalance_equals_moved"] and got["budget_conserved"]
        assert got["drained_back_to_baseline"]
    else:
        assert got["stranded_peak"] > 0 == got["lost_while_stranded"] and got["healed_final"]


@pytest.mark.parametrize("fn,n_files,seed", [
    ("_bench_black_friday", 200, 23), ("_bench_black_friday", 300, 23),
], ids=["black-friday-quick", "black-friday-default"])
def test_geo_scenarios_match_the_reference(fn, n_files, seed):
    check_scenario(fn, n_files, seed)


def test_hier_throughput_resolves_the_references_slots():
    got = geo_bench._bench_hier_throughput(20_000, 1)
    want = ref._bench_hier_throughput(20_000, 1)
    assert set(got) == set(want) and got["n_files"] == want["n_files"]
    # The same slots resolved a file: the two rates share their timing, so
    # their ratio is the mean slots a file (rates are rounded to 0.1/s).
    assert got["hier_placements_per_sec"] / got["hier_files_per_sec"] == pytest.approx(
        want["hier_placements_per_sec"] / want["hier_files_per_sec"], rel=1e-6)
