"""The port's ``benchmarks/geo_bench`` region-loss contrast against the
reference's ``_bench_region_loss`` on the CPU (the rest of the bench:
``test_torch_bench_geo.py``): eight controller runs a scale, from the
reference's cold init, with the reference on ``backend="jax"``.  Every
lost count must be the reference's: zero under the geo hierarchy, some
under flat racks, for replicate and EC(6,3) in both placement modes.  The
default scale: ``test_torch_bench_geo_regions_2.py``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_bench_geo import WALL, run_pair  # noqa: E402
from torch_bench_parity import assert_matches, one_torch_thread, round_trips  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def check_region_loss(n_files, tmp_path):
    """The region-loss contrast at ``n_files`` against the reference's."""
    got, want = run_pair("_bench_region_loss", n_files, 21)
    assert_matches(got, want, skip=WALL)
    for mode in ("replicate_materialized", "replicate_functional", "ec_materialized",
                 "ec_functional"):
        assert got[mode]["lost_max_hier"] == 0 < got[mode]["lost_max_flat"], mode
    round_trips(got, tmp_path)


@pytest.mark.parametrize("n_files", [300], ids=["quick"])
def test_region_loss_matches_the_reference(n_files, tmp_path):
    check_region_loss(n_files, tmp_path)
