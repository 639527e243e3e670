"""The port's ``benchmarks/geo_bench`` region-loss contrast at the
reference's default scale (part 2 of ``test_torch_bench_geo_regions.py``,
whose check it runs)."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_bench_geo_regions import check_region_loss  # noqa: E402
from torch_bench_parity import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("n_files", [400], ids=["default"])
def test_region_loss_matches_the_reference(n_files, tmp_path):
    check_region_loss(n_files, tmp_path)
