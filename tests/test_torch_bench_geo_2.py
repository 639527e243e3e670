"""The port's ``benchmarks/geo_bench`` WAN partition against the
reference's ``_bench_wan_partition`` on the CPU (part 2 of
``test_torch_bench_geo.py``, whose helpers it uses): ROADMAP C5's
schedule, from the reference's cold init, every field but wall clock the
reference's; the stranded files come back and none is lost."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_bench_geo import check_scenario  # noqa: E402
from torch_bench_parity import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("fn,n_files,seed", [
    ("_bench_wan_partition", 300, 22), ("_bench_wan_partition", 400, 22),
], ids=["wan-quick", "wan-default"])
def test_geo_scenarios_match_the_reference(fn, n_files, seed):
    check_scenario(fn, n_files, seed)
