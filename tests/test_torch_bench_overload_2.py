"""The port's ``benchmarks/overload_bench`` coalescing run against the
reference's ``run_coalesce_determinism`` (part 2 of
``test_torch_bench_overload.py``, whose check it runs): from the
reference's cold init, every field the reference's, the records identical
across two runs and coalescing engaged."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_bench_overload import check_overfed_run  # noqa: E402
from torch_bench_parity import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("fn", ["run_coalesce_determinism"])
def test_overfed_runs_match_the_reference(fn, tmp_path):
    check_overfed_run(fn, tmp_path)
