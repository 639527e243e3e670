"""The port's ``benchmarks/serve_bench`` (part 2 of
``test_torch_bench_serve.py``, whose check it runs): the flash crowd at the
reference's default scale from its cold init, and the overhead block's
keys against the reference's ``serve_overhead``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.serve_bench as ref  # noqa: E402
from test_torch_bench_serve import check_flash_crowd  # noqa: E402
from torch_bench_parity import one_torch_thread, reference_on_jax  # noqa: E402

from cdrs_tpu_torch.benchmarks import serve_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("kw", [{}], ids=["default"])
def test_flash_crowd_matches_the_reference_from_its_init(kw):
    check_flash_crowd(kw)


def test_serve_overhead_has_the_references_keys():
    kw = dict(n_files=500, duration=240.0, repeats=1)
    got = serve_bench.serve_overhead(**kw, device="cpu")
    with reference_on_jax(ref):
        want = ref.serve_overhead(**kw)
    assert set(got) == set(want) and got["windows_per_run"] == want["windows_per_run"] == 4
