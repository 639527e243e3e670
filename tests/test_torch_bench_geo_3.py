"""The port's ``benchmarks/geo_bench`` entry point (part 3 of
``test_torch_bench_geo.py``): ``main --quick`` on the CPU from the port's
own init."""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_bench_parity import one_torch_thread  # noqa: E402

from cdrs_tpu_torch.benchmarks import geo_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_geo_bench_main_quick_from_the_ports_own_init(tmp_path, capsys, monkeypatch):
    """``main --quick`` on the CPU, the chooser cut to 20,000 files: every
    criterion holds from the port's own init, and the artifact has the
    reference's keys plus the port's stamps."""
    run = geo_bench.run_geo_bench
    monkeypatch.setattr(geo_bench, "run_geo_bench",
                        lambda **kw: run(**dict(kw, chooser_n=20_000)))
    out = tmp_path / "g.json"
    assert geo_bench.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert all(doc["criteria"].values()), doc["criteria"]
    assert set(doc) == {"methodology", "region_loss", "hier_throughput", "black_friday",
                        "wan_partition", "criteria", "bench_records", "round", "quick",
                        "run_meta", "cold_init"}
    assert doc["quick"] and doc["round"] == 14
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["history_appended"] == 0
