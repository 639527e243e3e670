"""The subsystem benches' entry points: each runs as ``python -m
cdrs_tpu_torch.benchmarks.<name>``, raises without CUDA unless given
``--device cpu``, and writes the port's own artifacts, never a path the
reference's bench writes (tests read those)."""

import importlib
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
BENCHES = ("control_bench", "chaos_bench", "storage_bench", "integrity_bench", "serve_bench",
           "daemon_bench", "overload_bench", "geo_bench", "placement_bench", "mesh_bench",
           "search_bench", "telemetry_overhead", "plan_bench")
#: Each bench's default output flags besides ``--out``.
EXTRA_OUTS = {"chaos_bench": ("DEFAULT_RACK_OUT",), "storage_bench": ("DEFAULT_OVERHEAD_OUT",)}


def _reference_paths(name: str) -> set[str]:
    text = (ROOT / "cdrs_tpu" / "benchmarks" / f"{name}.py").read_text()
    return set(re.findall(r'default="(data/[^"]+)"', text))


@pytest.mark.parametrize("name", BENCHES)
def test_default_outputs_are_the_ports_own(name):
    mod = importlib.import_module(f"cdrs_tpu_torch.benchmarks.{name}")
    ours = {mod.DEFAULT_OUT, *(getattr(mod, a) for a in EXTRA_OUTS.get(name, ()))}
    theirs = _reference_paths(name)
    assert theirs and not ours & theirs, (ours, theirs)
    assert all(p.startswith("data/") and p.endswith("_torch.json") for p in ours), ours
    assert f"data/{name}_torch.json" == mod.DEFAULT_OUT
    assert mod.__doc__ and f"cdrs_tpu/benchmarks/{name}.py" in mod.__doc__


@pytest.mark.parametrize("name", BENCHES)
def test_main_raises_without_cuda_and_writes_nothing(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"cdrs_tpu_torch.benchmarks.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--out", str(tmp_path / "x.json")])
    assert not list(tmp_path.iterdir())


def test_benches_run_as_modules_and_are_listed():
    import cdrs_tpu_torch.benchmarks as pkg

    for name in BENCHES:
        assert f"``{name}``" in pkg.__doc__, name
    proc = subprocess.run([sys.executable, "-m", "cdrs_tpu_torch.benchmarks.serve_bench",
                           "--help"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout and "--quick" in proc.stdout
