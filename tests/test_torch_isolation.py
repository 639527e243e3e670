"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and its entry points do not drop to the CPU on their own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cdrs_tpu_torch"


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def _sources():
    # _build holds build outputs (gitignored), not the package's sources.
    return sorted(p for p in PKG.rglob("*.py") if "_build" not in p.relative_to(PKG).parts) \
        + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "cdrs_tpu" or module.startswith("cdrs_tpu."))


def test_package_imports_with_jax_absent_and_loads_no_jax_package_module():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import cdrs_tpu_torch\n"
        "for m in pkgutil.walk_packages(cdrs_tpu_torch.__path__, 'cdrs_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "loaded = sorted(n for n, mod in sys.modules.items() if mod is not None\n"
        "                and (n in ('jax', 'cdrs_tpu') or n.startswith(('jax.', 'cdrs_tpu.'))))\n"
        "print(loaded)\n"
        "assert not loaded, loaded\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_source_names_no_jax_import(path):
    tree = ast.parse(path.read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_run_pipeline_without_device_raises_on_a_cuda_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    from cdrs_tpu_torch import GeneratorConfig, PipelineConfig, run_pipeline

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_pipeline(PipelineConfig(generator=GeneratorConfig(n_files=40, seed=0)))


def test_cuda_tensors_never_take_the_plain_path():
    """The update rule sends CUDA points to the kernel (f32/bf16) or
    raises; only CPU points take the plain matmul version."""
    from cdrs_tpu_torch.ops.kmeans import resolve_update

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve_update("auto", cuda, torch.float32) == "kernel"
    assert resolve_update("auto", cuda, torch.bfloat16) == "kernel"
    assert resolve_update("auto", cpu, torch.float32) == "matmul"
    with pytest.raises(ValueError, match="CPU reference"):
        resolve_update("matmul", cuda, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        resolve_update("auto", cuda, torch.float64)


def test_resolve_device_rules():
    from cdrs_tpu_torch.device import resolve_device, stat_dtype

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert stat_dtype(torch.bfloat16) == torch.float32
    assert stat_dtype(torch.float16) == torch.float32
    assert stat_dtype(torch.float64) == torch.float64
