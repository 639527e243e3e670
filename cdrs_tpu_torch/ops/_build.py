"""Build and load the port's CUDA kernels.

Each source in ``cdrs_tpu_torch/csrc/`` compiles with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes``.  Builds happen at first use, never at import, into
``cdrs_tpu_torch/_build/`` (listed in ``.gitignore``); a library's file
name carries the hash of its source and flags, so an edited source
rebuilds and an unchanged one loads as it is.  ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "nvcc_path", "ptxas_info"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("lloyd", "seg_count")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ``nvcc -Xptxas -v`` output (registers, shared memory, spills) per source.
ptxas_info: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a host with "
                       "the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, nvcc: str):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _target(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def build_all(names=SOURCES) -> None:
    """Compile every source whose library is missing, all in parallel."""
    with _lock:
        todo = [n for n in names if n not in _libs and not _target(n).exists()]
        if todo:
            nvcc = nvcc_path()
            jobs = {n: _start(n, nvcc) for n in todo}
            errors = []
            for name, (proc, tmp, out) in jobs.items():
                log, _ = proc.communicate()
                ptxas_info[name] = log
                if proc.returncode != 0:
                    os.unlink(tmp)
                    errors.append(f"nvcc failed on {name}.cu:\n{log}")
                else:
                    os.replace(tmp, out)
            if errors:
                raise RuntimeError("\n".join(errors))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_target(name)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building it first if needed."""
    if name not in _libs:
        build_all((name,))
    return _libs[name]
