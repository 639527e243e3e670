"""Build and load the port's CUDA kernels.

Each source in ``cdrs_tpu_torch/csrc/`` compiles with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes``; the host runtime library (``HOST``: host C++ in
``csrc/host/cdrs_native.cpp`` for ``runtime/native.py``) compiles the same
way with ``g++`` (``HOST_FLAGS``: no OpenMP runtime is linked).  Builds
happen at first use, never at import, into ``cdrs_tpu_torch/_build/``
(listed in ``.gitignore``); a library's file name carries the hash of its
source, the shared headers (``csrc/*.cuh``, for the kernels) and the
flags, so an edited source rebuilds and an unchanged one loads as it is.
The compiler writes a temporary file that replaces the target in one
step, so processes building at once never load a partial library.
``build_all`` starts one compiler per source at once and waits for all of
them; each run counts ``kernel.builds.<source>`` and its wall time goes to
the ``kernel.build.seconds`` histogram of the active instrument (a
library found on disk or already loaded counts nothing); a failed build
raises with the compiler's output.  ``bind`` sets a function's ctypes
signature once; ``scratch`` keeps a kernel's reusable buffers and
``drop_scratch`` forgets them.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from ..obs.telemetry import current

__all__ = ["SOURCES", "build_all", "load", "bind", "scratch", "drop_scratch", "on_device",
           "nvcc_path", "ptxas_info", "HOST", "HOST_SOURCE", "HOST_FLAGS", "cxx_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("lloyd", "seg_count", "seg_sum")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST = "cdrs_native"
HOST_SOURCE = CSRC / "host" / "cdrs_native.cpp"
HOST_FLAGS = ("-O3", "-std=c++20", "-fPIC", "-shared", "-pthread", "-Wall", "-Wextra")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_scratch: dict[tuple, tuple] = {}
_SCRATCH_ENTRIES = 8
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


def cxx_path() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host runtime library builds with a C++20 "
                       "compiler")


def _recipe(name: str):
    """(compiler finder, flags, source, headers hashed with the source)."""
    if name == HOST:
        return cxx_path, HOST_FLAGS, HOST_SOURCE, []
    # The shared headers are hashed with every kernel: any of them may include them.
    return nvcc_path, FLAGS, CSRC / f"{name}.cu", sorted(CSRC.glob("*.cuh"))


def _target(name: str) -> Path:
    _, flags, src, headers = _recipe(name)
    data = b"".join(p.read_bytes() for p in [src, *headers])
    digest = hashlib.sha256(data + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, compiler: str):
    _, flags, src, _ = _recipe(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.Popen([compiler, *flags, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"{Path(compiler).name} failed to start on {src.name}: {e}") \
            from None
    return proc, tmp, _target(name)


def build_all(names=SOURCES) -> None:
    """Compile every library of ``names`` that is missing, all in parallel."""
    with _lock:
        todo = [n for n in names if n not in _libs and not _target(n).exists()]
        if todo:
            compilers = {n: _recipe(n)[0]() for n in todo}
            t0 = time.perf_counter()
            jobs = {}
            try:
                for name in todo:
                    jobs[name] = _start(name, compilers[name])
            except RuntimeError:
                for proc, tmp, _ in jobs.values():
                    proc.kill()
                    proc.wait()
                    os.unlink(tmp)
                raise
            errors = []
            tel = current()
            for name, (proc, tmp, out) in jobs.items():
                log, _ = proc.communicate()
                if name in SOURCES:
                    ptxas_info[name] = log
                if tel is not None:
                    tel.counter_inc(f"kernel.builds.{name}")
                    tel.histogram("kernel.build.seconds", time.perf_counter() - t0)
                if proc.returncode != 0:
                    os.unlink(tmp)
                    errors.append(f"{Path(compilers[name]).name} failed on "
                                  f"{_recipe(name)[2].name}:\n{log}")
                else:
                    os.replace(tmp, out)
            if errors:
                raise RuntimeError("\n".join(errors))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_target(name)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source (a kernel's, or ``HOST``), building
    it first if needed."""
    if name not in _libs:
        build_all((name,))
    return _libs[name]


def bind(name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """``fn_name`` of library ``name`` with its ctypes signature (an int
    return code unless ``restype`` says otherwise), set once when the
    function is first bound."""
    fn = _fns.get((name, fn_name))
    if fn is None:
        fn = getattr(load(name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[(name, fn_name)] = fn
    return fn


def scratch(key: tuple, make):
    """Kernel scratch kept across calls, made by ``make()`` on first use of
    ``key``, which names the device and stream among its fields: launches
    on one stream run in order, so one buffer serves them all.  At most
    ``_SCRATCH_ENTRIES`` keys are kept; the oldest goes first."""
    buf = _scratch.get(key)
    if buf is None:
        if len(_scratch) >= _SCRATCH_ENTRIES:
            _scratch.pop(next(iter(_scratch)))
        buf = _scratch[key] = make()
    return buf


def drop_scratch(key: tuple) -> None:
    """Forgets the scratch of ``key`` (the next ``scratch`` call makes it
    anew): for buffers a failed launch may have left in a state the next
    call must not find."""
    _scratch.pop(key, None)


def on_device(index: int):
    """A context on CUDA device ``index``, entered only when it is not
    already the current one (ctypes calls run on the current device)."""
    import torch

    if torch.cuda.current_device() == index:
        return contextlib.nullcontext()
    return torch.cuda.device(index)
