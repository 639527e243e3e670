"""Device and dtype rules shared by every module of the port.

* ``resolve_device``: the port runs on CUDA unless the caller asks for the
  CPU.  A host without CUDA raises instead of running on the CPU silently.
* ``stat_dtype``: bf16/f16 points keep float32 centroids, sums and counts
  (a bf16 count saturates at 256, a bf16 sum of n/k terms keeps ~2 digits);
  f32/f64 pass through.
* ``deterministic``: the numerics the port is held to — deterministic
  algorithms on, TF32 off for matmuls and convolutions.
* ``unfilled``: allocation without deterministic mode's NaN fill, for
  buffers a kernel writes in full; ``sm_count``: a device's SM count,
  read once.
* ``device_name``: the card's name, or "torch-cpu" for the CPU: the
  platform a run's records carry (``benchmarks/regress``).
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.utils.deterministic

__all__ = ["resolve_device", "stat_dtype", "torch_dtype", "deterministic", "unfilled",
           "sm_count", "device_name"]

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" -> the current CUDA device (raises without CUDA);
    "cpu" -> the CPU; a ``torch.device`` or "cuda:N" passes through."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) to "
                "run the port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator/centroid dtype for a points dtype."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms on and TF32 off for the block; the previous
    settings come back on exit."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]
        torch.backends.cudnn.allow_tf32 = prev[2]


class unfilled:
    """``torch.empty`` inside the block skips deterministic mode's NaN fill
    (``torch.utils.deterministic.fill_uninitialized_memory``); the flag comes
    back on exit.  Only for buffers that a kernel writes in full.  Outside
    deterministic mode nothing is filled and nothing is touched."""

    __slots__ = ("_prev",)

    def __enter__(self):
        self._prev = (torch.are_deterministic_algorithms_enabled()
                      and torch.utils.deterministic.fill_uninitialized_memory)
        if self._prev:
            torch.utils.deterministic.fill_uninitialized_memory = False
        return self

    def __exit__(self, *exc):
        if self._prev:
            torch.utils.deterministic.fill_uninitialized_memory = True
        return False


def device_name(dev: torch.device) -> str:
    """The card's name as ``torch.cuda.get_device_name`` gives it, or
    "torch-cpu" on the CPU."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "torch-cpu"


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
