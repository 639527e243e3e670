"""One fused Lloyd step: nearest-centroid labels and per-cluster (sum, count).

``lloyd_assign_reduce`` is the wrapper of the CUDA kernel in
``csrc/lloyd.cu``, which replaces both TPU kernels of the fused Lloyd step
in ``cdrs_tpu/ops/pallas_kernels.py``:

* ``lloyd_assign_reduce_pallas_t`` (``:392``), feature-major, run by the
  full-batch Lloyd loop (``with_labels=False``) and its final label pass;
* ``lloyd_assign_reduce_pallas`` (``:443``), row-major with a runtime
  ``n_valid`` mask and a label for every row, run by the mini-batch update
  and predict (``ops/kmeans_stream.py``) and the drift detector's step
  (``control/drift.py``).

The TPU needed two kernels only for its lane padding of narrow rows; the
CUDA kernel reads row-major ``x``, masks rows ``>= n_valid`` itself and
writes every label when asked, which is the second kernel's contract, so
one kernel and one launch counter serve both.  On a CPU tensor the
wrapper runs ``lloyd_assign_reduce_plain``, the same function in plain
PyTorch; on a CUDA tensor it launches the kernel or raises.  The kernel's
source note says what bounds it on the card and what its design does
about that.

Semantics shared by both versions:
* distances ``|c|^2 - 2 x.c`` in float32 (float64 for float64 points on
  the CPU); for bf16 points ``c`` is rounded to bf16 and ``|c|^2`` is taken
  in f32 from the rounded centroids, as the TPU kernel does;
* the first minimum wins;
* rows ``>= n_valid`` get a label but add nothing to sums or counts,
  whatever they hold (no zero-pad contract);
* sums are float32 (the stat dtype), counts are exact integers returned
  as float32.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import stat_dtype
from . import _build

__all__ = ["lloyd_assign_reduce", "lloyd_assign_reduce_plain", "centroid_operands"]

_KERNEL_DTYPES = {torch.float32: "cdrs_lloyd_f32", torch.bfloat16: "cdrs_lloyd_bf16"}


def centroid_operands(c: torch.Tensor, dtype: torch.dtype):
    """(c as the distance pass reads it, |c|^2) in the stat dtype: ``c``
    rounded to the points' dtype first, so the ranking is consistent."""
    acc = stat_dtype(dtype)
    c_used = c.to(dtype).to(acc).contiguous()
    return c_used, (c_used * c_used).sum(dim=1)


def lloyd_assign_reduce_plain(x: torch.Tensor, c: torch.Tensor, n_valid: int,
                              with_labels: bool = True):
    """Plain PyTorch version: (labels (n,) int32 or None, sums (k, d),
    counts (k,)) in the stat dtype of ``x``."""
    acc = stat_dtype(x.dtype)
    k = c.shape[0]
    c_used, csq = centroid_operands(c, x.dtype)
    xf = x.to(acc)
    labels = torch.argmin(csq[None, :] - 2.0 * (xf @ c_used.T), dim=1)
    lab_v = labels[:n_valid]
    onehot = torch.nn.functional.one_hot(lab_v, k).to(acc)
    sums = onehot.T @ xf[:n_valid]
    counts = torch.bincount(lab_v, minlength=k).to(acc)
    return (labels.to(torch.int32) if with_labels else None), sums, counts


def _check(x: torch.Tensor, c: torch.Tensor, n_valid: int):
    if x.dim() != 2 or c.dim() != 2 or c.shape[1] != x.shape[1]:
        raise ValueError(f"x must be (n, d) and c (k, d); got {tuple(x.shape)}, "
                         f"{tuple(c.shape)}")
    if not 0 <= n_valid <= x.shape[0]:
        raise ValueError(f"n_valid={n_valid} outside [0, {x.shape[0]}]")
    if c.shape[0] < 1:
        raise ValueError("need at least one centroid")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major)")


def lloyd_assign_reduce(x: torch.Tensor, c: torch.Tensor, n_valid: int | None = None,
                        with_labels: bool = True):
    """Fused Lloyd step.  Returns (labels (n,) int32 or None, sums (k, d)
    f32, counts (k,) f32); ``n_valid`` defaults to every row."""
    n_valid = x.shape[0] if n_valid is None else int(n_valid)
    _check(x, c, n_valid)
    if x.device.type == "cpu":
        return lloyd_assign_reduce_plain(x, c, n_valid, with_labels)
    if x.device.type != "cuda" or c.device != x.device:
        raise ValueError(f"x and c must share one CUDA device; got {x.device}, {c.device}")
    fn_name = _KERNEL_DTYPES.get(x.dtype)
    if fn_name is None:
        raise TypeError(f"the Lloyd kernel takes float32 or bfloat16 points, got {x.dtype}")
    n, d = x.shape
    k = c.shape[0]
    c_used, csq = centroid_operands(c, x.dtype)
    nb = max(1, min(2 * torch.cuda.get_device_properties(x.device).multi_processor_count,
                    -(-n // 256)))
    labels = torch.empty(n, dtype=torch.int32, device=x.device) if with_labels else None
    part_sums = torch.empty((nb, k, d), dtype=torch.float32, device=x.device)
    part_counts = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    sums = torch.empty((k, d), dtype=torch.float32, device=x.device)
    counts = torch.empty(k, dtype=torch.int32, device=x.device)
    fn = getattr(_build.load("lloyd"), fn_name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), c_used.data_ptr(), csq.data_ptr(), n, n_valid, d, k,
                 labels.data_ptr() if labels is not None else None,
                 part_sums.data_ptr(), part_counts.data_ptr(), sums.data_ptr(),
                 counts.data_ptr(), nb, stream)
    if err != 0:
        raise RuntimeError(f"lloyd kernel launch failed: cudaError {err} "
                           f"(n={n}, d={d}, k={k}, dtype={x.dtype})")
    lloyd_assign_reduce.launches += 1
    return labels, sums, counts.to(torch.float32)


#: Launches of the CUDA kernel (CPU calls of the plain version do not count).
lloyd_assign_reduce.launches = 0
