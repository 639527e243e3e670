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

One call is one launch.  The wrapper's fixed host cost is kept small: the
ctypes signature is set once when the library is bound, the SM count is
read once per device, and the kernel's scratch (block partials and the
last-block ticket) is made once per (device, stream, k, d) and
reused: calls on one stream run in order, so they never share it at once.
Outputs are fresh on every call (callers keep them) and are allocated
without deterministic mode's NaN fill, since the kernel writes them in
full.

Semantics shared by both versions:
* distances ``|c|^2 - 2 x.c`` in float32 (float64 for float64 points on
  the CPU); for bf16 points ``c`` is rounded to bf16 and ``|c|^2`` is taken
  in f32 from the rounded centroids, as the TPU kernel does; ``|c|^2``
  adds the squares in feature order in both versions (the kernel takes it
  itself, so the wrapper launches nothing else for f32 points);
* the first minimum wins;
* rows ``>= n_valid`` get a label but add nothing to sums or counts,
  whatever they hold (no zero-pad contract);
* sums are float32 (the stat dtype), counts are exact integers returned
  as float32; the kernel adds in a fixed order, so two calls on the same
  inputs give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import sm_count, stat_dtype, unfilled
from ..parallel.mesh import shard_valid
from . import _build

__all__ = ["lloyd_assign_reduce", "lloyd_assign_reduce_plain", "centroid_operands",
           "sharded_assign_reduce"]

_KERNEL_DTYPES = {torch.float32: "cdrs_lloyd_f32", torch.bfloat16: "cdrs_lloyd_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def centroid_operands(c: torch.Tensor, dtype: torch.dtype):
    """(c as the distance pass reads it, |c|^2) in the stat dtype: ``c``
    rounded to the points' dtype first, so the ranking is consistent.
    |c|^2 adds the squares in feature order, each rounded first, as the
    kernel does."""
    c_used = _rounded(c, dtype)
    csq = c_used[:, 0] * c_used[:, 0]
    for f in range(1, c_used.shape[1]):
        csq = csq + c_used[:, f] * c_used[:, f]
    return c_used, csq


def _rounded(c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if c.dtype == dtype == stat_dtype(dtype) and c.is_contiguous():
        return c   # nothing to round: skip three no-op dispatches per call
    return c.to(dtype).to(stat_dtype(dtype)).contiguous()


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
    dev = x.device
    c_used = _rounded(c, x.dtype)   # the kernel takes |c|^2 itself
    sms = sm_count(dev.index)
    nb = 2 * sms   # neither path keeps more than two blocks on an SM
    stream = torch.cuda.current_stream(dev).cuda_stream
    part_sums, part_counts, ticket = _build.scratch(
        ("lloyd", dev.index, stream, k, d), lambda: _make_scratch(dev, nb, k, d))
    with unfilled():   # the kernel writes every label, sum and count
        labels = torch.empty(n, dtype=torch.int32, device=dev) if with_labels else None
        sums = torch.empty((k, d), dtype=torch.float32, device=dev)
        counts = torch.empty(k, dtype=torch.float32, device=dev)
    fn = _build.bind("lloyd", fn_name, _ARGTYPES)
    with _build.on_device(dev.index):
        err = fn(x.data_ptr(), c_used.data_ptr(), n, n_valid, d, k,
                 labels.data_ptr() if labels is not None else None,
                 part_sums.data_ptr(), part_counts.data_ptr(), ticket.data_ptr(),
                 sums.data_ptr(), counts.data_ptr(), nb, sms, stream)
    if err != 0:
        raise RuntimeError(f"lloyd kernel launch failed: cudaError {err} "
                           f"(n={n}, d={d}, k={k}, dtype={x.dtype})")
    lloyd_assign_reduce.launches += 1
    return labels, sums, counts


def sharded_assign_reduce(mesh, shards, n_loc: int, c: torch.Tensor, n_valid: int,
                          with_labels: bool = False, step=None):
    """The Lloyd step over the data shards of a mesh (``parallel/mesh.py``):
    one ``lloyd_assign_reduce`` a local data shard (``shards``, ``n_loc``
    rows each, the valid rows a global prefix of ``n_valid``), then one
    shard-ordered psum of the (k, d + 1) statistics.  Returns (labels
    (n_valid,) gathered in shard order, or None; sums; counts).
    ``step(shard, x, c, n_valid, with_labels)`` takes the kernel's place
    where the caller computes the step another way (the model axis)."""
    if step is None:
        def step(_, x, c, nv, wl):
            return lloyd_assign_reduce(x, c, nv, with_labels=wl)
    out = [step(s, x, c.to(x.device), shard_valid(n_valid, n_loc, s), with_labels)
           for s, x in zip(mesh.local, shards)]
    d = c.shape[1]
    stats = mesh.psum([torch.cat([sums, counts[:, None]], dim=1) for _, sums, counts in out])
    labels = None
    if with_labels:
        labels = mesh.all_gather([lab for lab, _, _ in out]).reshape(-1)[:n_valid]
    return labels, stats[:, :d], stats[:, d]


def _make_scratch(dev, nb: int, k: int, d: int):
    """Block partials (written in full by each launch) and the ticket (zero
    between launches)."""
    with unfilled():
        part_sums = torch.empty(nb * k * d, dtype=torch.float32, device=dev)
        part_counts = torch.empty(nb * k, dtype=torch.int32, device=dev)
    return part_sums, part_counts, torch.zeros(1, dtype=torch.int32, device=dev)


#: Launches of the CUDA kernel (CPU calls of the plain version do not count).
lloyd_assign_reduce.launches = 0
