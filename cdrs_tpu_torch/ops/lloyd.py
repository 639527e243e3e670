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
one kernel and one launch counter serve both.  The second kernel's callers
run their steps inside ``rowmajor()``, and each launch made there also
counts in ``lloyd_assign_reduce.rowmajor_launches``: the run's share of
the row-major route.  On a CPU tensor the
wrapper runs ``lloyd_assign_reduce_plain``, the same function in plain
PyTorch; on a CUDA tensor it launches the kernel or raises.  The kernel's
source note says what bounds it on the card and what its design does
about that.

One call is one launch.  The wrapper's fixed host cost is kept small: the
ctypes signature is set once when the library is bound, the SM count is
read once per device, and the kernel's scratch (block partials and the
last-block ticket) is made once per (device, stream, k, d, dtype) and
reused: calls on one stream run in order, so they never share it at once.
The general path also keeps its copy of c, in the layout its products
read, past the partials (``cdrs_lloyd_extra_scratch``).  Where it takes its
sums in passes over stored labels (large k * d:
``cdrs_lloyd_keeps_labels``) and the caller asked for none, an n-long int32
label buffer is kept the same way, keyed by n.
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

How each version ranks (where labels may differ, they differ only on
near-ties):
* plain: one float32 matmul ``x @ c.T`` (full f32 on the card: PyTorch's
  default keeps TF32 off for matmuls), then ``argmin``;
* the kernel's small path (d <= 8 and k <= 16): fmaf chains in feature
  order on the CUDA cores, strict ``<`` over increasing j;
* the kernel's general path (any other shape): tensor-core products.
  f32 points are split into TF32 high and low parts (round to nearest)
  and ``x.c`` is lo.hi' + hi.lo' + hi.hi', within
  ``(2^-20 + 3 d 2^-23) sum_f |x_f c_f|`` of the exact product; bf16
  points take one exact bf16 product.  The best per row is kept with
  strict ``<`` over increasing j and merged by (distance, index), so the
  lower index wins equal distances.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes

import torch

from ..device import sm_count, stat_dtype, unfilled
from ..obs import kprof
from ..parallel.mesh import collective_bytes_estimate, shard_valid
from . import _build

__all__ = ["lloyd_assign_reduce", "lloyd_assign_reduce_plain", "centroid_operands",
           "sharded_assign_reduce", "rowmajor"]

_KERNEL_DTYPES = {torch.float32: "cdrs_lloyd_f32", torch.bfloat16: "cdrs_lloyd_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
#: (d, k, bf16) -> (whether the kernel stores labels even when none are
#: asked, floats of scratch it needs past the block partials).
_SHAPES: dict[tuple, tuple[bool, int]] = {}
#: True inside ``rowmajor()``.
_ROWMAJOR = contextvars.ContextVar("lloyd_rowmajor", default=False)


@contextlib.contextmanager
def rowmajor():
    """The block's launches are the row-major route's (the TPU's
    ``lloyd_assign_reduce_pallas``): the mini-batch step, predict and the
    drift step.  Each counts in ``lloyd_assign_reduce.launches`` and in
    ``lloyd_assign_reduce.rowmajor_launches``."""
    token = _ROWMAJOR.set(True)
    try:
        yield
    finally:
        _ROWMAJOR.reset(token)


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
    probe = kprof.instrumented_kernel("lloyd_assign_reduce", x, (c.shape[0], with_labels),
                                      lambda: _cost(x, c, n_valid, with_labels))
    if x.device.type == "cpu":
        with probe:
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
    keeps_labels, extra = _shape_info(d, k, x.dtype)
    part_sums, part_counts, ticket = _build.scratch(
        ("lloyd", dev.index, stream, k, d, x.dtype),
        lambda: _make_scratch(dev, nb * k * d + extra, nb * k))
    with unfilled():   # the kernel writes every label, sum and count
        labels = torch.empty(n, dtype=torch.int32, device=dev) if with_labels else None
        sums = torch.empty((k, d), dtype=torch.float32, device=dev)
        counts = torch.empty(k, dtype=torch.float32, device=dev)
    lab_buf = labels
    if lab_buf is None and keeps_labels:
        lab_buf = _build.scratch(("lloyd_labels", dev.index, stream, n),
                                 lambda: _label_scratch(dev, n))
    fn = _build.bind("lloyd", fn_name, _ARGTYPES)
    with _build.on_device(dev.index), probe:
        err = fn(x.data_ptr(), c_used.data_ptr(), n, n_valid, d, k,
                 lab_buf.data_ptr() if lab_buf is not None else None,
                 part_sums.data_ptr(), part_counts.data_ptr(), ticket.data_ptr(),
                 sums.data_ptr(), counts.data_ptr(), nb, sms, stream)
    if err != 0:
        raise RuntimeError(f"lloyd kernel launch failed: cudaError {err} "
                           f"(n={n}, d={d}, k={k}, dtype={x.dtype})")
    lloyd_assign_reduce.launches += 1
    if _ROWMAJOR.get():
        lloyd_assign_reduce.rowmajor_launches += 1
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
    d = c.shape[1]
    payload = c.shape[0] * (d + 1) * c.element_size()
    stamp = (kprof.mesh_stamp(mesh.size, collective_bytes_estimate(payload, mesh.n_data))
             if mesh.size > 1 else contextlib.nullcontext())
    with stamp:
        out = [step(s, x, c.to(x.device), shard_valid(n_valid, n_loc, s), with_labels)
               for s, x in zip(mesh.local, shards)]
    stats = mesh.psum([torch.cat([sums, counts[:, None]], dim=1) for _, sums, counts in out])
    labels = None
    if with_labels:
        labels = mesh.all_gather([lab for lab, _, _ in out]).reshape(-1)[:n_valid]
    return labels, stats[:, :d], stats[:, d]


def _cost(x, c, n_valid: int, with_labels: bool) -> dict:
    n, d = x.shape
    return kprof.kernel_cost("lloyd_assign_reduce", n=n, d=d, k=c.shape[0], n_valid=n_valid,
                             dtype=str(x.dtype).replace("torch.", ""),
                             with_labels=with_labels)


def _shape_info(d: int, k: int, dtype) -> tuple[bool, int]:
    """(whether the kernel stores labels at this shape even when the caller
    asked for none, floats of scratch it needs past the block partials), as
    ``cdrs_lloyd_keeps_labels`` and ``cdrs_lloyd_extra_scratch`` say: the
    general path's sums taken in passes, and its copy of c in the layout its
    products read.  Asked once per shape."""
    if d <= 8 and k <= 16:
        return False, 0   # the small path
    key = (d, k, dtype == torch.bfloat16)
    if key not in _SHAPES:
        keeps = _build.bind("lloyd", "cdrs_lloyd_keeps_labels", [ctypes.c_int] * 3)
        extra = _build.bind("lloyd", "cdrs_lloyd_extra_scratch", [ctypes.c_int] * 3,
                            restype=ctypes.c_int64)
        _SHAPES[key] = (bool(keeps(d, k, int(key[2]))), int(extra(d, k, int(key[2]))))
    return _SHAPES[key]


def _label_scratch(dev, n: int):
    with unfilled():
        return torch.empty(max(n, 1), dtype=torch.int32, device=dev)


def _make_scratch(dev, sum_floats: int, count_ints: int):
    """Block partials (and the general path's copy of c past them; written
    in full by each launch) and the ticket (zero between launches)."""
    with unfilled():
        part_sums = torch.empty(sum_floats, dtype=torch.float32, device=dev)
        part_counts = torch.empty(count_ints, dtype=torch.int32, device=dev)
    return part_sums, part_counts, torch.zeros(1, dtype=torch.int32, device=dev)


#: Launches of the CUDA kernel (CPU calls of the plain version do not count).
lloyd_assign_reduce.launches = 0
#: Those of them made inside ``rowmajor()``.
lloyd_assign_reduce.rowmajor_launches = 0
