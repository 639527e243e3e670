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

One call is one launch.  Which of the kernel's three paths a call takes
depends on (d, k, dtype) alone and is decided here, by ``plan``: the
small path (d <= 8 and k <= 16); the wgmma path (``csrc/lloyd_wgmma.cuh``)
where a row is a whole number of 16-byte units (TMA's row stride: d % 4
for f32, d % 8 for bf16) and its tiles fit a block's shared memory, with
the plan's ring depths and c resident or streamed; the mma_sync path
otherwise (d = 5, k = 64; odd bf16 widths;
d = 300).  The plan goes to the kernel with each call.  The wrapper's
fixed host cost is kept small: the ctypes signature is set once when the
library is bound, the SM count is read once per device, the plan once per
shape, and the kernel's scratch (block partials and the ticket) is made
once per (device, stream, k, d, dtype) and reused: calls on one stream
run in order, so they never share it at once.  The general paths also keep
their copy of c, in the layout their products read, past the partials
(``extra`` floats).  Where they do not keep the sums in shared memory
(large k * d) the labels are stored; if the caller asked for none, an
n-long int32 label buffer is kept the same way, keyed by n, and on the
wgmma path a second one for the block's rows sorted by cluster.
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
* the kernel's general paths (any other shape): tensor-core products
  (wgmma or mma.sync, the same numerics).  f32 points are split into TF32
  high and low parts (round to nearest) and ``x.c`` is lo.hi' + hi.lo' +
  hi.hi', a k-step of 8 features at a time, within
  ``(2^-20 + 3 d 2^-23) sum_f |x_f c_f|`` of the exact product; bf16
  points take one exact bf16 product.  The best per row is kept with
  strict ``<`` over increasing j and merged by (distance, index), so the
  lower index wins equal distances.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import NamedTuple

import torch

from ..device import sm_count, stat_dtype, unfilled
from ..obs import kprof
from ..parallel.mesh import collective_bytes_estimate, shard_valid
from . import _build

__all__ = ["lloyd_assign_reduce", "lloyd_assign_reduce_plain", "centroid_operands",
           "sharded_assign_reduce", "rowmajor", "plan", "wgmma_layout", "Plan", "Layout"]

_KERNEL_DTYPES = {torch.float32: "cdrs_lloyd_f32", torch.bfloat16: "cdrs_lloyd_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
_INFO_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
#: The kernel's path codes (``csrc/lloyd.cu``'s plan array).
PATHS = {"small": 0, "mma_sync": 1, "wgmma": 2}
#: The wgmma path's fixed sizes (``csrc/lloyd_wgmma.cuh``): rows a block
#: tile (two consumer warpgroups of 128), centroids a tile (the wgmma
#: instructions' N), shared memory a block may take, consumer threads.
WG_ROWS = 256
WG_CENTROIDS = 128
SMEM_MAX = 227 * 1024
WG_CONSUMERS = 256
#: (d, k, bf16) -> (plan, the plan as the kernel takes it, whether the
#: kernel stores labels even when none are asked, floats of scratch it
#: needs past the block partials).
_SHAPES: dict[tuple, tuple] = {}
#: True inside ``rowmajor()``.
_ROWMAJOR = contextvars.ContextVar("lloyd_rowmajor", default=False)


class Plan(NamedTuple):
    """A call's path and, on the wgmma path, its tiles: ``cstages`` c
    chunks in flight (streamed c), ``xstages`` row tiles of x in the ring,
    ``resident`` (all of c in shared memory)."""
    path: str
    cstages: int = 0
    xstages: int = 0
    resident: int = 0

    def as_ints(self) -> list[int]:
        return [PATHS[self.path], self.cstages, self.xstages, self.resident]


class Layout(NamedTuple):
    """The shared memory a wgmma plan takes at a shape, as
    ``csrc/lloyd_wgmma.cuh``'s ``layout`` computes it, and its feature
    chunks (``cb`` bytes of a row each, ``nfc`` of them).  ``plan`` reads
    it only to choose a plan that fits; the scratch a call needs comes from
    the CUDA source (``plan_info``)."""
    smem: int
    cb: int
    nfc: int


def wgmma_layout(d: int, k: int, esz: int, p: Plan) -> Layout | None:
    """The wgmma plan's layout at (d, k) for points of ``esz`` bytes, or
    None where it cannot serve: rows not a whole number of 16-byte units,
    more shared memory than a block has, or no room for the sums' sort
    (9 k + 256 ints) in the freed tiles."""
    row = d * esz
    if row % 16 or p.xstages < 1 or (not p.resident and p.cstages < 2):
        return None
    cb = 128 if row > 64 else (64 if row > 32 else 32)
    nfc = -(-row // cb)
    ntc = -(-k // WG_CENTROIDS)
    chunk = (2 if esz == 4 else 1) * WG_CENTROIDS * cb
    cstages = 1 if p.resident else p.cstages
    cbuf = ntc * nfc * chunk if p.resident else cstages * chunk
    off_bar = p.xstages * WG_ROWS * cb * nfc + cbuf
    smem = off_bar + (2 * p.xstages * nfc + 2 * cstages) * 8 + 1024
    if smem > SMEM_MAX or (9 * k + WG_CONSUMERS) * 4 > off_bar:
        return None
    return Layout(smem, cb, nfc)


def plan(d: int, k: int, dtype) -> Plan:
    """The kernel's path at (d, k, dtype), and on the wgmma path its tiles.

    Small path: d <= 8 and k <= 16.  wgmma path: rows a whole number of
    16-byte units (TMA's row stride) and a layout that fits: centroid tiles
    of 128 (``WG_CENTROIDS``); all of c resident with 4 to 2 row
    tiles of x in the ring, else c streamed beside two row tiles through a
    ring of at least four chunks and two centroid tiles' worth, or beside
    one row tile through the deepest ring (12 to 2 chunks) that fits.  bf16
    points whose c would be resident (small k * d, as config 2's 1M x 32,
    k = 128) keep the mma_sync path: there the products are a sliver of the
    work, and the wgmma path's ranking and re-read sums made it 6-10%
    slower in every same-card read (PERF.md, PR 22).  Otherwise the
    mma_sync path (its layout is the CUDA source's)."""
    if d <= 8 and k <= 16:
        return Plan("small")
    esz = 2 if dtype == torch.bfloat16 else 4
    if (d * esz) % 16 == 0:
        nfc = -(-d * esz // 128)
        cands = [Plan("wgmma", 1, xs, 1) for xs in (4, 3, 2)]
        cands += [Plan("wgmma", cs, 2, 0) for cs in range(12, max(4, 2 * nfc) - 1, -1)]
        cands += [Plan("wgmma", cs, 1, 0) for cs in range(12, 1, -1)]
        for cand in cands:
            if wgmma_layout(d, k, esz, cand) is not None:
                return Plan("mma_sync") if esz == 2 and cand.resident else cand
    return Plan("mma_sync")


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
    nb = 2 * sms   # no path keeps more than two blocks on an SM
    stream = torch.cuda.current_stream(dev).cuda_stream
    p, plan_arg, keeps_labels, extra = _shape_info(d, k, x.dtype)
    if p.path == "wgmma" and x.data_ptr() % 16:
        raise ValueError(f"lloyd kernel: the wgmma path (d={d}, {x.dtype}) reads x by TMA, "
                         f"which needs a 16-byte aligned start; x starts at "
                         f"{x.data_ptr():#x}")
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
    order = None
    if p.path == "wgmma":
        order = _build.scratch(("lloyd_order", dev.index, stream, n),
                               lambda: _label_scratch(dev, n))
    fn = _build.bind("lloyd", fn_name, _ARGTYPES)
    with _build.on_device(dev.index), probe:
        err = fn(x.data_ptr(), c_used.data_ptr(), n, n_valid, d, k,
                 lab_buf.data_ptr() if lab_buf is not None else None,
                 part_sums.data_ptr(), part_counts.data_ptr(), ticket.data_ptr(),
                 sums.data_ptr(), counts.data_ptr(), nb, sms, stream, plan_arg,
                 order.data_ptr() if order is not None else None)
    if err != 0:
        raise RuntimeError(f"lloyd kernel launch failed: cudaError {err} "
                           f"(n={n}, d={d}, k={k}, dtype={x.dtype}, {p})")
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


def _shape_info(d: int, k: int, dtype):
    """(plan, the plan as a ctypes int array, whether the kernel stores
    labels at this shape even when the caller asked for none, floats of
    scratch it needs past the block partials), once per shape.  The last
    two come from the CUDA source (``cdrs_lloyd_plan_info``) on both
    general paths, so the scratch is sized by the code that uses it."""
    key = (d, k, dtype == torch.bfloat16)
    if key not in _SHAPES:
        p = plan(d, k, dtype)
        arg = (ctypes.c_int * len(p.as_ints()))(*p.as_ints())
        if p.path == "small":
            keeps, extra = False, 0
        else:
            out = plan_info(d, k, dtype, p)
            if out is None:
                raise ValueError(f"lloyd kernel: the CUDA source refuses plan {p} at d={d}, "
                                 f"k={k}, {dtype}")
            extra, keeps, _ = out
            keeps = bool(keeps)
        _SHAPES[key] = (p, arg, keeps, extra)
    return _SHAPES[key]


def plan_info(d: int, k: int, dtype, p: Plan):
    """(extra floats, keeps labels, shared-memory bytes) of plan ``p`` at
    (d, k) as the CUDA source computes them, or None where it cannot serve
    the shape (builds the library on first use)."""
    info = _build.bind("lloyd", "cdrs_lloyd_plan_info", _INFO_ARGTYPES)
    out = (ctypes.c_int64 * 3)()
    ints = p.as_ints()
    rc = info(d, k, int(dtype == torch.bfloat16), (ctypes.c_int * len(ints))(*ints), out)
    return None if rc != 0 else (int(out[0]), int(out[1]), int(out[2]))


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
