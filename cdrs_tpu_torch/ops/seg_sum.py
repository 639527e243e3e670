"""Per-cluster float sums: the general form of B2.

``label_segment_sum(lab, y, k)`` returns the (k, d) float32 table

    sums[j, f] = sum of y[i, f] over the rows i with lab_i = j

for any float ``y`` (float32 or bfloat16, accumulated in float32); a label
< 0 or >= k adds nothing.  It is the counterpart of the TPU kernel
``label_segment_matmul`` (``cdrs_tpu/ops/pallas_kernels.py:534``) without
its tile argument: ``n`` is any row count, with no padding.  The name
drops "matmul" because the kernel is not a one-hot product: the TPU
builds a (tile, k) one-hot block and reduces it on the MXU, while the
CUDA kernel (``csrc/seg_sum.cu``) adds each row into its cluster's cells,
one writer a cell, in a fixed order, so two calls on the same inputs give
the same bits.  The reference also drops a label in ``[k, k_pad)``, which
lands in a padding column its ``sums[:k]`` cuts off; here such a label is
simply outside ``[0, k)``.

On a CPU tensor the wrapper runs ``label_segment_sum_plain``; on a CUDA
tensor it launches the kernel or raises.  :func:`plan` cuts the table into
slices of at most 32 features and, past about 53,000 clusters, slabs of
clusters, so that a block's table fits in shared memory beside its staging
ring.  As in
``ops/seg_count.py``, the ctypes signatures are set once, the SM count and
the kernel's resident blocks an SM are read once per (device, plan), and
the block partials are made once per (device, stream, d, k, plan) and
reused (calls on one stream run in order; every launch writes the
partials it reads); the output is fresh per call and allocated without
deterministic mode's NaN fill, since the kernel writes it in full.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..device import sm_count, unfilled
from ..obs import kprof
from . import _build

__all__ = ["label_segment_sum", "label_segment_sum_plain", "plan", "Plan", "groups"]

_KERNEL_DTYPES = {torch.float32: "cdrs_seg_sum_f32", torch.bfloat16: "cdrs_seg_sum_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_int] * 6 + [ctypes.c_int64]
             + [ctypes.c_void_p] * 3)
_OCC_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]

#: A block's dynamic shared memory may not pass this (``kSmemMax`` in
#: ``csrc/seg_sum.cu``): the H100's 227 KB a block less room for the
#: static arrays.
SMEM_MAX = 232_448 - 1_024
#: Staged chunks in flight a block (``cdrs::kStages``), the bytes of a
#: chunk's row slices at most, and its rows at most; the features of a
#: slice at most (a lane each) and the warps of a block.
STAGES = 3
STAGE_BYTES = 16_384
CHUNK_ROWS = 256
SLICE_MAX = 32
WARPS = 16


class Plan(NamedTuple):
    """How the kernel cuts the (k, d) table: slices of ``slice`` features
    (``nslices`` of them), slabs of ``slab`` clusters (``nslabs``), chunks
    of ``rows`` rows staged at a time, and a block's dynamic shared memory
    ``smem`` in bytes."""

    slice: int
    slab: int
    nslices: int
    nslabs: int
    rows: int
    smem: int

    @property
    def tiles(self) -> int:
        return self.nslices * self.nslabs


def _r16(b: int) -> int:
    return (b + 15) // 16 * 16


def _rows(s: int, itemsize: int) -> int:
    return max(1, min(CHUNK_ROWS, STAGE_BYTES // (s * itemsize)))


def _smem(s: int, ns: int, itemsize: int) -> int:
    """A block's dynamic shared memory, as ``Layout`` in ``csrc/seg_sum.cu``
    counts it: the (ns, s) float table, then ``STAGES`` buffers of a
    chunk's row slices and its int32 labels, each rounded up to 16 bytes,
    then each warp's int32 list of its rows of a chunk."""
    r = _rows(s, itemsize)
    return _r16(ns * s * 4) + STAGES * (_r16(r * s * itemsize) + _r16(r * 4)) + WARPS * r * 4


def plan(d: int, k: int, itemsize: int = 4) -> Plan:
    """The widest slice of features (all d up to ``SLICE_MAX``, else 16, 8,
    4, 2 or 1) whose table for every cluster fits ``SMEM_MAX``; where not
    even one feature fits, one-feature slices of slabs of clusters."""
    widest = min(d, SLICE_MAX)
    cands = [widest] + [s for s in (16, 8, 4, 2, 1) if s < widest]
    for s in cands:
        if _smem(s, k, itemsize) <= SMEM_MAX:
            return Plan(s, k, -(-d // s), 1, _rows(s, itemsize), _smem(s, k, itemsize))
    ns = (SMEM_MAX - _smem(1, 0, itemsize)) // 16 * 4
    return Plan(1, ns, d, -(-k // ns), _rows(1, itemsize), _smem(1, ns, itemsize))


def groups(n: int, p: Plan, resident: int) -> tuple[int, int]:
    """(row groups, rows a group) for ``n`` rows at ``resident`` blocks on
    the card at once: as many groups as fill the card once with the plan's
    tiles, and none without a chunk of rows."""
    chunks = -(-n // p.rows)
    g = max(1, min(max(1, resident // p.tiles), chunks))
    per = -(-chunks // g) if chunks else 1
    g = max(1, -(-chunks // per)) if chunks else 1
    return g, per * p.rows


def label_segment_sum_plain(lab: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the rows with a label in
    [0, k) into a float64 table, returned as float32 (one rounding a
    cell)."""
    valid = (lab >= 0) & (lab < k)
    out = torch.zeros((k, y.shape[1]), dtype=torch.float64, device=y.device)
    out.index_add_(0, lab[valid].long(), y[valid].double())
    return out.float()


def _check(lab, y, k):
    if y.dim() != 2 or lab.shape != (y.shape[0],):
        raise ValueError(f"y must be (n, d) and lab (n,); got {tuple(y.shape)}, "
                         f"{tuple(lab.shape)}")
    if k < 1 or y.shape[1] < 1:
        raise ValueError(f"need k >= 1 and d >= 1; got k={k}, d={y.shape[1]}")
    if y.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the segment sum takes float32 or bfloat16 y, got {y.dtype}")
    if lab.dtype != torch.int32:
        raise TypeError(f"lab must be int32; got {lab.dtype}")
    if not (y.is_contiguous() and lab.is_contiguous()):
        raise ValueError("y and lab must be contiguous")


def label_segment_sum(lab: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """(k, d) float32 per-cluster sums of the rows of ``y``; labels < 0 or
    >= k add nothing."""
    k = int(k)
    _check(lab, y, k)
    n, d = y.shape
    probe = kprof.instrumented_kernel(
        "label_segment_sum", y, (k,), lambda: kprof.kernel_cost(
            "label_segment_sum", n=n, d=d, k=k, dtype=str(y.dtype).replace("torch.", "")))
    if y.device.type == "cpu":
        with probe:
            return label_segment_sum_plain(lab, y, k)
    dev = y.device
    if dev.type != "cuda" or lab.device != dev:
        raise ValueError(f"y and lab must share one CUDA device; got {dev}, {lab.device}")
    if k * d >= 1 << 31:
        raise ValueError(f"k * d = {k * d} cells: the kernel's table takes fewer than 2^31")
    p = plan(d, k, y.element_size())
    resident = _resident(dev.index, y.dtype, p)
    g, group_rows = groups(n, p, resident)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = _build.scratch(("seg_sum", dev.index, stream, d, k, p),
                          lambda: _partials(dev, p, max(1, resident // p.tiles)))
    with unfilled():   # the fold writes every cell
        out = torch.empty((k, d), dtype=torch.float32, device=dev)
    fn = _build.bind("seg_sum", _KERNEL_DTYPES[y.dtype], _ARGTYPES)
    with _build.on_device(dev.index), probe:
        err = fn(y.data_ptr(), lab.data_ptr(), n, d, k, p.slice, p.slab, p.rows, g,
                 group_rows, part.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"seg_sum kernel launch failed: cudaError {err} "
                           f"(n={n}, d={d}, k={k}, dtype={y.dtype}, {p}, groups={g})")
    label_segment_sum.launches += 1
    return out


@functools.cache
def _resident(index: int, dtype, p: Plan) -> int:
    """Blocks of the plan's kernel the card holds at once (SMs times its
    resident blocks an SM), asked of the runtime once per (device, plan)."""
    fn = _build.bind("seg_sum", "cdrs_seg_sum_blocks_per_sm", _OCC_ARGTYPES)
    blocks = ctypes.c_int(0)
    with _build.on_device(index):
        err = fn(int(dtype == torch.bfloat16), p.slice, p.slab, p.rows, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"seg_sum occupancy query failed: cudaError {err}, "
                           f"{blocks.value} blocks an SM ({p})")
    return sm_count(index) * blocks.value


def _partials(dev, p: Plan, g: int) -> torch.Tensor:
    """The block tables of ``g`` groups at most (:func:`groups` never gives
    more): every launch writes all that its fold reads."""
    with unfilled():
        return torch.empty(p.tiles * g * p.slab * p.slice, dtype=torch.float32, device=dev)


#: Launches of the CUDA kernel (CPU calls of the plain version do not count).
label_segment_sum.launches = 0
