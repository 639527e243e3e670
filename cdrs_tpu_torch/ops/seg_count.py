"""Threshold counts, the counting step of the bisection medians.

``label_threshold_count(x, labels, thr, gthr=None)`` returns the (k, 2d)
int32 per-cluster table

    counts[j, r*d + f] = #{ i : labels_i = j and x[i, f] <= thr[r, j, f] }

and, given ``gthr`` of shape (2, d), also the (2, d) int32 global table

    gcounts[r, f] = #{ i : labels_i in [0, k) and x[i, f] <= gthr[r, f] }

from one pass over ``x`` and the labels, as the reference's chunk pass
counts both (``_bisect_core``, ``cdrs_tpu/ops/scoring_jax.py:273-289``).
Labels < 0 or >= k belong to no cluster.

It is the wrapper of the CUDA kernel in ``csrc/seg_count.cu``, which
replaces the TPU kernel ``label_segment_matmul``
(``cdrs_tpu/ops/pallas_kernels.py:534``) applied to the 0/1 matrix its
caller builds, with the caller's global count fused in.  On a CPU tensor
the wrapper runs ``label_threshold_count_plain``; on a CUDA tensor it
launches the kernel or raises.  :func:`plan` picks the kernel's path and
the width of the feature slice a block of the general path counts, so
that the block's table fits in shared memory.  As in ``ops/lloyd.py``,
the ctypes signature is set once, the SM count is read once per device,
and the scratch (the small path's block partials and ticket, the general
path's zeroed accumulator and one ticket a slice, which each launch
leaves zero) is made once per (device, stream, d, k, plan) and reused
(calls on one stream run in order); the tables are fresh per call and
allocated without deterministic mode's NaN fill, since the kernel writes
them in full.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..device import sm_count, unfilled
from ..obs import kprof
from . import _build

__all__ = ["label_threshold_count", "label_threshold_count_plain", "plan", "Plan",
           "slices", "scratch_lengths"]

_KERNEL_DTYPES = {torch.float32: "cdrs_seg_count_f32",
                  torch.bfloat16: "cdrs_seg_count_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

#: A general-path block's dynamic shared memory may not pass this: the
#: H100's 227 KB a block less room for the kernel's static arrays
#: (``kSmemMax`` in ``csrc/seg_count.cu``).
SMEM_MAX = 232_448 - 1_024
#: Warp tiles in flight per warp: the "rows" path's, the others'.
STAGES = {"rows": 4, "pairs": 3, "global": 3}
#: Slice widths of the "pairs" path, widest first.
SLICE_WIDTHS = (8, 4, 2, 1)
_PATH_IDS = {"small": 0, "rows": 1, "pairs": 2, "global": 3}


class Plan(NamedTuple):
    """How the kernel takes a call: ``path`` is "small" (d <= 8, k <= 32:
    the main path's, registers and ballots), "rows" (d <= 8: a lane a row,
    one slice of all d features), "pairs" (a lane a (row, feature) pair
    over slices of ``slice`` features) or "global" (k too large for any
    slice's table in shared memory: global atomics into the output, which
    the wrapper zeroes); ``nslices`` slices of the features; a block's
    dynamic shared memory ``smem`` in bytes (0 on the small path, whose
    kernel sizes its own)."""

    path: str
    slice: int
    nslices: int
    smem: int


def _smem(path: str, s: int, k: int, itemsize: int) -> int:
    """A general-path block's dynamic shared memory, as ``gen_smem`` in
    ``csrc/seg_count.cu`` counts it: 128 bytes of alignment room, its
    warps' staging rings (x tiles and their labels), then the table
    (float2 thresholds, int32 counts and packed 16-bit counts: 20 bytes a
    (cluster, feature) cell)."""
    rows = path == "rows"
    threads = 1024 if rows and s <= 5 else 512
    wr = 32 if rows else 32 * 4 // itemsize
    staging = 128 + threads // 32 * STAGES[path] * (wr * s * itemsize + wr * 4)
    return staging + (0 if path == "global" else 20 * k * s)


def plan(d: int, k: int, itemsize: int = 4) -> Plan:
    """The kernel's path for x of width ``d`` and ``itemsize``-byte
    elements at ``k`` clusters: the small path where it serves, else the
    widest slice whose table fits ``SMEM_MAX`` (all d features on the
    "rows" path when d <= 8), else the global-atomic path."""
    if d <= 8 and k <= 32:
        return Plan("small", d, 1, 0)
    if d <= 8 and _smem("rows", d, k, itemsize) <= SMEM_MAX:
        return Plan("rows", d, 1, _smem("rows", d, k, itemsize))
    for s in SLICE_WIDTHS:
        if s <= d and _smem("pairs", s, k, itemsize) <= SMEM_MAX:
            return Plan("pairs", s, -(-d // s), _smem("pairs", s, k, itemsize))
    return Plan("global", 8, -(-d // 8), _smem("global", 8, k, itemsize))


def slices(d: int, p: Plan) -> list[tuple[int, int]]:
    """The [start, stop) feature ranges of the plan's slices."""
    return [(c * p.slice, min(d, (c + 1) * p.slice)) for c in range(p.nslices)]


def label_threshold_count_plain(x: torch.Tensor, labels: torch.Tensor,
                                thr: torch.Tensor, gthr: torch.Tensor | None = None):
    """Plain PyTorch version, the unfused composition: build ``y`` as the
    JAX reference does (per-row thresholds gathered by label, both ranks
    side by side, compared in float32), then a one-hot segment sum in
    int64 via ``bincount`` over (label, column) keys; the global table
    compares the same rows against ``gthr`` and sums over them."""
    k, d = thr.shape[1], thr.shape[2]
    valid = (labels >= 0) & (labels < k)
    lab = labels[valid].long()
    xv = x[valid].float()
    thr_cat = torch.cat([thr[0], thr[1]], dim=1).float()          # (k, 2d)
    y = torch.cat([xv, xv], dim=1) <= thr_cat[lab]                # (m, 2d)
    keys = lab[:, None] * (2 * d) + torch.arange(2 * d, device=x.device)
    counts = torch.bincount(keys[y], minlength=k * 2 * d).reshape(k, 2 * d).to(torch.int32)
    if gthr is None:
        return counts
    gy = xv[None] <= gthr.float()[:, None, :]                     # (2, m, d)
    return counts, gy.sum(dim=1, dtype=torch.int32)


def _check(x, labels, thr, gthr):
    if x.dim() != 2 or labels.shape != (x.shape[0],):
        raise ValueError(f"x must be (n, d) and labels (n,); got {tuple(x.shape)}, "
                         f"{tuple(labels.shape)}")
    if thr.dim() != 3 or thr.shape[0] != 2 or thr.shape[2] != x.shape[1]:
        raise ValueError(f"thr must be (2, k, d={x.shape[1]}); got {tuple(thr.shape)}")
    if gthr is not None and tuple(gthr.shape) != (2, x.shape[1]):
        raise ValueError(f"gthr must be (2, d={x.shape[1]}); got {tuple(gthr.shape)}")
    if not (x.is_contiguous() and labels.is_contiguous() and thr.is_contiguous()
            and (gthr is None or gthr.is_contiguous())):
        raise ValueError("x, labels, thr and gthr must be contiguous")


def label_threshold_count(x: torch.Tensor, labels: torch.Tensor, thr: torch.Tensor,
                          gthr: torch.Tensor | None = None):
    """(k, 2d) int32 counts, or (counts, (2, d) int32 global counts) when
    ``gthr`` is given; labels < 0 (or >= k) belong to no cluster."""
    _check(x, labels, thr, gthr)
    n, d = x.shape
    k = thr.shape[1]
    probe = kprof.instrumented_kernel(
        "label_threshold_count", x, (k, gthr is not None), lambda: kprof.kernel_cost(
            "label_threshold_count", n=n, d=d, k=k, dtype=str(x.dtype).replace("torch.", ""),
            with_global=gthr is not None))
    if x.device.type == "cpu":
        with probe:
            return label_threshold_count_plain(x, labels, thr, gthr)
    dev = x.device
    if dev.type != "cuda" or labels.device != dev or thr.device != dev or (
            gthr is not None and gthr.device != dev):
        raise ValueError("x, labels, thr and gthr must share one CUDA device; got "
                         f"{dev}, {labels.device}, {thr.device}, "
                         f"{None if gthr is None else gthr.device}")
    fn_name = _KERNEL_DTYPES.get(x.dtype)
    if fn_name is None:
        raise TypeError(f"the counting kernel takes float32 or bfloat16 x, got {x.dtype}")
    if labels.dtype != torch.int32 or thr.dtype != torch.float32 or (
            gthr is not None and gthr.dtype != torch.float32):
        raise TypeError(f"labels must be int32 and thr, gthr float32; got {labels.dtype}, "
                        f"{thr.dtype}, {None if gthr is None else gthr.dtype}")
    cells = k * 2 * d + (2 * d if gthr is not None else 0)
    sms = sm_count(dev.index)
    p = plan(d, k, x.element_size())
    # The small path keeps at most two blocks on an SM; the general path
    # takes one ticket a slice.
    nb = 2 * sms if p.path == "small" else p.nslices
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, ticket = _build.scratch(("seg_count", dev.index, stream, d, k, p),
                                  lambda: _make_scratch(dev, p, nb, d, k))
    if p.path == "global":   # counted straight into the output
        out = torch.zeros(cells, dtype=torch.int32, device=dev)
    else:
        with unfilled():   # the kernel writes both tables in full
            out = torch.empty(cells, dtype=torch.int32, device=dev)
    fn = _build.bind("seg_count", fn_name, _ARGTYPES)
    with _build.on_device(dev.index), probe:
        err = fn(x.data_ptr(), labels.data_ptr(), thr.data_ptr(),
                 gthr.data_ptr() if gthr is not None else None, n, d, k, out.data_ptr(),
                 part.data_ptr(), ticket.data_ptr(), nb, sms, _PATH_IDS[p.path], p.slice,
                 stream)
    if err != 0:
        raise RuntimeError(f"seg_count kernel launch failed: cudaError {err} "
                           f"(n={n}, d={d}, k={k}, dtype={x.dtype}, {p})")
    label_threshold_count.launches += 1
    counts = out[:k * 2 * d].view(k, 2 * d)
    if gthr is None:
        return counts
    return counts, out[k * 2 * d:].view(2, d)


def scratch_lengths(p: Plan, nb: int, d: int, k: int) -> tuple[int, int]:
    """(int32 elements of ``part``, of the tickets) a call of plan ``p``
    needs: the small path's block partials (written in full by each
    launch, with or without the global table) and its one ticket, the
    rows and pairs paths' accumulator of both tables and one ticket a
    slice, or nothing (one element each) on the global path."""
    cells = 2 * k * d + 2 * d
    if p.path == "small":
        return nb * cells, 1
    return (cells, p.nslices) if p.path != "global" else (1, 1)


def _make_scratch(dev, p: Plan, nb: int, d: int, k: int):
    """The partials or accumulator, and the tickets; all that a launch
    finds zero is made zero here, and each launch leaves it so."""
    n_part, n_ticket = scratch_lengths(p, nb, d, k)
    if p.path == "small":
        with unfilled():
            part = torch.empty(n_part, dtype=torch.int32, device=dev)
    else:
        part = torch.zeros(n_part, dtype=torch.int32, device=dev)
    return part, torch.zeros(n_ticket, dtype=torch.int32, device=dev)


#: Launches of the CUDA kernel (CPU calls of the plain version do not count).
label_threshold_count.launches = 0
