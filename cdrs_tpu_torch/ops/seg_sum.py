"""Per-cluster float sums: the general form of B2.

``label_segment_sum(lab, y, k)`` returns the (k, d) float32 table

    sums[j, f] = sum of y[i, f] over the rows i with lab_i = j

for any float ``y`` (float32 or bfloat16, accumulated in float32); a label
< 0 or >= k adds nothing.  It is the counterpart of the TPU kernel
``label_segment_matmul`` (``cdrs_tpu/ops/pallas_kernels.py:534``) without
its tile argument: ``n`` is any row count, with no padding.  The name
drops "matmul" because the kernel is not a one-hot product: the TPU
builds a (tile, k) one-hot block and reduces it on the MXU, while the
CUDA kernel (``csrc/seg_sum.cu``) sorts the rows into cluster order and
sums each cluster's rows as a stream.  The reference also drops a label
in ``[k, k_pad)``, which lands in a padding column its ``sums[:k]`` cuts
off; here such a label is simply outside ``[0, k)``.

The CUDA call, in launch order: a histogram of every 8-bit digit of the
valid labels; one stable counting-sort pass a digit (``passes``: one for
k <= 256, two for k <= 65,536, ...), which leaves the valid rows' ids in
(cluster, row) order; the sums; the fold.  The sorted order is cut into
chunks of ``piece`` positions, and a piece is a cluster's run inside one
chunk, so no piece holds more than ``piece`` rows.  A warp sums a chunk
(a column block of it where d is wide) in one of two lane layouts, fixed
by d alone: "rows" (d < 32: a lane a position, 32 positions a step, each
lane's running sums of the open run joined by a shuffle tree, runs inside
a step by a segmented scan over the lanes) or "cols" (a row a step, lanes
across features, a running sum a lane).  A cluster with one piece writes
its output row directly; the pieces of a longer cluster are adjacent, and
the fold adds their partials in piece order.
:func:`label_segment_sum_ordered` sums in exactly that order in plain
PyTorch, so the card's bits can be checked.

On a CPU tensor the wrapper runs ``label_segment_sum_plain``; on a CUDA
tensor it launches the kernels or raises.  As in ``ops/seg_count.py``, the
ctypes signature is set once.  The scratch (the sort's histograms,
look-back words, keys and ids twice, the chunks' chain heads and
partials) is one buffer whose layout the CUDA source owns: it is sized by
asking the library (``cdrs_seg_sum_scratch_bytes``) at a row capacity, a
power of two, made once per (device, stream, d, passes, capacity) and
reused (calls on one stream run in order; each call leaves the histograms
zero for the next), and the launch refuses a buffer smaller than the call
needs.  The output and the k-long record of where chains end are fresh
per call and allocated without deterministic mode's NaN fill, since the
kernels write every cell of the one and read only what they wrote of the
other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..device import unfilled
from ..obs import kprof
from . import _build

__all__ = ["label_segment_sum", "label_segment_sum_plain", "label_segment_sum_ordered",
           "plan", "Plan", "sorted_pieces"]

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3)
_SCRATCH_ARGTYPES = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]

#: Bits a counting-sort pass.
DIGIT_BITS = 8
#: The "rows" layout below this width (a lane holds d running sums).
ROWS_BELOW = 32
#: Positions a chunk: a power of two in [PIECE_MIN, PIECE_MAX], the largest
#: that still cuts the rows into TARGET_CHUNKS chunks (enough warps to keep
#: the card's 132 SMs reading; few enough that a cluster holding every row
#: folds a few thousand partials at most).
PIECE_MIN = 32
PIECE_MAX = 8192
TARGET_CHUNKS = 2048


class Plan(NamedTuple):
    """How the kernels take a call: ``passes`` counting-sort passes, the
    sorted order cut into ``chunks`` chunks of ``piece`` positions, the
    sums in the ``layout`` "rows" (32 positions a step) or "cols" (a row a
    step), and ``launches`` kernels a call (a histogram, the passes, the
    sums, the fold)."""

    layout: str
    piece: int
    passes: int
    chunks: int

    @property
    def launches(self) -> int:
        return self.passes + 3


def _passes(k: int) -> int:
    return max(1, -(-(k - 1).bit_length() // DIGIT_BITS))


def _piece(n: int) -> int:
    per = max(1, n // TARGET_CHUNKS)
    return min(PIECE_MAX, max(PIECE_MIN, 1 << (per.bit_length() - 1)))


def plan(d: int, k: int, n: int) -> Plan:
    """The plan of a call on ``n`` rows of ``d`` features in clusters
    [0, k): the lane layout depends on d alone (y's dtype sets only the
    loads' width), the passes on k, the chunk length on n."""
    p = _piece(n)
    return Plan("rows" if d < ROWS_BELOW else "cols", p, _passes(k), max(1, -(-n // p)))


def label_segment_sum_plain(lab: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the rows with a label in
    [0, k) into a float64 table, returned as float32 (one rounding a
    cell)."""
    valid = (lab >= 0) & (lab < k)
    out = torch.zeros((k, y.shape[1]), dtype=torch.float64, device=y.device)
    out.index_add_(0, lab[valid].long(), y[valid].double())
    return out.float()


def sorted_pieces(lab: torch.Tensor, k: int, p: Plan):
    """The kernels' sorted order and pieces, in plain PyTorch: (keys, ids,
    starts, ends), where ``ids`` are the rows with a label in [0, k) in
    (cluster, row) order, ``keys`` their labels, and the pieces are the
    runs of one key inside one chunk of ``p.piece`` positions, in order,
    as position ranges [starts, ends)."""
    idx = torch.nonzero((lab >= 0) & (lab < k)).flatten()
    keys, order = torch.sort(lab[idx].long(), stable=True)
    ids = idx[order]
    nv = keys.numel()
    pos = torch.arange(nv, device=lab.device)
    first = torch.ones(nv, dtype=torch.bool, device=lab.device)
    if nv:
        first[1:] = (keys[1:] != keys[:-1]) | (pos[1:] % p.piece == 0)
    starts = pos[first]
    ends = torch.cat([starts[1:], torch.tensor([nv], device=lab.device)]) if nv else starts
    return keys, ids, starts, ends


def _tree(a: torch.Tensor) -> torch.Tensor:
    """(m, 32, d) -> (m, d): lane 0 of the shuffle tree ``t[l] += t[l + o]``
    for o = 16, 8, 4, 2, 1."""
    for o in (16, 8, 4, 2, 1):
        a = a[:, :o] + a[:, o:2 * o]
    return a[:, 0]


def label_segment_sum_ordered(lab: torch.Tensor, y: torch.Tensor, k: int,
                              p: Plan) -> torch.Tensor:
    """The kernels' sums in plain PyTorch, float32 add by float32 add in
    the kernels' order, so that the card's result can be held to it bit
    for bit.  The rows in stable (cluster, row) order are cut into chunks
    of ``p.piece`` positions, each summed alone.  Layout "rows": 32
    positions a step, a lane a position; each lane keeps running sums of
    the run still open; a step whose 32 keys all continue it adds each
    lane's row; any other step closes it (its lanes of the step added,
    then the shuffle tree), takes each run that begins and ends inside the
    step from a segmented inclusive scan over the lanes (``v[l] = v[l - o]
    + v[l]`` for o = 1, 2, 4, 8, 16 where both lanes hold one key), and
    opens the run at lane 31.  Layout "cols": a running sum a chunk, row
    by row.  Then each cluster's pieces (its runs, one a chunk) are added
    in chunk order, the first as it is.  Tests and the smoke use it; the
    CUDA path never does."""
    d = y.shape[1]
    dev = y.device
    out = torch.zeros((k, d), dtype=torch.float32, device=dev)
    keys, ids, _, _ = sorted_pieces(lab, k, p)
    nv = keys.numel()
    if nv == 0:
        return out
    P, R = p.piece, 32 if p.layout == "rows" else 1
    C = -(-nv // P)
    pad = C * P - nv
    sk = torch.cat([keys, torch.full((pad,), -1, dtype=keys.dtype, device=dev)]).view(C, P // R, R)
    raw = torch.cat([y[ids].float(), torch.zeros((pad, d), device=dev)]).view(C, P // R, R, d)
    chunk = torch.arange(C, device=dev)
    rec_c, rec_k, rec_v = [], [], []

    def emit(c, key, val):
        rec_c.append(c)
        rec_k.append(key)
        rec_v.append(val)

    ck = torch.full((C,), -2, dtype=sk.dtype, device=dev)
    if R == 32:
        sc = raw
        for o in (1, 2, 4, 8, 16):   # the segmented scan of every step at once
            up_k = torch.full_like(sk, -2)
            up_k[..., o:] = sk[..., :-o]
            up_v = torch.zeros_like(sc)
            up_v[..., o:, :] = sc[..., :-o, :]
            sc = torch.where((up_k == sk).unsqueeze(-1), up_v + sc, sc)
        acc = torch.zeros((C, 32, d), device=dev)
        for s in range(P // 32):
            kk, rv, sv = sk[:, s], raw[:, s], sc[:, s]
            inrun = (kk == ck[:, None]).unsqueeze(-1)
            uni = (kk == ck[:, None]).all(1) & (ck >= 0)
            mix = ~uni
            close = mix & (ck >= 0)
            emit(chunk[close], ck[close], _tree(torch.where(inrun, acc + rv, acc)[close]))
            ci, li = torch.nonzero(mix[:, None] & (kk[:, :-1] >= 0) & (kk[:, :-1] != ck[:, None])
                                   & (kk[:, :-1] != kk[:, 1:]), as_tuple=True)
            emit(ci, kk[ci, li], sv[ci, li])
            k31 = kk[:, -1]
            opened = torch.where((kk == k31[:, None]).unsqueeze(-1), rv, torch.zeros_like(rv))
            acc = torch.where(uni[:, None, None], acc + rv, torch.where(mix[:, None, None],
                                                                       opened, acc))
            ck = torch.where(mix, k31, ck)
        done = ck >= 0
        emit(chunk[done], ck[done], _tree(acc[done]))
    else:
        acc = torch.zeros((C, d), device=dev)
        for s in range(P):
            kk, rv = sk[:, s, 0], raw[:, s, 0]
            same = kk == ck
            done = ~same & (ck >= 0)
            emit(chunk[done], ck[done], acc[done])
            acc = torch.where(same[:, None], acc + rv, rv)
            ck = kk
        done = ck >= 0
        emit(chunk[done], ck[done], acc[done])
    rc, rk, rv = torch.cat(rec_c), torch.cat(rec_k), torch.cat(rec_v)
    order = torch.argsort(rk * C + rc)
    rk, rv = rk[order], rv[order]
    m = rk.numel()
    first = torch.ones(m, dtype=torch.bool, device=dev)
    first[1:] = rk[1:] != rk[:-1]
    at = torch.arange(m, device=dev)
    rank = at - torch.cummax(torch.where(first, at, 0), 0).values
    out[rk[first]] = rv[first]
    for q in range(1, int(rank.max()) + 1):
        sel = rank == q
        out[rk[sel]] = out[rk[sel]] + rv[sel]
    return out


def _check(lab, y, k):
    if y.dim() != 2 or lab.shape != (y.shape[0],):
        raise ValueError(f"y must be (n, d) and lab (n,); got {tuple(y.shape)}, "
                         f"{tuple(lab.shape)}")
    if k < 1 or y.shape[1] < 1:
        raise ValueError(f"need k >= 1 and d >= 1; got k={k}, d={y.shape[1]}")
    if y.dtype not in (torch.float32, torch.bfloat16):
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
        raise ValueError(f"k * d = {k * d} cells: the kernels take fewer than 2^31")
    if n >= 1 << 31:
        raise ValueError(f"n = {n} rows: the sort's row ids are int32")
    p = plan(d, k, n)
    cap = 1 << max(n - 1, 0).bit_length()
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = ("seg_sum", dev.index, stream, d, p.passes, cap)
    scratch = _build.scratch(key, lambda: _scratch(dev, d, p.passes, cap))
    with unfilled():   # the sums, the fold and the zero rows write every cell
        out = torch.empty((k, d), dtype=torch.float32, device=dev)
        ends = torch.empty(k, dtype=torch.int32, device=dev)   # read only where written
    fn = _build.bind("seg_sum", "cdrs_seg_sum", _ARGTYPES)
    with _build.on_device(dev.index), probe:
        err = fn(y.data_ptr(), int(y.dtype == torch.bfloat16), lab.data_ptr(), n, d, k,
                 p.piece, p.passes, scratch.data_ptr(), scratch.numel(), ends.data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        _build.drop_scratch(key)   # a chain cut short may leave its histograms unzeroed
        raise RuntimeError(f"seg_sum kernel launch failed: cudaError {err} "
                           f"(n={n}, d={d}, k={k}, dtype={y.dtype}, {p})")
    label_segment_sum.launches += 1
    return out


def _scratch(dev, d: int, passes: int, cap: int) -> torch.Tensor:
    """The scratch of every call of up to ``cap`` rows (``cap`` a power of
    two, so such a call has more than ``cap / 2``): the library's size at
    ``cap`` rows and the shortest chunk those calls have, zero (the
    counters must start so; the kernels zero the rest as they need)."""
    size = _build.bind("seg_sum", "cdrs_seg_sum_scratch_bytes", _SCRATCH_ARGTYPES,
                       restype=ctypes.c_int64)
    nbytes = size(cap, d, _piece(cap // 2 + 1), passes)
    if nbytes < 0:
        raise ValueError(f"seg_sum scratch: the library refuses {cap} rows, d={d}, "
                         f"{passes} passes")
    return torch.zeros(nbytes, dtype=torch.uint8, device=dev)


#: Calls that launched the CUDA kernels (CPU calls of the plain version do not count).
label_segment_sum.launches = 0
