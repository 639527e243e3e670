"""Per-cluster threshold counts, the counting step of the bisection medians.

``label_threshold_count(x, labels, thr)`` returns the (k, 2d) int32 table

    counts[j, r*d + f] = #{ i : labels_i = j and x[i, f] <= thr[r, j, f] }

It is the wrapper of the CUDA kernel in ``csrc/seg_count.cu``, which
replaces the TPU kernel ``label_segment_matmul``
(``cdrs_tpu/ops/pallas_kernels.py:534``) applied to the 0/1 matrix its
caller ``_bisect_core`` (``cdrs_tpu/ops/scoring_jax.py:273-288``) builds.
On a CPU tensor the wrapper runs ``label_threshold_count_plain``; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["label_threshold_count", "label_threshold_count_plain"]

_KERNEL_DTYPES = {torch.float32: "cdrs_seg_count_f32",
                  torch.bfloat16: "cdrs_seg_count_bf16"}


def label_threshold_count_plain(x: torch.Tensor, labels: torch.Tensor,
                                thr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, the unfused composition: build ``y`` as the
    JAX reference does (per-row thresholds gathered by label, both ranks
    side by side, compared in float32), then a one-hot segment sum in
    int64 via ``bincount`` over (label, column) keys."""
    k, d = thr.shape[1], thr.shape[2]
    valid = (labels >= 0) & (labels < k)
    lab = labels[valid].long()
    thr_cat = torch.cat([thr[0], thr[1]], dim=1).float()          # (k, 2d)
    xx = torch.cat([x[valid], x[valid]], dim=1).float()           # (m, 2d)
    y = xx <= thr_cat[lab]
    keys = lab[:, None] * (2 * d) + torch.arange(2 * d, device=x.device)
    counts = torch.bincount(keys[y], minlength=k * 2 * d)
    return counts.reshape(k, 2 * d).to(torch.int32)


def _check(x, labels, thr):
    if x.dim() != 2 or labels.shape != (x.shape[0],):
        raise ValueError(f"x must be (n, d) and labels (n,); got {tuple(x.shape)}, "
                         f"{tuple(labels.shape)}")
    if thr.dim() != 3 or thr.shape[0] != 2 or thr.shape[2] != x.shape[1]:
        raise ValueError(f"thr must be (2, k, d={x.shape[1]}); got {tuple(thr.shape)}")
    if not (x.is_contiguous() and labels.is_contiguous() and thr.is_contiguous()):
        raise ValueError("x, labels and thr must be contiguous")


def label_threshold_count(x: torch.Tensor, labels: torch.Tensor,
                          thr: torch.Tensor) -> torch.Tensor:
    """(k, 2d) int32 counts; labels < 0 (or >= k) belong to no cluster."""
    _check(x, labels, thr)
    if x.device.type == "cpu":
        return label_threshold_count_plain(x, labels, thr)
    if x.device.type != "cuda" or labels.device != x.device or thr.device != x.device:
        raise ValueError("x, labels and thr must share one CUDA device; got "
                         f"{x.device}, {labels.device}, {thr.device}")
    fn_name = _KERNEL_DTYPES.get(x.dtype)
    if fn_name is None:
        raise TypeError(f"the counting kernel takes float32 or bfloat16 x, got {x.dtype}")
    if labels.dtype != torch.int32 or thr.dtype != torch.float32:
        raise TypeError(f"labels must be int32 and thr float32; got {labels.dtype}, "
                        f"{thr.dtype}")
    n, d = x.shape
    k = thr.shape[1]
    out = torch.empty((k, 2 * d), dtype=torch.int32, device=x.device)
    nb = max(1, min(2 * torch.cuda.get_device_properties(x.device).multi_processor_count,
                    -(-n * d // 256)))
    fn = getattr(_build.load("seg_count"), fn_name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), labels.data_ptr(), thr.data_ptr(), n, d, k,
                 out.data_ptr(), nb, stream)
    if err != 0:
        raise RuntimeError(f"seg_count kernel launch failed: cudaError {err} "
                           f"(n={n}, d={d}, k={k}, dtype={x.dtype})")
    label_threshold_count.launches += 1
    return out


#: Launches of the CUDA kernel (CPU calls of the plain version do not count).
label_threshold_count.launches = 0
