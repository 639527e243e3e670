"""Operations and bytes of the program's kernels from their shapes, and the
card's peaks: the yardstick of the roofline metrics.

Each input byte is counted once and each output byte once, whatever a
kernel reads again; operations come from the shapes.  f32 products are
counted against the tensor cores' TF32 rate over three, because an
f32-accurate product on them is three TF32 products (high and low parts);
the 67 TFLOP/s of the CUDA cores would let a tensor-core kernel read past
100%.
"""

from __future__ import annotations

#: Per-card peaks (NVIDIA's data sheet, H100 SXM5, dense, at 700 W): HBM
#: bytes/s and operations/s by the operands' type.
DEVICE_PEAKS: dict[str, dict] = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "ops_per_s": {"float32": 495e12 / 3, "bfloat16": 989e12}},
}


def peaks(device_name: str, dtype: str = "float32"):
    """(operations/s, bytes/s) of a card named as ``torch.cuda.get_device_name()``
    names it, or None for a card the table does not hold."""
    p = DEVICE_PEAKS.get(device_name)
    if p is None or dtype not in p["ops_per_s"]:
        return None
    return p["ops_per_s"][dtype], p["bytes_per_s"]


def _esize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def lloyd_cost(n: int, d: int, k: int, dtype: str = "float32", with_labels: bool = False,
               n_valid: int | None = None) -> tuple[float, float]:
    """(operations, bytes) of one B1 call: x read once, the labels written
    when asked, centroids and |c|^2 read and sums and counts written (eight
    bytes a value in all); ``2 n k d`` operations for the distances and
    ``n_valid d`` for the sums."""
    n_valid = n if n_valid is None else int(n_valid)
    n_bytes = n * d * _esize(dtype) + (n * 4 if with_labels else 0) + k * d * 8 + k * 8
    return 2.0 * n * k * d + n_valid * d, float(n_bytes)


def seg_count_cost(n: int, d: int, k: int, dtype: str = "float32",
                   with_global: bool = True) -> tuple[float, float]:
    """(operations, bytes) of one B2 call: x and the int32 labels read once,
    both threshold tables read and both count tables written ((2 k d + 2 d)
    cells of four bytes each way, without the global 2 d when
    ``with_global`` is false); four compares an element with the global
    table, two without."""
    g_cells = 2 * d if with_global else 0
    n_bytes = n * d * _esize(dtype) + n * 4 + (2 * k * d + g_cells) * 4 * 2
    return (4.0 if with_global else 2.0) * n * d, float(n_bytes)


def bound_seconds(ops: float, n_bytes: float, pk) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate."""
    return max(ops / pk[0], n_bytes / pk[1])
