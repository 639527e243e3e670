"""The numerics of B1's general paths, emulated on the CPU.

The CUDA kernel's general paths (d > 8 or k > 16: wgmma in
``csrc/lloyd_wgmma.cuh``, mma.sync in ``csrc/lloyd.cu``) take ``x.c`` for
f32 points on the tensor cores as three TF32 products: each operand is
split as hi = rna_tf32(v), lo = rna_tf32(v - hi), and x.c = lo.hi' +
hi.lo' + hi.hi', a k-step of 8 features at a time: each step adds the
three products' sums over its 8 features into one f32 accumulator, in
that order.  The kernel runs only on the card (``chip_smoke.py`` phase 2
holds it against the plain version there).  Here a torch helper rounds
f32 to TF32 by integer ops on the bits (to nearest, ties away from zero,
10 stored mantissa bits, as ``cvt.rna.tf32.f32``) and forms the same
products in the same order, each step's sum of 8 exact products rounded
once into the f32 accumulator.  The labels under
that product are held against ``lloyd_assign_reduce_pallas_t`` in interpret
mode and against the plain version: identical except on distance ties
within 1e-6 relative in f64, as ``tests/test_torch_lloyd.py`` holds them.
Rows built to sit on near-ties show the source note's error bound,
|dot - x.c| <= (2^-20 + 3 d 2^-23) sum_f |x_f c_f| (2^-20 for the split
alone), that one TF32 product breaks it, and that a label moves only where
two distances lie within the sum of their errors (twice the bound each).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from cdrs_tpu.ops.pallas_kernels import lloyd_assign_reduce_pallas_t  # noqa: E402

from cdrs_tpu_torch.ops.lloyd import centroid_operands, lloyd_assign_reduce_plain  # noqa: E402

SPLIT_BOUND = 2.0 ** -20       # the three products against x.c, per term


def accumulate_bound(d: int) -> float:
    """The source note's bound with the f32 additions of 3 d products."""
    return SPLIT_BOUND + 3 * d * 2.0 ** -23


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: add half a unit of the 13 dropped bits to the
    magnitude's bit pattern, then clear them (round to nearest, ties away)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def split_terms(x: torch.Tensor, c: torch.Tensor):
    """The kernel's three products (n, k) in f64, where each is exact: a
    product of TF32 values fits in f32, and f64 adds d of them exactly
    enough (d 2^-53) for every bound here."""
    xh, xl = (t.double() for t in split(x))
    ch, cl = (t.double() for t in split(c))
    return xl @ ch.T, xh @ cl.T, xh @ ch.T


def kstep_dot(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, k) f32 accumulators as the kernel forms them: for each k-step of
    8 features (the last one zero-padded), lo.hi', hi.lo', hi.hi' in that
    order, each step's sum of 8 products (exact in f64) added into the f32
    accumulator with one rounding."""
    xh, xl = split(x)
    ch, cl = split(c)
    acc = torch.zeros((x.shape[0], c.shape[0]), dtype=torch.float32)
    for f0 in range(0, x.shape[1], 8):
        sl = slice(f0, f0 + 8)
        for a, b in ((xl, ch), (xh, cl), (xh, ch)):
            acc = (acc.double() + a[:, sl].double() @ b[:, sl].double().T).float()
    return acc


def split_labels(x: torch.Tensor, c_used: torch.Tensor, csq: torch.Tensor) -> np.ndarray:
    """First argmin of |c|^2 - 2 dot in f32, dot the split product held in an
    f32 accumulator k-step by k-step, as the kernel ranks."""
    return torch.argmin(csq[None, :] - 2.0 * kstep_dot(x, c_used), dim=1).numpy()


def assert_labels_match(x, c_used, got, want, rtol=1e-6):
    """Identical labels, except where both picks are equally near (f64)."""
    diff = np.nonzero(got != want)[0]
    if diff.size:
        xd = x[diff].astype(np.float64)
        dg = ((xd - c_used[got[diff]]) ** 2).sum(1)
        dw = ((xd - c_used[want[diff]]) ** 2).sum(1)
        np.testing.assert_allclose(dg, dw, rtol=rtol)
    assert diff.size <= max(1, got.size // 1000)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(11)
    v = (rng.normal(size=20000) * np.exp2(rng.integers(-20, 20, 20000))).astype(np.float32)
    # Exact ties: 12 significant bits with the last one set round away.
    ties = (np.float32(1.0) + np.float32(2.0 ** -11)) * np.array([1, -1, 4.0, -0.25],
                                                                 np.float32)
    v = np.concatenate([v, ties.astype(np.float32)])
    got = tf32_rna(torch.from_numpy(v)).numpy().astype(np.float64)
    a = np.abs(v.astype(np.float64))
    s = 10 - np.floor(np.log2(a))            # |v| 2^s in [2^10, 2^11)
    want = np.sign(v) * np.floor(a * 2.0 ** s + 0.5) / 2.0 ** s
    np.testing.assert_array_equal(got, want)
    assert (got[-4:] == np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 4 * (1 + 2.0 ** -10),
                                  -0.25 * (1 + 2.0 ** -10)])).all()
    hi, lo = split(torch.from_numpy(v))
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()   # 10 stored bits
    resid = np.abs(v.astype(np.float64) - hi.double().numpy() - lo.double().numpy())
    assert (np.abs(v - hi.numpy()) <= 2.0 ** -11 * np.abs(v)).all()
    assert (resid <= 2.0 ** -22 * np.abs(v)).all()


@pytest.mark.parametrize("n,d,k,n_valid", [
    (2048, 5, 64, 2001),       # entry()'s k at the pipeline's width
    (2048, 32, 128, 1999),     # reference config 2's width
    (1024, 128, 1024, 1000),   # reference config 3's width
])
def test_split_product_labels_match_pallas_and_plain(n, d, k, n_valid):
    rng = np.random.default_rng(15)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[n_valid:] = 0.0                      # the TPU kernel's zero-pad contract
    c = (0.9 * rng.normal(size=(k, d))).astype(np.float32)
    lab_j, sums_j, cnt_j = lloyd_assign_reduce_pallas_t(
        jnp.asarray(x).T, jnp.asarray(c), n_valid=n_valid, interpret=True, tile_cols=1024)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    lab_p, sums_p, cnt_p = lloyd_assign_reduce_plain(xt, ct, n_valid)
    c_used, csq = centroid_operands(ct, xt.dtype)
    got = split_labels(xt, c_used, csq)
    cu = c_used.double().numpy()
    assert_labels_match(x[:n_valid], cu, got[:n_valid], np.asarray(lab_j)[:n_valid])
    assert_labels_match(x, cu, got, lab_p.numpy())
    # The sums and counts that follow from these labels are the TPU kernel's.
    onehot = np.zeros((n_valid, k))
    onehot[np.arange(n_valid), got[:n_valid]] = 1.0
    if (got[:n_valid] == np.asarray(lab_j)[:n_valid]).all():
        np.testing.assert_allclose(onehot.T @ x[:n_valid], np.asarray(sums_j), atol=1e-3)
        np.testing.assert_array_equal(onehot.sum(0), np.asarray(cnt_j))


def _near_tie_rows(rng, d: int, n: int):
    """Two centroids with full 24-bit mantissas and rows at their midpoint,
    moved along random directions by 1e-8 to 1e-2 of their size: the rows
    nearest the tie sit inside the ranking's error, the farthest outside."""
    c = (rng.normal(size=(2, d)) * (1 + rng.random((2, d)))).astype(np.float32)
    mid = (c[0].astype(np.float64) + c[1]) / 2
    eps = 10.0 ** rng.uniform(-8, -2, size=(n, 1))
    x = (mid[None, :] * (1 + eps * rng.normal(size=(n, d)))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(c)


@pytest.mark.parametrize("d", [5, 32, 128])
def test_split_product_error_bound_on_near_tie_rows(d):
    rng = np.random.default_rng(100 + d)
    x, c = _near_tie_rows(rng, d, 4096)
    xd, cd = x.double(), c.double()
    exact = xd @ cd.T
    scale = xd.abs() @ cd.abs().T            # sum_f |x_f c_f|
    terms = split_terms(x, c)
    # The three products against x.c: within 2^-20, by a margin.
    split_err = float(((sum(terms) - exact).abs() / scale).max())
    assert split_err <= SPLIT_BOUND
    # One TF32 product (hi.hi') is off by about 2^-11: the split is needed.
    assert float(((terms[2] - exact).abs() / scale).max()) > 16 * SPLIT_BOUND
    # The products added into an f32 accumulator in the kernel's order, a
    # k-step of 8 features at a time (lo.hi', hi.lo', hi.hi'): within the
    # full bound, and so is the coarser model of 3 d roundings, one a
    # product, feature by feature.
    acc = kstep_dot(x, c)
    acc_err = (acc.double() - exact).abs() / scale
    assert float(acc_err.max()) <= accumulate_bound(d)
    xh, xl = split(x)
    ch, cl = split(c)
    fine = torch.zeros((x.shape[0], 2), dtype=torch.float32)
    for f in range(d):
        for a, b in ((xl, ch), (xh, cl), (xh, ch)):
            fine = fine + a[:, f, None] * b[None, :, f]    # each product exact in f32
    assert float(((fine.double() - exact).abs() / scale).max()) <= accumulate_bound(d)
    # A label moves only where the two exact distances lie within the sum
    # of their errors: each distance |c|^2 - 2 dot carries twice its
    # product's error, plus the f32 roundings of |c|^2 - 2 dot itself.
    _, csq = centroid_operands(c, x.dtype)
    got = torch.argmin(csq[None, :] - 2.0 * acc, dim=1)
    dist = csq.double()[None, :] - 2.0 * exact
    want = torch.argmin(dist, dim=1)
    gap = (dist[:, 0] - dist[:, 1]).abs()
    room = (4 * accumulate_bound(d) * scale.max(dim=1).values
            + 4 * 2.0 ** -24 * (csq.double().max() + 2 * exact.abs().max(dim=1).values))
    moved = got != want
    assert bool((gap[moved] <= room[moved]).all())
    near = float((gap <= room).double().mean())
    assert 0.05 < near < 0.95 and bool(moved.any())   # both kinds of row are there
