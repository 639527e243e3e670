"""The per-cluster float sums (``cdrs_tpu_torch/ops/seg_sum.label_segment_sum``)
against the TPU kernel ``label_segment_matmul`` in interpret mode on the CPU.

On a CPU tensor the wrapper runs its plain version (float64 ``index_add_``,
rounded once to float32).  For float ``y`` each cell must lie within
``1e-5 * sum |y| over its rows + 1e-6`` of the reference's (which also meets
the reference test's rtol 1e-5, atol 1e-4); for integer-valued ``y`` it must
be exact.  The reference needs its rows padded to its tile with label -1;
the port takes any row count.  The CUDA path's order is checked here
through its plain replica: the plan's sorted order and pieces at the
shapes the card runs, and ``label_segment_sum_ordered`` (the kernels'
adds in the kernels' order, which the card must match bit for bit)
against the reference within the same tolerance, exactly on integer
sums.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from cdrs_tpu.ops.pallas_kernels import label_segment_matmul, seg_tile  # noqa: E402

from cdrs_tpu_torch.ops import seg_sum  # noqa: E402
from cdrs_tpu_torch.ops.seg_sum import (label_segment_sum,  # noqa: E402
                                        label_segment_sum_ordered, label_segment_sum_plain)


def reference(lab, y, k, tile_rows=None, bf16=False):
    """``label_segment_matmul`` in interpret mode, float32 (or, with
    ``bf16``, bfloat16) on the JAX side (the suite runs JAX with x64 on),
    rows padded with label -1 to the tile."""
    tile = tile_rows or seg_tile(k)
    pad = (-len(lab)) % tile
    lab_p = np.concatenate([lab, np.full(pad, -1, np.int32)])
    y_p = np.concatenate([y, np.zeros((pad, y.shape[1]), np.float32)])
    y_j = jnp.asarray(y_p, dtype=jnp.float32)
    if bf16:
        y_j = y_j.astype(jnp.bfloat16)
    return np.asarray(label_segment_matmul(jnp.asarray(lab_p, dtype=jnp.int32), y_j, k,
                                           tile_rows=tile, interpret=True), dtype=np.float64)


def port(lab, y, k, dtype=torch.float32):
    got = label_segment_sum(torch.from_numpy(lab), torch.from_numpy(y).to(dtype), k)
    assert got.dtype == torch.float32 and got.shape == (k, y.shape[1])
    return got.numpy().astype(np.float64)


def abs_sums(lab, y, k):
    """sum |y| over the rows of each cell, in float64."""
    out = np.zeros((k, y.shape[1]))
    ok = (lab >= 0) & (lab < k)
    np.add.at(out, lab[ok], np.abs(y[ok].astype(np.float64)))
    return out


def assert_close(got, want, lab, y, k):
    tol = 1e-5 * abs_sums(lab, y, k) + 1e-6
    err = np.abs(got - want)
    assert (err <= tol).all(), f"max error {err.max()} over tolerance at {np.argmax(err - tol)}"


def to_bf16_values(y):
    """float32 values exactly representable in bf16 (round to nearest)."""
    return torch.from_numpy(y).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_test_case_uniform_f32(seed):
    """The reference's own test: 2048 x 6, k = 5, labels in [-1, k), tile 512."""
    rng = np.random.default_rng(seed)
    n, d, k = 2048, 6, 5
    lab = rng.integers(-1, k, size=n).astype(np.int32)
    y = rng.uniform(size=(n, d)).astype(np.float32)
    got = port(lab, y, k)
    want = reference(lab, y, k, tile_rows=512)
    assert_close(got, want, lab, y, k)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_odd_row_count_needs_no_padding(seed):
    """3,001 x 7, k = 9: the port takes the rows as they are; the reference
    side is padded with -1 to its tile."""
    rng = np.random.default_rng(10 + seed)
    n, d, k = 3001, 7, 9
    lab = rng.integers(-1, k, size=n).astype(np.int32)
    y = rng.normal(size=(n, d)).astype(np.float32)
    assert n % seg_tile(k)
    assert_close(port(lab, y, k), reference(lab, y, k), lab, y, k)


def test_labels_outside_the_clusters_add_nothing():
    """-1, k, k_pad - 1 and k_pad + 3 (k_pad = 128 at k = 5): the reference
    drops the first and last by its one-hot, the middle two in the padding
    columns it cuts off; the port drops all four."""
    rng = np.random.default_rng(4)
    n, d, k = 1500, 6, 5
    k_pad = 128
    lab = rng.integers(0, k, size=n).astype(np.int32)
    bad = rng.choice(n, size=400, replace=False)
    lab[bad] = np.array([-1, k, k_pad - 1, k_pad + 3], np.int32)[np.arange(400) % 4]
    y = rng.uniform(-1.0, 1.0, size=(n, d)).astype(np.float32)
    y[bad] = 1e6   # large enough to show up if any of them were added
    got = port(lab, y, k)
    want = reference(lab, y, k)
    assert_close(got, want, lab, y, k)
    good = np.setdiff1d(np.arange(n), bad)
    assert_close(got, port(lab[good], np.ascontiguousarray(y[good]), k), lab, y, k)
    assert np.abs(got).max() < 1e3


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_y(seed):
    rng = np.random.default_rng(20 + seed)
    n, d, k = 2500, 9, 6
    lab = rng.integers(-1, k, size=n).astype(np.int32)
    y = to_bf16_values(rng.uniform(-2.0, 2.0, size=(n, d)).astype(np.float32))
    got = port(lab, y, k, dtype=torch.bfloat16)
    assert_close(got, reference(lab, y, k, bf16=True), lab, y, k)


def test_zero_one_bf16_wide_is_exact():
    """0/1 y at 8,192 x 128, k = 1024 in bf16 (the shape of the bisection's
    counting, which the reference's chip test runs at 65,536 rows): the sums
    are counts, exact on both sides."""
    rng = np.random.default_rng(7)
    n, d, k = 8192, 128, 1024
    lab = rng.integers(-1, k, size=n).astype(np.int32)
    y = (rng.random((n, d)) < 0.5).astype(np.float32)
    got = port(lab, y, k, dtype=torch.bfloat16)
    np.testing.assert_array_equal(got, reference(lab, y, k, bf16=True))


@pytest.mark.parametrize("n, d, k", [(1000, 4, 1), (1000, 1, 6), (257, 1, 1)])
def test_one_cluster_or_one_feature(n, d, k):
    rng = np.random.default_rng(n + d + k)
    lab = rng.integers(-1, k, size=n).astype(np.int32)
    y = rng.uniform(size=(n, d)).astype(np.float32)
    assert_close(port(lab, y, k), reference(lab, y, k), lab, y, k)


def test_integer_valued_f32_is_exact():
    rng = np.random.default_rng(8)
    n, d, k = 4000, 5, 8
    lab = rng.integers(-1, k, size=n).astype(np.int32)
    y = rng.integers(-50, 50, size=(n, d)).astype(np.float32)
    np.testing.assert_array_equal(port(lab, y, k), reference(lab, y, k))


def test_empty_cluster_row_is_exactly_zero():
    rng = np.random.default_rng(9)
    n, d, k = 2000, 6, 7
    lab = rng.integers(0, k, size=n).astype(np.int32)
    lab[lab == 3] = 4
    y = rng.normal(size=(n, d)).astype(np.float32)
    got = port(lab, y, k)
    want = reference(lab, y, k)
    assert (got[3] == 0).all() and (want[3] == 0).all()
    assert not np.signbit(got[3]).any()
    assert_close(got, want, lab, y, k)


def test_no_rows_gives_zeros():
    got = label_segment_sum(torch.zeros(0, dtype=torch.int32), torch.zeros((0, 3)), 4)
    assert torch.equal(got, torch.zeros((4, 3)))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_float_types_raise_type_error(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        label_segment_sum(torch.zeros(5, dtype=torch.int32), torch.zeros((5, 2), dtype=dtype),
                          3)


def test_labels_must_be_int32():
    with pytest.raises(TypeError, match="int32"):
        label_segment_sum(torch.zeros(5, dtype=torch.int64), torch.zeros((5, 2)), 3)


@pytest.mark.parametrize("lab_n, y_shape", [(4, (5, 2)), (6, (5, 2)), (5, (5,)),
                                            (5, (5, 2, 1))])
def test_shapes_raise_value_error(lab_n, y_shape):
    with pytest.raises(ValueError, match="y must be"):
        label_segment_sum(torch.zeros(lab_n, dtype=torch.int32), torch.zeros(y_shape), 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wrapper_on_cpu_is_the_plain_version(seed):
    rng = np.random.default_rng(30 + seed)
    lab = torch.from_numpy(rng.integers(-2, 9, size=700).astype(np.int32))
    y = torch.from_numpy(rng.normal(size=(700, 3)).astype(np.float32))
    before = label_segment_sum.launches
    got = label_segment_sum(lab, y, 7)
    assert label_segment_sum.launches == before
    assert torch.equal(got, label_segment_sum_plain(lab, y, 7))
    bf = y.to(torch.bfloat16)
    assert torch.equal(label_segment_sum(lab, bf, 7), label_segment_sum_plain(lab, bf, 7))
    assert label_segment_sum.launches == before


# The shapes smoke phase 2 runs on the card, and odd ones: (n, d, k).
PLAN_SHAPES = [(2048, 6, 5), (65_536, 128, 1024), (2_499_997, 5, 8), (1 << 20, 128, 1024),
               (1 << 20, 32, 65_536), (1_000_000, 4, 20_000), (17_000_000, 128, 1024),
               (3001, 7, 9), (70_001, 300, 33), (100_003, 37, 150), (50_000, 4, 100_000),
               (10, 5000, 1), (0, 3, 4)]


def check_pieces(lab, k, p):
    """The sorted order holds every row with a label in [0, k) once, in
    (cluster, row) order; the pieces tile it, each one cluster's run
    inside one chunk of ``p.piece`` positions, a cluster's pieces
    adjacent."""
    keys, ids, starts, ends = seg_sum.sorted_pieces(torch.from_numpy(lab), k, p)
    keys, ids, starts, ends = keys.numpy(), ids.numpy(), starts.numpy(), ends.numpy()
    valid = np.flatnonzero((lab >= 0) & (lab < k))
    np.testing.assert_array_equal(np.sort(ids), valid)
    np.testing.assert_array_equal(keys, lab[ids])
    order = np.lexsort((ids, keys))
    np.testing.assert_array_equal(order, np.arange(len(ids)))
    if not len(ids):
        assert len(starts) == 0
        return
    assert starts[0] == 0 and ends[-1] == len(ids)
    np.testing.assert_array_equal(starts[1:], ends[:-1])
    assert (ends - starts <= p.piece).all() and (ends > starts).all()
    assert (starts // p.piece == (ends - 1) // p.piece).all()
    assert (keys[starts] == keys[ends - 1]).all()
    first_keys = keys[starts]
    assert (np.diff(first_keys) >= 0).all()   # a cluster's pieces are adjacent
    return starts, ends


@pytest.mark.parametrize("n, d, k", PLAN_SHAPES)
def test_plan_pieces_cover_every_valid_row_once_in_cluster_order(n, d, k):
    p = seg_sum.plan(d, k, n)
    assert p.layout == ("rows" if d < 32 else "cols")
    assert p.piece & (p.piece - 1) == 0 and 32 <= p.piece <= 8192
    assert p.chunks == max(1, -(-n // p.piece))
    assert 8 * p.passes >= (k - 1).bit_length() and p.launches == p.passes + 3
    rng = np.random.default_rng(n % 1000 + d + k)
    lab = rng.integers(-1, k, size=n, dtype=np.int32)
    check_pieces(lab, k, p)


@pytest.mark.parametrize("n", [1000, 100_003, 1 << 20])
def test_plan_pieces_of_a_cluster_holding_every_row(n):
    """Every row in cluster 0 (the smoke's one-cluster row at 1M): one
    piece a chunk, each a whole chunk but the last."""
    p = seg_sum.plan(128, 1024, n)
    starts, ends = check_pieces(np.zeros(n, np.int32), 1024, p)
    assert len(starts) == p.chunks == -(-n // p.piece)
    assert (ends[:-1] - starts[:-1] == p.piece).all()


def test_plan_at_the_smokes_shapes():
    """The lane layout follows d, the passes k, the chunk length n."""
    assert seg_sum.plan(6, 5, 2048) == seg_sum.Plan("rows", 32, 1, 64)
    assert seg_sum.plan(3, 60_000, 200_003).chunks == 3126
    wide = seg_sum.plan(128, 1024, 1 << 20)
    assert (wide.layout, wide.piece, wide.passes, wide.launches) == ("cols", 512, 2, 5)
    assert seg_sum.plan(5, 8, 2_499_997)[:3] == ("rows", 1024, 1)
    assert seg_sum.plan(4, 20_000, 1_000_000)[:3] == ("rows", 256, 2)
    assert seg_sum.plan(3, 60_000, 200_003)[:3] == ("rows", 64, 2)
    assert seg_sum.plan(32, 65_536, 1 << 20)[:3] == ("cols", 512, 2)
    assert seg_sum.plan(31, 1, 10).layout == "rows"
    assert seg_sum.plan(1, 70_000, 10).passes == 3
    assert seg_sum.plan(128, 1024, 17_000_000).piece == 8192


@pytest.mark.parametrize("n, d, k, labels, seed", [
    (2048, 6, 5, "uniform", 0), (2048, 6, 5, "uniform", 1), (3001, 7, 9, "uniform", 2),
    (3001, 7, 9, "skewed", 3), (4000, 40, 6, "skewed", 4), (1500, 6, 5, "outside", 5)])
def test_ordered_version_matches_the_reference(n, d, k, labels, seed):
    """The kernels' order in plain PyTorch against ``label_segment_matmul``
    (interpret mode): the reference's own shape, an odd row count, half the
    rows in one cluster, the "cols" layout (d = 40), labels outside [0, k)."""
    rng = np.random.default_rng(40 + seed)
    lab = rng.integers(-1, k, size=n).astype(np.int32)
    if labels == "skewed":
        lab[rng.random(n) < 0.5] = 2
    elif labels == "outside":
        lab[rng.choice(n, size=300, replace=False)] = np.array([k, 127, 131], np.int32)[
            np.arange(300) % 3]
    y = rng.uniform(-1.0, 1.0, size=(n, d)).astype(np.float32)
    p = seg_sum.plan(d, k, n)
    got = label_segment_sum_ordered(torch.from_numpy(lab), torch.from_numpy(y), k, p)
    assert got.dtype == torch.float32 and got.shape == (k, d)
    assert_close(got.numpy().astype(np.float64), reference(lab, y, k), lab, y, k)


@pytest.mark.parametrize("layout_d, n", [(3, 600_000), (32, 300_000)])
def test_ordered_version_over_long_chunks(layout_d, n):
    """Chunks of 256 and 128 positions (steps that continue a run, steps
    that close it, runs inside a step, clusters over many chunks) against
    the float64 plain version."""
    rng = np.random.default_rng(layout_d)
    k = 37
    lab = np.sort(rng.integers(-1, k, size=n)).astype(np.int32)[rng.permutation(n)]
    lab[: n // 3] = 5
    y = rng.uniform(size=(n, layout_d)).astype(np.float32)
    p = seg_sum.plan(layout_d, k, n)
    assert p.piece >= 128
    got = label_segment_sum_ordered(torch.from_numpy(lab), torch.from_numpy(y), k, p)
    want = label_segment_sum_plain(torch.from_numpy(lab), torch.from_numpy(y), k)
    assert_close(got.numpy().astype(np.float64), want.numpy().astype(np.float64), lab, y, k)


@pytest.mark.parametrize("case", ["integer-rows", "zero-one-bf16-cols", "one-cluster"])
def test_ordered_version_is_exact_on_integer_sums(case):
    rng = np.random.default_rng(11)
    if case == "integer-rows":
        n, d, k = 4000, 5, 8
        lab = rng.integers(-1, k, size=n).astype(np.int32)
        y = torch.from_numpy(rng.integers(-50, 50, size=(n, d)).astype(np.float32))
        want = reference(lab, y.numpy(), k)
    elif case == "zero-one-bf16-cols":
        n, d, k = 8192, 128, 1024
        lab = rng.integers(-1, k, size=n).astype(np.int32)
        y01 = (rng.random((n, d)) < 0.5).astype(np.float32)
        y = torch.from_numpy(y01).to(torch.bfloat16)
        want = reference(lab, y01, k, bf16=True)
    else:
        n, d, k = 5000, 33, 3
        lab = np.zeros(n, np.int32)
        y = torch.from_numpy(rng.integers(0, 4, size=(n, d)).astype(np.float32))
        want = reference(lab, y.numpy(), k)
    got = label_segment_sum_ordered(torch.from_numpy(lab), y, k,
                                    seg_sum.plan(d, k, n))
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)


@pytest.mark.parametrize("n", [0, 2000])
def test_ordered_version_gives_zeros_for_empty_clusters_and_no_rows(n):
    rng = np.random.default_rng(12)
    d, k = 6, 7
    lab = rng.integers(0, k, size=n).astype(np.int32)
    lab[lab == 3] = 4
    y = rng.normal(size=(n, d)).astype(np.float32)
    got = label_segment_sum_ordered(torch.from_numpy(lab), torch.from_numpy(y), k,
                                    seg_sum.plan(d, k, n)).numpy()
    assert (got[3] == 0).all() and not np.signbit(got[3]).any()
    if n == 0:
        assert (got == 0).all()
    else:
        assert_close(got.astype(np.float64), reference(lab, y, k), lab, y, k)


def test_ordered_version_of_labels_all_outside_is_zero():
    lab = torch.full((500,), 9, dtype=torch.int32)
    got = label_segment_sum_ordered(lab, torch.ones((500, 40)), 4, seg_sum.plan(40, 4, 500))
    assert torch.equal(got, torch.zeros((4, 40)))
