"""The port's mesh (``cdrs_tpu_torch.parallel.mesh``) against
``cdrs_tpu.parallel.mesh``: the shape validation and its messages,
``pad_rows``, ``prefix_mask``, ``collective_bytes_estimate``, the placement
rule, and the collectives.  The shard-ordered psum gives the same bits at
data = 1, 2, 4 and 8 over the same partials; integer sums and extremes are
exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
from cdrs_tpu.parallel import mesh as ref_mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from cdrs_tpu_torch.parallel import mesh as M  # noqa: E402


@pytest.mark.parametrize("shape", [None, {}, {"data": 8}, {"data": "4", "model": 2},
                                   {"model": 3}])
def test_validate_matches_reference(shape):
    assert M.validate_mesh_shape(shape) == ref_mesh.validate_mesh_shape(shape)


@pytest.mark.parametrize("shape", [{"rows": 8}, {"data": 2, "dtaa": 1}, {"data": 0},
                                   {"model": -1}])
def test_validate_refuses_like_reference(shape):
    with pytest.raises(ValueError) as ref_err:
        ref_mesh.validate_mesh_shape(shape)
    with pytest.raises(ValueError) as got_err:
        M.validate_mesh_shape(shape)
    assert str(got_err.value) == str(ref_err.value)


@pytest.mark.parametrize("payload,n", [(576, 1), (576, 2), (576, 8), (0, 4), (12 * 6 * 4, 4)])
def test_collective_bytes_estimate(payload, n):
    assert M.collective_bytes_estimate(payload, n) == ref_mesh.collective_bytes_estimate(
        payload, n)


@pytest.mark.parametrize("n,multiple", [(10, 4), (12, 4), (1, 8), (403, 8)])
def test_pad_rows_numpy_and_tensor(n, multiple):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want, nv = ref_mesh.pad_rows(x, multiple)
    got, gv = M.pad_rows(x, multiple)
    assert nv == gv == n and np.array_equal(got, want)
    got_t, tv = M.pad_rows(torch.from_numpy(x), multiple)
    assert tv == n and np.array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("n_valid", [0, 5, 13, 16, 403])
def test_prefix_mask_matches_reference_per_shard(n_valid):
    """The reference's shard-local mask (in ``shard_map`` over 8 devices)
    equals the port's ``prefix_mask`` shard by shard."""
    ndata, n_loc = 8, max(2, -(-n_valid // 8))
    x = np.zeros((ndata * n_loc, 2), np.float32)
    mesh = ref_mesh.make_mesh(ndata)
    fn = jax.jit(ref_mesh.shard_map_compat(
        lambda xs: ref_mesh.prefix_mask(xs, n_valid), mesh=mesh,
        in_specs=(P("data", None),), out_specs=P("data")))
    want = np.asarray(fn(x)).reshape(ndata, n_loc)
    for s in range(ndata):
        got = M.prefix_mask(torch.from_numpy(x[s * n_loc:(s + 1) * n_loc]), n_valid, s)
        assert np.array_equal(got.numpy(), want[s]), s
        assert M.shard_valid(n_valid, n_loc, s) == int(want[s].sum())


def test_placement_rule_and_axes(monkeypatch):
    cpu = M.make_mesh(4, 2, device="cpu")
    assert cpu.shape == {"data": 4, "model": 2} and cpu.size == 8
    assert set(cpu.devices) == {torch.device("cpu")} and not cpu.single
    assert M.make_mesh(1, device="cpu").single and M.mesh_from_shape(None, "cpu").single
    # A CUDA mesh: shard s on card s mod the card count.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = M._card_devices(8, torch.device("cuda"))
    assert [d.index for d in cards] == [s % 3 for s in range(8)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert {d.index for d in M._card_devices(8, torch.device("cuda", 0))} == {0}
    with pytest.raises(ValueError, match="unknown mesh axis"):
        M.mesh_from_shape({"rows": 2}, "cpu")
    with pytest.raises(ValueError, match="one kind of device"):
        M.Mesh(2, 1, ["cpu", "cuda:0"])


def test_no_device_means_cuda_or_raise(monkeypatch):
    """A mesh built without a device lies on CUDA, as every entry point of
    the port does: on a host without a card it raises, never lands on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: M.Mesh(2), lambda: M.make_mesh(2), lambda: M.make_mesh(1),
                  lambda: M.mesh_from_shape({"data": 4}),
                  lambda: M.resolve_mesh({"data": 4}, None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_split_pads_and_views():
    mesh = M.make_mesh(4, device="cpu")
    x = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    n_loc, shards = mesh.split(x, fill=-1)
    assert n_loc == 3 and [s.shape[0] for s in shards] == [3, 3, 3, 3]
    assert torch.equal(torch.cat(shards)[:10], x) and bool((shards[3][1:] == -1).all())
    y = torch.arange(8.0)
    _, views = M.make_mesh(2, device="cpu").split(y)
    assert views[1].data_ptr() == y[4:].data_ptr()   # no copy when none is needed


def _partials(seed, n_shards, shape=(12, 6)):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for _ in range(n_shards)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_psum_is_the_same_bits_at_every_shard_count(seed):
    """Eight partials reduced on meshes of 1, 2, 4 and 8 data shards (each
    shard's partial the sum of its block of the eight, in order) give
    the left-to-right sum of the eight bit for bit at 8, and every mesh
    reduces its own partials in global shard order."""
    parts = _partials(seed, 8)
    seq = parts[0]
    for p in parts[1:]:
        seq = seq + p
    assert torch.equal(M.make_mesh(8, device="cpu").psum(parts), seq)
    for nd in (1, 2, 4):
        mesh = M.make_mesh(nd, device="cpu")
        per = 8 // nd
        blocks = []
        for s in range(nd):
            acc = parts[s * per]
            for p in parts[s * per + 1:(s + 1) * per]:
                acc = acc + p
            blocks.append(acc)
        want = blocks[0]
        for b in blocks[1:]:
            want = want + b
        assert torch.equal(mesh.psum(blocks), want)
        assert torch.equal(mesh.psum(blocks), mesh.psum(list(blocks)))
    # Integer partials add exactly, in any grouping.
    ints = [torch.from_numpy(np.random.default_rng(seed + s).integers(0, 1000, 64))
            for s in range(8)]
    total = torch.stack(ints).sum(0)
    for nd in (1, 2, 4, 8):
        per = 8 // nd
        got = M.make_mesh(nd, device="cpu").psum(
            [torch.stack(ints[s * per:(s + 1) * per]).sum(0) for s in range(nd)])
        assert torch.equal(got, total)


def test_extremes_and_gather_in_shard_order():
    mesh = M.make_mesh(4, device="cpu")
    parts = _partials(3, 4, (5,))
    stacked = torch.stack(parts)
    assert torch.equal(mesh.pmax(parts), stacked.amax(0))
    assert torch.equal(mesh.pmin(parts), stacked.amin(0))
    assert torch.equal(mesh.all_gather(parts), stacked)
