"""The port's entry points (``cdrs_tpu_torch/entry.py``) against
``__graft_entry__.py``.

``entry()``'s step on the CPU (the Lloyd kernel's plain version, then the
score table) against the reference's ``forward`` under ``jax.jit`` on the
same inputs: labels exact, centroids and scores within 1e-5 (float32 sums
added in another order).  ``dryrun_multichip`` on a CPU mesh of 4 shards
(data 2 x model 2) and of 3 (data 3): its own check (the streamed table
equals the batch table bit for bit) passes, and its categories equal one
device's run of the same pieces.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

import __graft_entry__ as graft  # noqa: E402

from cdrs_tpu_torch.entry import ENTRY_K, ENTRY_POINTS, dryrun_multichip, entry  # noqa: E402


def test_entry_step_equals_the_reference():
    fn, args = entry(device="cpu")
    x, c, gm = args
    assert tuple(x.shape) == (ENTRY_POINTS, 5) and tuple(c.shape) == (ENTRY_K, 5)
    assert all(a.device.type == "cpu" for a in args)
    new_c, labels, scores = fn(*args)
    ref_fn, ref_args = graft.entry()
    for a, b in zip(args, ref_args):
        assert np.array_equal(a.numpy(), np.asarray(b))
    rc, rl, rs = jax.jit(ref_fn)(*ref_args)
    assert np.array_equal(labels.numpy(), np.asarray(rl))
    np.testing.assert_allclose(new_c.numpy(), np.asarray(rc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(rs), rtol=0, atol=1e-5)
    assert scores.shape == (ENTRY_K, 4)


def test_entry_keeps_an_empty_clusters_centroid():
    import torch

    fn, (x, c, gm) = entry(device="cpu")
    c = torch.cat([c[:-1], torch.full((1, 5), 9.0)])
    new_c, labels, _ = fn(x, c, gm)
    assert not (labels == ENTRY_K - 1).any()
    assert torch.equal(new_c[-1], c[-1])


@pytest.mark.parametrize("n,mesh", [(4, {"data": 2, "model": 2}), (3, {"data": 3})])
def test_dryrun_multichip_on_a_cpu_mesh(n, mesh, capsys):
    out = dryrun_multichip(n, device="cpu")
    assert out["mesh"] == mesh and out["device"] == "cpu" and out["iters"] >= 1
    assert len(out["categories"]) == 8
    assert "dryrun_multichip ok" in capsys.readouterr().out
    one = dryrun_multichip(1, device="cpu")
    assert one["categories"] == out["categories"]
