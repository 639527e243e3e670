"""Mini-batch (Sculley) KMeans: the port of ``cdrs_tpu/ops/kmeans_stream.py``
(one device or a mesh).

* state: centroids (k, d) float32 and int32 per-center totals on one
  device (float32 totals would distort ``eta`` past 2^24 points a center);
* one update: one fused Lloyd step with labels over the batch
  (``ops/lloyd.lloyd_assign_reduce``, the kernel that replaces the TPU's
  row-major ``lloyd_assign_reduce_pallas``), then the k-sized Sculley step
  ``eta_j = bcount_j / max(total_j, 1)`` where ``bcount_j > 0`` and
  ``c_j += eta_j * (bmean_j - c_j)``, in float32;
* ``predict`` is the same kernel with labels;
* the first batch seeds the centroids with the D² init of
  ``ops/kmeans.py`` and its ``torch.Generator`` noise (not the JAX
  package's threefry draws: parity tests carry an init across).
* ``mesh_shape={"data": N}``: the batch splits into N row shards; the init
  is ``ops/kmeans.d2_init_mesh`` (the one-device draws), an update runs the
  Lloyd kernel once a shard with labels and adds the (k, d + 1) statistics
  with one shard-ordered psum.  ``predict`` stays on one device, as in the
  reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.mesh import resolve_mesh
from .kmeans import _d2_init, d2_init_mesh
from .lloyd import lloyd_assign_reduce, sharded_assign_reduce

__all__ = ["MiniBatchState", "minibatch_init", "minibatch_update", "MiniBatchKMeans"]


@dataclass
class MiniBatchState:
    centroids: torch.Tensor   # (k, d) float32
    counts: torch.Tensor      # (k,) int32, points ever assigned per center
    n_batches: int = 0


def _points(batch, device: torch.device) -> torch.Tensor:
    """A batch as contiguous float32 rows on ``device``."""
    if not torch.is_tensor(batch):
        batch = torch.from_numpy(np.asarray(batch))
    return batch.to(device=device, dtype=torch.float32).contiguous()


def minibatch_init(first_batch, k: int, seed: int | None = None,
                   device=None, mesh_shape=None) -> MiniBatchState:
    """D² init over the first batch; ``device`` None keeps a tensor's
    device and sends an array to CUDA; ``mesh_shape`` shards the rows."""
    if torch.is_tensor(first_batch) and device is None:
        dev = first_batch.device
    else:
        dev = resolve_device(device)
    x = _points(first_batch, dev)
    if x.shape[0] < k:
        raise ValueError(f"first mini-batch has {x.shape[0]} rows < k={k}; the D2 "
                         f"init would draw duplicate centroids")
    mesh = resolve_mesh(mesh_shape, dev)
    if mesh is None:
        c = _d2_init(x, int(k), seed)
    else:
        n_loc, shards = mesh.split(x)
        c = d2_init_mesh(mesh, shards, n_loc, x.shape[0], int(k), seed)
    return MiniBatchState(centroids=c, counts=torch.zeros(k, dtype=torch.int32, device=dev))


def _batch_stats(x, c, mesh):
    """(labels, sums, counts) of one batch: one Lloyd launch, or one a
    shard and a psum of the (k, d + 1) statistics."""
    if mesh is None:
        return lloyd_assign_reduce(x, c, x.shape[0], with_labels=True)
    n_loc, shards = mesh.split(x)
    return sharded_assign_reduce(mesh, shards, n_loc, c, x.shape[0], with_labels=True)


def minibatch_update(state: MiniBatchState, batch, mesh_shape=None):
    """One mini-batch step on the state's device.  Returns (new state,
    int32 labels of the batch's rows)."""
    c = state.centroids
    x = _points(batch, c.device)
    labels, sums, bcounts = _batch_stats(x, c, resolve_mesh(mesh_shape, c.device))
    counts = state.counts + bcounts.to(torch.int32)
    eta = torch.where(bcounts > 0, bcounts / torch.clamp(counts, min=1).to(c.dtype), 0.0)
    bmean = sums / torch.clamp(bcounts, min=1.0)[:, None]
    new_c = c + eta[:, None] * (bmean - c)
    return MiniBatchState(new_c, counts, state.n_batches + 1), labels


class MiniBatchKMeans:
    """Feed batches with ``partial_fit``; read ``centroids``; ``predict``.

    ``device`` None puts the state where the first batch lies (CUDA for an
    array); later batches move to the state's device.  ``mesh_shape``
    shards the init and the updates.
    """

    def __init__(self, k: int, seed: int | None = None, device=None, mesh_shape=None):
        self.k = int(k)
        self.seed = seed
        self.device = device
        self.mesh_shape = mesh_shape
        self.state: MiniBatchState | None = None

    def partial_fit(self, batch) -> torch.Tensor:
        if self.state is None:
            self.state = minibatch_init(batch, self.k, seed=self.seed, device=self.device,
                                        mesh_shape=self.mesh_shape)
        self.state, labels = minibatch_update(self.state, batch, self.mesh_shape)
        return labels

    def _fitted(self) -> MiniBatchState:
        if self.state is None:
            raise ValueError("no batches seen yet")
        return self.state

    @property
    def centroids(self) -> torch.Tensor:
        return self._fitted().centroids

    def predict(self, X) -> torch.Tensor:
        c = self._fitted().centroids
        x = _points(X, c.device)
        return lloyd_assign_reduce(x, c, x.shape[0], with_labels=True)[0]
