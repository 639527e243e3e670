"""The device mesh: the port of ``cdrs_tpu/parallel/mesh.py``.

The reference shards rows over the devices of a ``jax.sharding.Mesh`` and
runs one program per device under ``shard_map``, with XLA collectives
between them.  Here a :class:`Mesh` is a grid of **shards**, ``data`` x
``model`` in row-major order, each with the ``torch.device`` it computes
on, and the code of each module loops over the shards it owns and merges
their partial results with the collectives below.

* ``data`` — rows (files, events) are split into contiguous blocks, one a
  data shard (rows ``[s * n_loc, (s + 1) * n_loc)``).
* ``model`` — the centroid table is split over the model shards of each
  data shard (the (n, k) distance block of a large k).

**Placement rule.**  A mesh lies on CUDA unless the caller asks for the
CPU (``device=None`` goes through ``device.resolve_device``: CUDA, or
raise).  A CPU mesh puts every shard on the CPU: the counterpart of the
reference's virtual CPU devices, and what the tests use.  A CUDA mesh puts
shard ``s`` on card ``s mod
torch.cuda.device_count()``, so ``{"data": 8}`` on a one-card host runs
eight shards on ``cuda:0``, each launching the kernels itself.  A shard is
a contiguous row view of its block: on one card no rows are copied.

**Collectives** act on the partial results of the shards a process owns
(a list, in shard order) and return one tensor on the process's home
device (its first shard's):

* ``psum`` stacks the partials of every shard in global shard order and
  adds them one after another, shard 0 first.  The result has the same
  bits in every process and whether the shards share one process or are
  spread over several (``parallel/distributed.py``).  The partials are
  small: (k, d + 1) Lloyd statistics, (k, 2d) int32 bisection counts,
  (k, bins) histograms, per-file integer counters.
* ``pmax``/``pmin`` take the elementwise extreme; ``all_gather`` returns
  the stacked (N, ...) partials in global shard order.

A 1 x 1 mesh in one process is the one-device path: callers test
:attr:`Mesh.single` and run their unsharded code unchanged (the
reference's single-device bypass).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "mesh_from_shape",
           "resolve_mesh", "data_mesh", "validate_mesh_shape", "collective_bytes_estimate",
           "pad_rows", "prefix_mask", "shard_valid"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def validate_mesh_shape(mesh_shape: dict[str, int] | None) -> dict[str, int]:
    """Normalize a ``{"data": N, "model": M}`` spec: reject unknown axis
    names (named in the message) and sizes < 1; values coerce to int."""
    shape = dict(mesh_shape or {})
    unknown = set(shape) - {DATA_AXIS, MODEL_AXIS}
    if unknown:
        raise ValueError(
            f"unknown mesh axis {sorted(unknown)}: a mesh shape takes "
            f"{DATA_AXIS!r} (rows sharded over devices) and "
            f"{MODEL_AXIS!r} (centroid table sharded)")
    for k, v in shape.items():
        if int(v) < 1:
            raise ValueError(f"mesh axis {k!r} must be >= 1, got {v}")
        shape[k] = int(v)
    return shape


def collective_bytes_estimate(payload_bytes: int, n_devices: int) -> int:
    """Bytes moved by one all-reduce of ``payload_bytes`` over ``n_devices``
    in the ring model: ``2 * (N - 1) * payload`` for the mesh, 0 on one
    device.  An estimate of wire traffic, not a measurement."""
    n = int(n_devices)
    if n <= 1:
        return 0
    return int(2 * (n - 1) * int(payload_bytes))


def pad_rows(x, multiple: int, fill=0):
    """Pad axis 0 with ``fill`` rows up to a multiple; returns (padded,
    n_valid).  Takes a numpy array or a tensor and returns the same kind
    (one that needs no padding is returned as is, not copied)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if torch.is_tensor(x):
        return torch.cat([x, x.new_full((rem, *x.shape[1:]), fill)]), n
    return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1), constant_values=fill), n


def shard_valid(n_valid: int, n_loc: int, shard: int) -> int:
    """Valid rows of data shard ``shard`` when the valid rows are a global
    prefix: ``clip(n_valid - shard * n_loc, 0, n_loc)``."""
    return int(min(max(int(n_valid) - int(shard) * int(n_loc), 0), int(n_loc)))


def prefix_mask(x: torch.Tensor, n_valid: int, shard: int = 0) -> torch.Tensor:
    """Shard-local validity mask of ``x`` (one shard's rows, the valid rows
    a global prefix) in ``x``'s dtype: the reference's ``prefix_mask`` with
    the shard index in place of ``lax.axis_index``."""
    n_loc = x.shape[0]
    keep = shard_valid(n_valid, n_loc, shard)
    return (torch.arange(n_loc, device=x.device) < keep).to(x.dtype)


def _card_devices(n: int, device: torch.device) -> list[torch.device]:
    """The placement rule: every shard on the CPU, or shard ``s`` on card
    ``s mod device_count``."""
    if device.type == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("a CUDA mesh needs a CUDA device")
    return [torch.device("cuda", s % count) for s in range(n)]


class Mesh:
    """``n_data`` x ``n_model`` shards; ``devices[d * n_model + m]`` is the
    device of data shard ``d``, model shard ``m`` (None: the placement rule
    on CUDA).

    ``group`` is a ``torch.distributed`` process group (None: one process
    owns every shard).  With a group, process ``r`` of ``W`` owns the data
    shards ``[r * n_data / W, (r + 1) * n_data / W)`` with all their model
    shards, and the collectives run over the group.
    """

    def __init__(self, n_data: int = 1, n_model: int = 1, devices=None, group=None):
        self.n_data, self.n_model = int(n_data), int(n_model)
        if self.n_data < 1 or self.n_model < 1:
            raise ValueError(f"mesh axes must be >= 1, got {DATA_AXIS}={n_data}, "
                             f"{MODEL_AXIS}={n_model}")
        need = self.n_data * self.n_model
        devices = list(devices if devices is not None
                       else _card_devices(need, resolve_device(None)))
        if len(devices) != need:
            raise ValueError(f"mesh {DATA_AXIS}={n_data}, {MODEL_AXIS}={n_model} needs "
                             f"{need} devices, got {len(devices)}")
        kinds = {torch.device(d).type for d in devices}
        if len(kinds) != 1:
            raise ValueError(f"a mesh lies on one kind of device, got {sorted(kinds)}")
        self.devices = tuple(torch.device(d) for d in devices)
        self.group = group
        self.world, self.rank = 1, 0
        if group is not None:
            import torch.distributed as dist

            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = dist.get_backend(group)
            if self.n_data % self.world:
                raise ValueError(f"the data axis ({self.n_data}) must divide over the "
                                 f"{self.world} processes")
        per = self.n_data // self.world
        #: The data shards this process owns, in global order.
        self.local = range(self.rank * per, (self.rank + 1) * per)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def single(self) -> bool:
        """One shard in one process: callers take their one-device path."""
        return self.size == 1 and self.group is None

    def device(self, d: int, m: int = 0) -> torch.device:
        return self.devices[d * self.n_model + m]

    @property
    def home(self) -> torch.device:
        """Where collectives put their results: this process's first shard."""
        return self.device(self.local[0])

    # -- rows -------------------------------------------------------------

    def rows_per_shard(self, n: int) -> int:
        return max(1, math.ceil(int(n) / self.n_data))

    def split(self, x: torch.Tensor, fill=0):
        """(n_loc, [shard rows of each local data shard]): ``x`` padded with
        ``fill`` to ``n_data * n_loc`` rows (copied only when it must be),
        each block a view moved to its shard's device (no copy when it
        lies there already)."""
        n_loc = self.rows_per_shard(x.shape[0])
        x, _ = pad_rows(x, self.n_data * n_loc, fill)
        return n_loc, [x[d * n_loc:(d + 1) * n_loc].to(self.device(d))
                       for d in self.local]

    # -- collectives ------------------------------------------------------

    def all_gather(self, parts) -> torch.Tensor:
        """(n_data, ...) partials of every data shard in global order, on
        the home device; ``parts`` holds this process's, in shard order."""
        t = torch.stack([p.to(self.home) for p in parts])
        if self.group is None:
            return t
        import torch.distributed as dist

        # gloo's CUDA support is partial: a gloo group carries CUDA
        # partials through host memory (kilobytes), NCCL on the card.
        wire = t.cpu() if (t.is_cuda and self.backend == "gloo") else t
        out = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(out, wire, group=self.group)
        return torch.cat(out).to(self.home)

    def psum(self, parts) -> torch.Tensor:
        """Sum over the data shards, added in global shard order."""
        g = self.all_gather(parts)
        acc = g[0]
        for i in range(1, g.shape[0]):
            acc = acc + g[i]
        return acc

    def pmax(self, parts) -> torch.Tensor:
        return self.all_gather(parts).amax(dim=0)

    def pmin(self, parts) -> torch.Tensor:
        return self.all_gather(parts).amin(dim=0)


def make_mesh(n_data: int = 1, n_model: int = 1, device=None, group=None) -> Mesh:
    """A mesh on ``device``'s kind (``resolve_device``: None is CUDA, or
    raise), shards placed by the placement rule; ``group`` spreads its data
    shards over processes."""
    dev = resolve_device(device)
    return Mesh(n_data, n_model, _card_devices(int(n_data) * int(n_model), dev), group)


def mesh_from_shape(mesh_shape: dict[str, int] | None, device=None) -> Mesh:
    """Mesh from a ``{"data": N, "model": M}`` dict (missing axes 1) on
    ``device``'s kind.  Once ``parallel.distributed.init_distributed`` has
    made a process group, the mesh's data shards spread over its
    processes."""
    from .distributed import process_group

    shape = validate_mesh_shape(mesh_shape)
    return make_mesh(shape.get(DATA_AXIS, 1), shape.get(MODEL_AXIS, 1), device,
                     process_group())


def resolve_mesh(mesh_shape, device) -> Mesh | None:
    """The mesh of ``mesh_shape`` on ``device``'s kind, or None for the
    one-device path (no shape, or one shard in one process)."""
    if mesh_shape is None:
        return None
    mesh = mesh_from_shape(mesh_shape, device)
    return None if mesh.single else mesh


def data_mesh(mesh_shape, device) -> Mesh | None:
    """``resolve_mesh`` of the data axis alone: the row shards of the
    stages that do not split the centroid table (features, medians,
    drift)."""
    if mesh_shape is None:
        return None
    return resolve_mesh({DATA_AXIS: validate_mesh_shape(mesh_shape).get(DATA_AXIS, 1)},
                        device)
