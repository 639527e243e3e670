"""The multi-process tier of the mesh: the port of
``cdrs_tpu/parallel/distributed.py`` over ``torch.distributed``.

One process per host (or per card), a rendezvous, and after it every mesh
built by ``parallel.mesh.mesh_from_shape`` spreads its data shards over the
processes: process ``r`` of ``W`` owns a contiguous block of ``n_data / W``
data shards, computes their partial results, and the mesh's collectives
``all_gather`` the per-shard partials of every process before reducing
them in global shard order.  So a 2-process x 2-shard run gives the same
bits as a 1-process x 4-shard run: the tier changes where shards live,
never what they compute.  Each process is given the whole input and
reads only its own shards' rows.

The backend is NCCL for CUDA shards and gloo for CPU shards.  A gloo group
may also carry CUDA shards (NCCL takes one rank per card, so two ranks on
one card go over gloo): the mesh then moves each gathered partial, a few
kilobytes, through host memory.

Usage (one process per rank)::

    from cdrs_tpu_torch.parallel.distributed import init_distributed, global_mesh

    init_distributed()                      # torchrun / SLURM / Open MPI env
    # or: init_distributed("tcp://10.0.0.1:29500", num_processes=2, process_id=r)
    model = ReplicationPolicyModel(..., mesh_shape={"data": 8})

In a single process everything here is a no-op and meshes stay local.
"""

from __future__ import annotations

import os

import torch

from ..device import resolve_device
from .mesh import DATA_AXIS, MODEL_AXIS, make_mesh

__all__ = ["init_distributed", "process_group", "global_mesh", "mesh_axis_sizes"]

_initialized = False

#: Launch markers that give the number of processes: torchrun, SLURM's
#: step-scoped task count (set under srun, once per task; the allocation's
#: SLURM_NTASKS is not consulted, since a bare ``python`` inside an ``-n 4``
#: allocation is still one process), Open MPI and PMI launchers.
_WORLD_SIZE_ENV_VARS = ("WORLD_SIZE", "SLURM_STEP_NUM_TASKS", "OMPI_COMM_WORLD_SIZE",
                        "PMI_SIZE")
#: The same launchers' rank variables, in the same order.
_RANK_ENV_VARS = ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "PMI_RANK")


def _env_int(names) -> int | None:
    for v in names:
        raw = os.environ.get(v, "").strip()
        if raw.isdigit():
            return int(raw)
    return None


def _env_multiprocess() -> bool:
    """True when a launcher's world-size marker says more than one process
    (a size-1 launch stays single-process)."""
    n = _env_int(_WORLD_SIZE_ENV_VARS)
    return n is not None and n > 1


def _env_address() -> str:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not addr or not port:
        raise ValueError("a multi-process launch needs the rendezvous address: set "
                         "MASTER_ADDR and MASTER_PORT or pass coordinator_address")
    return f"tcp://{addr}:{port}"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     force: bool = False, backend: str | None = None,
                     device=None) -> bool:
    """Idempotent ``torch.distributed.init_process_group``.

    With no arguments, initializes only when the environment describes a
    launch of more than one process (``_WORLD_SIZE_ENV_VARS``); the world
    size and rank then come from the launcher's variables and the address
    from ``MASTER_ADDR``/``MASTER_PORT``.  ``force=True`` skips that gate.
    Explicit ``coordinator_address`` (``tcp://host:port``),
    ``num_processes`` and ``process_id`` support a manual bring-up.
    ``backend`` defaults to NCCL when ``device`` is CUDA and gloo when it
    is the CPU; ``device=None`` means CUDA (``device.resolve_device``: a
    host without a card raises unless the caller passes ``device="cpu"``).

    Returns True when more than one process is joined after the call,
    False when the run is single-process (nothing was initialized).
    """
    global _initialized
    import torch.distributed as dist

    if _initialized:
        return dist.get_world_size() > 1
    explicit = (coordinator_address, num_processes, process_id) != (None, None, None)
    if not explicit and not force and not _env_multiprocess():
        return False   # a plain single-process run: nothing to do
    world = num_processes if num_processes is not None else _env_int(_WORLD_SIZE_ENV_VARS)
    rank = process_id if process_id is not None else _env_int(_RANK_ENV_VARS)
    if world is None or rank is None:
        raise ValueError("init_distributed needs the number of processes and this "
                         "process's rank (arguments or launcher variables)")
    init_method = coordinator_address or _env_address()
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=int(world), rank=int(rank))
    _initialized = True
    return dist.get_world_size() > 1


def process_group():
    """The default process group once ``torch.distributed`` is initialized,
    else None (meshes stay in this process)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def global_mesh(n_data: int | None = None, n_model: int = 1, device=None):
    """Mesh over every process's cards (one shard a card; one shard a
    process when ``device="cpu"``; None is CUDA, or raise).  ``n_data=None``
    uses every shard the model axis leaves."""
    dev = resolve_device(device)
    group = process_group()
    world = 1
    if group is not None:
        import torch.distributed as dist

        world = dist.get_world_size(group)
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    total = world * local
    if n_data is None:
        if total % n_model:
            raise ValueError(f"{total} devices not divisible by model axis {n_model}")
        n_data = total // n_model
    return make_mesh(n_data, n_model, dev, group)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{"data": N, "model": M}`` for APIs taking ``mesh_shape``."""
    return {DATA_AXIS: mesh.n_data, MODEL_AXIS: mesh.n_model}
