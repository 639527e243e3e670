"""The multi-process tier of the port's mesh
(``cdrs_tpu_torch.parallel.distributed``): the single-process no-op, the
launch-marker gate (the reference's ``tests/test_distributed.py`` cases,
with the markers of torchrun, SLURM and Open MPI), ``global_mesh``, and a
real two-process gloo rendezvous on localhost in subprocesses whose
k-means, features and medians on a data = 4 mesh (two shards a process)
equal the in-process four-shard mesh bit for bit.  Both sides run one CPU
thread: the plain versions' matmuls add in another order when the thread
count differs.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as tdist  # noqa: E402

from cdrs_tpu_torch.parallel import distributed as D  # noqa: E402
from cdrs_tpu_torch.parallel.distributed import (global_mesh, init_distributed,  # noqa: E402
                                                 mesh_axis_sizes)

REPO = Path(__file__).resolve().parent.parent


def test_single_process_is_noop(monkeypatch):
    for var in D._WORLD_SIZE_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert D.process_group() is None


def test_env_gate_detects_launch_markers(monkeypatch):
    """A launch of more than one process reaches init_process_group with
    the launcher's world size and rank; size-1 launches stay a no-op;
    ``force=True`` skips the gate."""
    for var in D._WORLD_SIZE_ENV_VARS + D._RANK_ENV_VARS + ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    calls = []
    monkeypatch.setattr(tdist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(tdist, "get_world_size", lambda group=None: 2)

    monkeypatch.setattr(D, "_initialized", False)
    assert init_distributed() is False and calls == []
    for var in ("WORLD_SIZE", "SLURM_STEP_NUM_TASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        monkeypatch.setenv(var, "1")
        monkeypatch.setattr(D, "_initialized", False)
        assert init_distributed() is False and calls == [], var
        monkeypatch.delenv(var)

    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    for size, rank in (("WORLD_SIZE", "RANK"), ("SLURM_STEP_NUM_TASKS", "SLURM_PROCID"),
                       ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"),
                       ("PMI_SIZE", "PMI_RANK")):
        monkeypatch.setenv(size, "4")
        monkeypatch.setenv(rank, "3")
        monkeypatch.setattr(D, "_initialized", False)
        assert init_distributed(device="cpu") is True
        assert calls[-1] == {"backend": "gloo", "init_method": "tcp://10.0.0.1:29500",
                             "world_size": 4, "rank": 3}, size
        assert init_distributed(device="cpu") is True   # idempotent: no second call
        assert len(calls) == 1
        calls.clear()
        monkeypatch.delenv(size)
        monkeypatch.delenv(rank)

    monkeypatch.setattr(D, "_initialized", False)
    init_distributed(force=True, num_processes=2, process_id=0, backend="nccl")
    assert calls[-1]["backend"] == "nccl" and calls[-1]["world_size"] == 2
    monkeypatch.delenv("MASTER_ADDR")
    monkeypatch.setattr(D, "_initialized", False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed(num_processes=2, process_id=1)
    # No backend and no device: NCCL on CUDA, and an error without a card
    # (never a quiet gloo group on the CPU).
    monkeypatch.setattr(D, "_initialized", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed("tcp://localhost:1", num_processes=2, process_id=1)
    assert calls[-1]["backend"] == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    init_distributed("tcp://localhost:1", num_processes=2, process_id=1)
    assert calls[-1]["backend"] == "nccl" and calls[-1]["rank"] == 1
    monkeypatch.setattr(D, "_initialized", False)


def test_global_mesh_and_axis_sizes(monkeypatch):
    mesh = global_mesh(device="cpu")
    assert mesh_axis_sizes(mesh) == {"data": 1, "model": 1} and mesh.single
    mesh = global_mesh(n_data=4, n_model=2, device="cpu")
    assert mesh_axis_sizes(mesh) == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="divisible"):
        global_mesh(n_model=3, device="cpu")
    # No device means CUDA: a mesh of the cards, or an error without one.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = global_mesh()
    assert mesh_axis_sizes(mesh) == {"data": 4, "model": 1}
    assert [d.index for d in mesh.devices] == [0, 1, 2, 3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        global_mesh()


_WORKER = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from cdrs_tpu_torch.parallel.distributed import init_distributed
port, rank, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert init_distributed(f"tcp://localhost:{port}", num_processes=2, process_id=rank,
                        device="cpu") is True
import test_torch_distributed as T
res = T.compute()
import torch.distributed as dist
dist.destroy_process_group()
json.dump(res, open(out, "w"))
"""


def compute() -> dict:
    """k-means, features and bisection medians on a data = 4 mesh."""
    from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig
    from cdrs_tpu_torch.device import deterministic
    from cdrs_tpu_torch.features.batch import compute_features_torch
    from cdrs_tpu_torch.ops.kmeans import kmeans_full
    from cdrs_tpu_torch.ops.scoring import bisect_medians
    from cdrs_tpu_torch.parallel.mesh import mesh_from_shape
    from cdrs_tpu_torch.sim.access import simulate_access
    from cdrs_tpu_torch.sim.generator import generate_population

    rng = np.random.default_rng(7)
    X = rng.normal(size=(4093, 8)).astype(np.float32)
    X[:2048] += 4.0
    mesh = {"data": 4}
    with deterministic():
        c, lab, it, shift = kmeans_full(X, 16, seed=3, max_iter=25, device="cpu",
                                        mesh_shape=mesh)
        c0 = kmeans_full(X, 16, seed=3, max_iter=0, tol=0.0, device="cpu",
                         init_method="kmeans||", mesh_shape=mesh)[0]
        m = generate_population(GeneratorConfig(n_files=120, seed=2))
        ev = simulate_access(m, SimulatorConfig(duration_seconds=60.0, seed=3))
        table = compute_features_torch(m, ev, device="cpu", mesh_shape=mesh)
        med, gm = bisect_medians(torch.from_numpy(X), lab, 16, 2048, True,
                                 mesh_from_shape(mesh, "cpu"))
    return {"centroids": c.tolist(), "labels": lab.tolist(), "n_iter": it, "shift": shift,
            "init": c0.tolist(), "raw": table.raw.tolist(), "medians": med.tolist(),
            "global_medians": gm.tolist()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_equals_the_in_process_mesh(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"p{i}.json" for i in range(2)]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(port), str(i), str(outs[i])],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(2)]
    results = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("the gloo rendezvous never completed")
        results.append((p.returncode, stdout, stderr))
    for rc, stdout, stderr in results:
        assert rc == 0, f"worker failed:\n{stdout}\n{stderr[-3000:]}"
    a, b = (json.loads(o.read_text()) for o in outs)
    assert a == b
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = compute()
    finally:
        torch.set_num_threads(threads)
    for key in want:
        assert a[key] == want[key], key
    assert len(a["labels"]) == 4093 and a["n_iter"] > 1
