"""Atomic npz snapshots and the Lloyd loop in durable blocks: the port of
``save_state``/``load_state`` and ``kmeans_jax_checkpointed`` of
``cdrs_tpu/utils/checkpoint.py``.

A snapshot is an npz of host arrays plus a ``__meta__`` entry holding a
JSON blob, the JAX package's layout, so either package loads what the
other saved.  ``kmeans_checkpointed`` runs ``ops/kmeans.kmeans_full`` a
block of iterations at a time and snapshots the centroids between
blocks; a killed run resumes from the last block with the results of an
uninterrupted one.  With an active instrument every save sets the
``checkpoint.bytes`` and ``checkpoint.save_seconds`` gauges and counts
``checkpoint.saves``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np

from ..obs import current

__all__ = ["CheckpointError", "save_state", "load_state", "kmeans_checkpointed"]


class CheckpointError(RuntimeError):
    """A checkpoint file exists but cannot be read (corrupt or truncated)."""


def save_state(path: str, arrays: dict, meta: dict | None = None) -> dict:
    """Write ``arrays`` and ``meta`` to ``path`` atomically.

    The npz goes to a temporary file in the same directory, is fsynced,
    and replaces ``path`` by rename, so ``path`` always holds a whole
    snapshot.  The previous snapshot is kept as ``<path>.prev`` (a hard
    link, or a copy where links fail).  Returns ``{"bytes", "seconds"}``.
    """
    t_start = time.perf_counter()
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            prev = path + ".prev"
            try:
                if os.path.exists(prev):
                    os.unlink(prev)
                os.link(path, prev)
            except OSError:
                shutil.copyfile(path, prev + ".cp")
                os.replace(prev + ".cp", prev)
        os.replace(tmp, path)
        try:
            dirfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:  # pragma: no cover - a platform without directory fsync
            pass
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    stats = {"bytes": int(os.path.getsize(path)),
             "seconds": round(time.perf_counter() - t_start, 6)}
    tel = current()
    if tel is not None:
        tel.gauge("checkpoint.bytes", stats["bytes"])
        tel.gauge("checkpoint.save_seconds", stats["seconds"])
        tel.counter_inc("checkpoint.saves")
    return stats


def load_state(path: str) -> tuple[dict, dict]:
    """(arrays, meta); FileNotFoundError when absent, CheckpointError when
    present but unreadable."""
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            meta = (json.loads(bytes(z["__meta__"].tobytes()).decode())
                    if "__meta__" in z.files else {})
    except FileNotFoundError:
        raise
    except Exception as e:  # numpy and zipfile raise many types on a torn file
        raise CheckpointError(
            f"checkpoint {path!r} is corrupt or truncated ({type(e).__name__}: {e}); "
            "delete it to start over"
            + (f" or restore the retained snapshot {path + '.prev'!r}"
               if os.path.exists(path + ".prev") else "")) from e
    return arrays, meta


def kmeans_checkpointed(X, k: int, checkpoint_path: str, tol: float = 1e-4,
                        seed: int | None = None, max_iter: int = 100, block_iters: int = 25,
                        device=None, resume: bool = True, init_centroids=None,
                        labels: str = "final", mesh_shape=None, **kwargs):
    """Lloyd loop in durable blocks.  Returns (centroids (k, d), labels
    (n_valid,) int32, total_iters), tensors on the points' device.

    Each block is one ``kmeans_full(..., iter_offset=iters_done)`` call of
    at most ``block_iters`` iterations, followed by a snapshot of
    (centroids, iters_done, shift, converged).  ``resume=True`` continues
    from an existing snapshot (which wins over ``init_centroids``).  The
    reseed rows are keyed by the global iteration, so blocked, resumed and
    uninterrupted runs give the same bits, reseeds included.

    ``labels``: ``"final"`` assigns every row to the final centroids (one
    more Lloyd-kernel pass); ``"parity"`` returns the last block's labels
    (against the centroids before the last update, an uninterrupted
    ``kmeans_full``'s), stored in the final snapshot so that resuming a
    finished run returns them too.  ``X`` is an (n, d) tensor (it stays on
    its device unless ``device`` is given) or an array (moved to
    ``device``: CUDA unless "cpu" is asked for); ``kwargs`` go to
    ``kmeans_full`` (``dtype``, ``n_valid``, ``init_method``, ...).
    ``mesh_shape`` runs every block on a mesh; a snapshot holds no mesh
    state, so a run resumes on another shape (a smaller mesh after losing
    cards) and continues the same trajectory.
    """
    import torch

    from ..device import resolve_device, stat_dtype, torch_dtype
    from ..ops.kmeans import kmeans_full, labels_mesh
    from ..ops.lloyd import lloyd_assign_reduce
    from ..parallel.mesh import resolve_mesh

    if labels not in ("final", "parity"):
        raise ValueError(f"labels must be 'final' or 'parity', got {labels!r}")
    if torch.is_tensor(X):
        dev = X.device if device is None else resolve_device(device)
    else:
        dev = resolve_device(device)
        X = torch.as_tensor(np.asarray(X))
    dtype = kwargs.pop("dtype", None)
    dtype = torch_dtype(dtype if dtype is not None
                        else (X.dtype if X.is_floating_point() else torch.float32))
    xp = X.to(device=dev, dtype=dtype).contiguous()
    n_valid = kwargs.get("n_valid")
    n_valid = xp.shape[0] if n_valid is None else int(n_valid)

    iters_done, converged, parity_labels = 0, False, None
    # ``init_centroids`` seeds only a fresh run; a checkpoint always wins.
    centroids = init_centroids
    if resume and os.path.exists(checkpoint_path):
        arrays, meta = load_state(checkpoint_path)
        if meta.get("k") != int(k):
            raise ValueError(f"checkpoint k={meta.get('k')} != requested k={k}")
        centroids = torch.from_numpy(arrays["centroids"])
        parity_labels = arrays.get("parity_labels")
        iters_done = int(meta["iters_done"])
        converged = bool(meta.get("converged", False))

    base_seed = 0 if seed is None else int(seed)
    while not converged and iters_done < max_iter:
        block = min(block_iters, max_iter - iters_done)
        centroids, labels_out, it, shift = kmeans_full(
            xp, k, tol=tol, seed=base_seed, max_iter=block, init_centroids=centroids,
            iter_offset=iters_done, mesh_shape=mesh_shape, **kwargs)
        iters_done += it
        converged = shift < tol
        done = converged or iters_done >= max_iter
        arrays = {"centroids": centroids.cpu().numpy()}
        if labels == "parity" and done:
            # The block's labels are the uninterrupted run's: the last
            # iteration's assignment against its pre-update centroids.
            # Only the final snapshot stores the (n,) array.
            parity_labels = labels_out.cpu().numpy()
            arrays["parity_labels"] = parity_labels
        save_state(checkpoint_path, arrays, {"iters_done": iters_done, "k": int(k),
                                             "shift": shift, "converged": converged})

    acc = stat_dtype(dtype)
    centroids = centroids.to(device=dev, dtype=acc)
    if labels == "parity":
        if parity_labels is None:
            raise ValueError("checkpoint predates labels='parity' (no stored labels); "
                             "re-run with resume=False or use labels='final'")
        return centroids, torch.as_tensor(parity_labels).to(dev), iters_done
    mesh = resolve_mesh(mesh_shape, dev)
    if mesh is not None:
        n_loc, shards = mesh.split(xp)
        return centroids, labels_mesh(mesh, shards, n_loc, centroids, n_valid), iters_done
    final_labels, _, _ = lloyd_assign_reduce(xp, centroids, n_valid, with_labels=True)
    return centroids, final_labels[:n_valid], iters_done
