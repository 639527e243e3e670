"""Entry points of the port, the counterpart of ``__graft_entry__.py``.

* :func:`entry` — ``(fn, example_args)`` for one replication-policy step on
  the card: assign and reduce through the Lloyd kernel (B1), the centroid
  update, then the category score table, at 8192 x 5 points and k = 64.
* :func:`dryrun_multichip` — the pipeline's pieces (batch features, KMeans,
  scoring, the streaming fold) over a mesh of ``n`` shards
  (``parallel/mesh.py``: ``{"data": n // 2, "model": 2}`` for an even
  ``n >= 4``, else ``{"data": n}``) on 256 files and 60 s of traffic, k = 8,
  3 Lloyd iterations; the streamed feature table must equal the batch one.

Both run on CUDA unless the caller passes ``device="cpu"``; on a host with
fewer cards than shards the shards share cards by the mesh's placement
rule (shard ``s`` on card ``s mod count``).

    python -m cdrs_tpu_torch.entry [N]    # entry() once, then dryrun_multichip(N)
"""

from __future__ import annotations

import sys

__all__ = ["entry", "dryrun_multichip", "ENTRY_POINTS", "ENTRY_K"]

#: The step's shapes: points (rows) and centroids.
ENTRY_POINTS = 8192
ENTRY_K = 64


def entry(device=None):
    """Returns ``(forward, (x, centroids, global_medians))`` on ``device``;
    ``forward`` returns ``(new_centroids, labels, score_table)``."""
    import numpy as np
    import torch

    from .config import ScoringConfig
    from .device import resolve_device
    from .ops.lloyd import lloyd_assign_reduce
    from .ops.scoring import score_table, scoring_tables

    dev = resolve_device(device)
    cfg = ScoringConfig()
    tables = scoring_tables(cfg)
    W = tables["W"].float().to(dev)
    D = tables["D"].float().to(dev)
    is_mod = tables["is_moderate"].to(dev)
    band = tables["band"].float().to(dev)

    def forward(x, centroids, global_medians):
        """One step: assign -> update -> score.  x (n, d), centroids (k, d),
        global_medians (d,); an empty cluster keeps its centroid."""
        labels, sums, counts = lloyd_assign_reduce(x, centroids, with_labels=True)
        new_c = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None],
                            centroids)
        return new_c, labels, score_table(new_c, global_medians, W, D, is_mod, band)

    rng = np.random.default_rng(0)
    d = len(cfg.features)
    x = rng.random((ENTRY_POINTS, d)).astype(np.float32)
    centroids = x[:ENTRY_K].copy()
    gm = np.full((d,), 0.5, dtype=np.float32)
    return forward, tuple(torch.from_numpy(a).to(dev) for a in (x, centroids, gm))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded run of the pipeline's pieces over an ``n_devices``-shard
    mesh; raises if a shape is wrong or the streamed table differs from the
    batch table.  Returns a summary."""
    import torch

    from .config import GeneratorConfig, ScoringConfig, SimulatorConfig
    from .device import resolve_device
    from .features.batch import compute_features_torch
    from .features.streaming import stream_finalize, stream_init, stream_update
    from .io.events import EventLog
    from .ops.kmeans import kmeans_full
    from .ops.scoring import classify
    from .sim.access import simulate_access
    from .sim.generator import generate_population

    n = int(n_devices)
    dev = resolve_device(device)
    mesh_shape = {"data": n // 2, "model": 2} if n >= 4 and n % 2 == 0 else {"data": n}
    k = 8   # divisible by the model axis

    manifest = generate_population(GeneratorConfig(n_files=256, seed=0))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=60.0, seed=0))
    table = compute_features_torch(manifest, events, device=dev, mesh_shape=mesh_shape)
    X = table.norm
    centroids, labels, it, shift = kmeans_full(X, k, seed=0, max_iter=3, mesh_shape=mesh_shape)
    winner, _, _ = classify(X, labels, k, ScoringConfig(compute_global_medians_from_data=True),
                            mesh_shape=mesh_shape)
    if (tuple(centroids.shape) != (k, X.shape[1]) or tuple(labels.shape) != (X.shape[0],)
            or tuple(winner.shape) != (k,)):
        raise AssertionError(f"dryrun_multichip: shapes {tuple(centroids.shape)}, "
                             f"{tuple(labels.shape)}, {tuple(winner.shape)}")

    # The event-sharded streaming fold over the data axis, in two batches.
    st = stream_init(len(manifest), dev)
    mid = len(events) // 2
    for lo, hi in ((0, mid), (mid, len(events))):
        batch = EventLog(ts=events.ts[lo:hi], path_id=events.path_id[lo:hi],
                         op=events.op[lo:hi], client_id=events.client_id[lo:hi],
                         clients=events.clients)
        st = stream_update(st, batch, manifest, mesh_shape={"data": mesh_shape["data"]})
    stream_table = stream_finalize(st, manifest)
    if not (torch.equal(stream_table.raw, table.raw) and torch.equal(stream_table.norm,
                                                                     table.norm)):
        raise AssertionError("dryrun_multichip: the streamed table differs from the batch table")
    out = {"mesh": mesh_shape, "devices": n, "device": str(dev), "iters": int(it),
           "shift": float(shift), "categories": winner.tolist()}
    print(f"dryrun_multichip ok: mesh={mesh_shape} devices={n} on {dev} iters={it} "
          f"shift={float(shift):.3e} categories={out['categories']}")
    return out


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(int(argv[0]) if argv else 4)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
