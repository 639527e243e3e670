"""The system under test: the program (``cdrs_tpu_torch``) behind the
interface the traffic drives, ``solve`` and ``classify``.  The reference
offers the same interface (``reference.Reference``), so the control can
take the program's place.
"""

from __future__ import annotations


class Program:
    """``cdrs_tpu_torch``'s entries: ``ops.kmeans.kmeans_full`` (the init,
    the Lloyd loop, kernel B1) and ``ops.scoring.classify`` (the bisection
    medians on kernel B2, the score table, the winner)."""

    name = "program"

    def __init__(self):
        from cdrs_tpu_torch.config import ScoringConfig
        from cdrs_tpu_torch.ops import kmeans, lloyd, scoring, seg_count

        self._kmeans_full = kmeans.kmeans_full
        self._classify = scoring.classify
        self._lloyd = lloyd.lloyd_assign_reduce
        self._seg = seg_count.label_threshold_count
        self._scoring_config = ScoringConfig
        self._configs: dict = {}

    @staticmethod
    def build() -> None:
        """Build (first run in a checkout) or load the kernels' libraries."""
        from cdrs_tpu_torch.ops import _build

        _build.build_all(("lloyd", "seg_count"))

    def solve(self, X, k, *, tol, max_iter, seed=None, init_centroids=None,
              init_method="kmeans||", init_oversample=2.0, init_rounds=5):
        c, labels, it, _ = self._kmeans_full(
            X, k, tol=tol, seed=seed, max_iter=max_iter, init_centroids=init_centroids,
            init_method=init_method, init_oversample=init_oversample, init_rounds=init_rounds)
        return c, labels, it

    def _config(self, tables):
        key = id(tables)
        if key not in self._configs:
            feats = tuple(f"f{i}" for i in range(len(tables["W"][0])))
            cats = tables["categories"]
            self._configs[key] = self._scoring_config(
                features=feats,
                global_medians={f: 0.0 for f in feats},
                weights={c: dict(zip(feats, row)) for c, row in zip(cats, tables["W"])},
                directions={c: dict(zip(feats, row)) for c, row in zip(cats, tables["D"])},
                replication_factors=dict(zip(cats, tables["rf"])),
                moderate_band=tables["band"],
                compute_global_medians_from_data=True,
                median_method=tables["median_method"],
                median_bins=tables["bins"],
                categories=tuple(cats))
        return self._configs[key]

    def classify(self, X, labels, k, tables):
        winner, _, medians = self._classify(X, labels, k, self._config(tables))
        return winner, medians

    def launches(self) -> dict:
        """The wrappers' launch counters: B1's (without the row-major route's
        launches, which no cell makes) and B2's."""
        return {"b1": self._lloyd.launches - self._lloyd.rowmajor_launches,
                "b2": self._seg.launches}
