"""Command line of the PyTorch port: ``python -m cdrs_tpu_torch pipeline``.

The flags are those of ``cdrs_tpu``'s ``pipeline`` subcommand that this
port supports, plus ``--device`` (CUDA unless "cpu" is asked for).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from .config import (GeneratorConfig, KMeansConfig, PipelineConfig, ScoringConfig,
                     SimulatorConfig, load_scoring_config, validated_scoring_config)

__all__ = ["main", "build_parser"]


def _load_scoring(args) -> ScoringConfig:
    """--scoring_config ("validated" or a JSON path) with --medians_from_data
    applied on top."""
    if args.scoring_config:
        cfg = (validated_scoring_config() if args.scoring_config == "validated"
               else load_scoring_config(args.scoring_config))
        if args.medians_from_data:
            cfg = dataclasses.replace(cfg, compute_global_medians_from_data=True)
        return cfg
    return ScoringConfig(compute_global_medians_from_data=args.medians_from_data)


def _cmd_pipeline(args) -> int:
    from .pipeline import run_pipeline

    cfg = PipelineConfig(
        device=args.device,
        generator=GeneratorConfig(n_files=args.n, seed=args.seed),
        simulator=SimulatorConfig(duration_seconds=args.duration_seconds,
                                  seed=None if args.seed is None else args.seed + 1),
        kmeans=KMeansConfig(k=args.k, seed=args.seed, init_method=args.init_method),
        scoring=_load_scoring(args),
    )
    result = run_pipeline(cfg, outdir=args.outdir)
    print(json.dumps(result.summary(), indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cdrs_tpu_torch",
        description="Clustering-driven replication strategy on PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("pipeline", aliases=["run"],
                       help="end-to-end: gen -> sim -> features -> cluster")
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--duration_seconds", type=float, default=600.0)
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--outdir", default="output")
    p.add_argument("--medians_from_data", action="store_true")
    p.add_argument("--scoring_config", default=None, metavar="JSON|validated")
    p.add_argument("--init_method", choices=["auto", "d2", "kmeans||"], default="auto",
                   help="centroid init: 'd2' KMeans++, 'kmeans||' oversampling, "
                        "'auto' kmeans|| at k >= 256 and d2 below")
    p.add_argument("--device", default=None,
                   help="torch device: cuda (default) or cpu")
    p.set_defaults(fn=_cmd_pipeline)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
