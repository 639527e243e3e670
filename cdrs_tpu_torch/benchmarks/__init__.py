"""The port's benchmark surface: the counterpart of ``cdrs_tpu/benchmarks``.

* ``harness`` — the BASELINE.md configs (``run_bench``): Lloyd iterations a
  second, time-to-categories (``e2e``) and streaming events a second, each
  against the port's plain PyTorch versions on the CPU;
* ``python -m cdrs_tpu_torch.benchmarks`` — ``bench.py``'s entry: the
  config-2 contract line on stdout, the full detail on stderr;
* ``ingest``, ``stream1b`` — log ingestion and the 1B-event path;
* ``init_quality`` — D² against k-means|| across seeds;
* ``regress`` — the trajectory history and its bands
  (``metrics regress``, the sweep's ``--round``/``--history``);
* ``summary`` — the one-command sweep.

Nothing here imports the JAX package.
"""
