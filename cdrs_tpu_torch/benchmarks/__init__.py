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
* ``summary`` — the one-command sweep;
* the subsystem benches of the online and host planes, each run as
  ``python -m cdrs_tpu_torch.benchmarks.<name>`` (CUDA unless
  ``--device cpu``) and writing ``data/<name>_torch.json``:
  ``control_bench`` (time to adapt and moved bytes after a shift),
  ``chaos_bench`` (node and rack kills, partitions: windows to full
  re-replication), ``storage_bench`` (EC(6,3) Archival bytes at matched
  durability), ``integrity_bench`` (MTTD against the scrub budget),
  ``serve_bench`` (routed reads/s, p99 under a partition, the flash crowd),
  ``daemon_bench`` (decision p99 with the HTTP plane attached),
  ``overload_bench`` (lag and availability under brownout), ``geo_bench``
  (region loss, the hierarchical chooser, Black Friday, the WAN partition)
  and ``placement_bench`` (functional against materialized maps, a
  functional controller window at 100M files), ``mesh_bench`` (decision
  identity across mesh shapes, Lloyd iterations a second by shard count,
  the data = 1 overhead), ``search_bench`` (the guided failure search
  against blind sampling, the shrunk repro), ``telemetry_overhead`` (the
  traced and scraped daemon against the plain one) and ``plan_bench``
  (the SoA planners against ``compat/reference_planners``, the overlapped
  controller); ``common`` holds what they share.

Nothing here imports the JAX package.
"""
