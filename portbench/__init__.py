"""The benchmark of ``cdrs_tpu_torch`` on one or four NVIDIA H100 cards.

``python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints its result as the last
line of standard output.  Everything of a cell is found by name: the
configuration in ``configs/``, the traffic mix in ``mixes/``, the cell's
limits in ``cells/``, the end-to-end metrics in ``e2e/`` and the per-layer
metrics in ``metrics/``.
"""
