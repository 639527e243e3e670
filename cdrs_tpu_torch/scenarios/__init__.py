"""The declarative scenario matrix, invariant-gated, on the port's controller.

A spec (spec.py) over workload curve x drift pattern x fault schedule x
topology x storage x scale x serve config; one harness (harness.py) that
runs any cell end to end and checks invariants (zero silent loss,
churn-budget conservation, domain diversity, kill/resume bit-identity,
positive engagement, alert expectations, the daemon's, the read path's
SLO, EC engagement); the reference's presets and seeded random cells (presets.py), swept
by ``scenarios sweep`` (sweep.py).  Cells that need an axis the port does not run yet are
refused by name with their ROADMAP item.  The reference's failure-space
search (``scenarios search|triage``) is not ported yet (ROADMAP A12).
"""

from .harness import coverage_bits, run_cell, unported_axes
from .presets import PRESETS, SUITES, preset, random_cell, suite_cells
from .spec import ScenarioSpec
from .sweep import run_cells, run_sweep

__all__ = ["PRESETS", "SUITES", "ScenarioSpec", "coverage_bits", "preset", "random_cell",
           "run_cell", "run_cells", "run_sweep", "suite_cells", "unported_axes"]
