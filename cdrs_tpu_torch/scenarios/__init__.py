"""The declarative scenario matrix, invariant-gated, on the port's controller.

A spec (spec.py) over workload curve x drift pattern x fault schedule x
topology x storage x scale x serve config; one harness (harness.py) that
runs any cell end to end and checks invariants (zero silent loss,
churn-budget conservation, domain diversity, kill/resume bit-identity,
positive engagement, alert expectations, the daemon's, the read path's
SLO, EC engagement); the reference's presets and seeded random cells (presets.py), swept
by ``scenarios sweep`` (sweep.py).  Cells that need an axis the port does not run yet are
refused by name with their ROADMAP item.  On top of the matrix, search.py
grows the cell set itself: a seeded coverage-guided mutator (``scenarios
search``) that keeps mutants lighting up new coverage bits and shrinks any
invariant violation to a minimal-event repro, and the triage of banked
violations (``scenarios triage``).
"""

from .harness import coverage_bits, run_cell, unported_axes
from .presets import PRESETS, SUITES, preset, random_cell, suite_cells
from .search import distill_corpus, mutate_spec, run_search, shrink_cell
from .spec import ScenarioSpec
from .sweep import run_cells, run_sweep

__all__ = ["PRESETS", "SUITES", "ScenarioSpec", "coverage_bits", "distill_corpus",
           "mutate_spec", "preset", "random_cell", "run_cell", "run_cells", "run_search",
           "run_sweep", "shrink_cell", "suite_cells", "unported_axes"]
