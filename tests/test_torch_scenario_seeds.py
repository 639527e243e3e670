"""The port's scenario cells from its own cold init at suite seeds 1 and 2:
every cell whose axes are ported must hold its invariants (the
multi-seed "not a single-seed accident" dimension of the matrix).

``rack-kill`` at suite seed 2 and ``wan-partition`` at suite seed 1 are red
on the port's own init, and the reference goes red too when that init is
carried into it (ROADMAP Queue C2 and C5; ``test_torch_scenario_parity_3.py``
and ``_6.py`` show the reference side): the cells are sensitive to their
init, and the port is not at fault.
"""

import pytest

pytest.importorskip("torch")

from cdrs_tpu_torch.scenarios import run_cell, suite_cells, unported_axes  # noqa: E402

#: (suite seed, cell) pairs that the protocol of ROADMAP Queue C records.
QUEUE_C = {(2, "rack-kill"): "ROADMAP Queue C2: repair_backlog fires for 2 windows, not 3, "
                             "on the port's init; the reference on that init is red too",
           (1, "wan-partition"): "ROADMAP Queue C5: the SLO burn alerts stay silent on the "
                                 "port's init; the reference on that init is red too"}


def _cases():
    for seed in (1, 2):
        for spec in suite_cells("full", seed):
            if unported_axes(spec):
                continue
            marks = ([pytest.mark.xfail(strict=True, reason=QUEUE_C[(seed, spec.name)])]
                     if (seed, spec.name) in QUEUE_C else [])
            yield pytest.param(seed, spec.name, marks=marks, id=f"s{seed}-{spec.name}")


@pytest.mark.parametrize("seed,name", list(_cases()))
def test_cell_holds_its_invariants_on_the_port_init(seed, name):
    spec = {c.name: c for c in suite_cells("full", seed)}[name]
    cell = run_cell(spec, suite="full", suite_seed=seed, device="cpu")
    assert cell["ok"], {k: v for k, v in cell["invariants"].items() if not v}
    assert cell["repro"].endswith(f"--seed {seed} --cell {name}")
