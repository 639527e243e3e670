"""The port's functional-placement and elastic scenario cells against the
reference's ``run_cell`` from the reference's cold init carried in (part 6):
``scale-placement``, ``region-loss``, ``wan-partition`` and
``black-friday`` at suite seed 0.  The helpers and the comparison are part
1's (``test_torch_scenario_parity.py``): the cell records agree in
invariants, metrics, coverage bits and fingerprint.

``black-friday``'s warm re-cluster of window 3 empties two clusters at its
first Lloyd iteration; the port reseeds them from its own generator, so the
cell is held with the reseed rows of the reference's jax backend carried in
as well (ROADMAP Queue C3).  ``wan-partition`` at suite seed 1 is red on
the port's own init, and so is the reference carrying that init (ROADMAP
Queue C5).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from cdrs_tpu.scenarios import run_cell as ref_run_cell  # noqa: E402
from test_torch_scenario_parity import assert_cells_match, carried_init, run_pair, \
    spec_pair  # noqa: E402
from test_torch_scenario_parity_3 import port_init_in_reference  # noqa: E402

import cdrs_tpu_torch.ops.kmeans as port_kmeans  # noqa: E402
from cdrs_tpu_torch.scenarios import run_cell  # noqa: E402


@contextlib.contextmanager
def jax_reseeds():
    """An emptied cluster takes the row the reference's jax backend draws
    for it: ``randint(fold_in(split(PRNGKey(seed))[1], iteration), (k,), 0,
    n_valid)``."""
    table = port_kmeans._reseed_table

    def jax_table(seed, iter_offset, iters, k, n_valid):
        key = jax.random.split(jax.random.PRNGKey(int(seed)))[1]
        rows = [np.asarray(jax.random.randint(jax.random.fold_in(key, iter_offset + it),
                                              (k,), 0, n_valid)) for it in range(iters)]
        return torch.as_tensor(np.stack(rows) if rows else np.zeros((0, k)),
                               dtype=torch.int64)

    port_kmeans._reseed_table = jax_table
    try:
        yield
    finally:
        port_kmeans._reseed_table = table


@pytest.mark.parametrize("name,engaged", [
    ("scale-placement", ("functional_engaged", "resume_bit_identical", "drift_engaged")),
    ("region-loss", ("functional_engaged", "resume_bit_identical", "region_engaged",
                     "ec_engaged", "heal_converged")),
    ("wan-partition", ("functional_engaged", "stranded_not_lost", "partition_stall_engaged",
                       "heal_converged")),
])
def test_functional_cell_matches_the_reference(name, engaged):
    got, want = run_pair(name)
    assert_cells_match(got, want)
    assert got["ok"], got["invariants"]
    assert all(got["invariants"][k] for k in engaged)
    assert got["metrics"]["files_lost_max"] == 0


def test_black_friday_matches_the_reference():
    port_spec, ref_spec = spec_pair("black-friday")
    want = ref_run_cell(ref_spec)
    with carried_init(), jax_reseeds():
        got = run_cell(port_spec, device="cpu")
    assert_cells_match(got, want)
    assert got["ok"], got["invariants"]
    inv = got["invariants"]
    assert inv["elastic_engaged"] and inv["elastic_drained"] and inv["resume_bit_identical"]
    assert inv["functional_engaged"] and inv["budget_conserved"]
    assert "cause:epoch_diff" in got["coverage"] and "cause:elastic_rebalance" in got["coverage"]


def test_wan_partition_at_seed_1_is_init_sensitive_on_both_sides():
    """ROADMAP Queue C5: on the port's own init at suite seed 1 the burn
    alerts stay silent (``alerts_expected`` fails), and the reference on
    that init gives the same red cell; from the reference's init both are
    green."""
    port_spec, ref_spec = spec_pair("wan-partition", 1)
    got = run_cell(port_spec, device="cpu")
    with port_init_in_reference():
        want = ref_run_cell(ref_spec)
    assert_cells_match(got, want)
    assert {k for k, v in got["invariants"].items() if not v} == {"alerts_expected"}
    assert "slo_burn_fast" not in got["metrics"]["alerts_fired"]
    got, want = run_pair("wan-partition", 1)
    assert_cells_match(got, want)
    assert got["ok"] and "slo_burn_fast" in got["metrics"]["alerts_fired"]
