"""ROADMAP Queue C2, both sides: ``rack-kill`` is red on the port's own
cold init at suite seed 2 on the CPU and at suite seed 0 on the card, and
so is the reference carrying that init.  The helpers are
``test_torch_scenario_parity.py``'s."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.models.replication as ref_models  # noqa: E402
from cdrs_tpu.scenarios import run_cell as ref_run_cell  # noqa: E402
from test_torch_scenario_parity import assert_cells_match, run_pair, spec_pair  # noqa: E402

import cdrs_tpu_torch.ops.kmeans as port_kmeans  # noqa: E402
from cdrs_tpu_torch.models.replication import ReplicationPolicyModel  # noqa: E402
from cdrs_tpu_torch.scenarios import run_cell  # noqa: E402


@contextlib.contextmanager
def port_init_in_reference():
    """The reverse carry: the reference's full re-clusters start from the
    port's own cold init of the same snapshot."""
    run = ref_models.ReplicationPolicyModel.run

    def run_from_port_init(self, X, feature_names=None, init_centroids=None):
        if init_centroids is None:
            x = torch.from_numpy(np.asarray(X, dtype=np.float32))
            init_centroids = port_kmeans.kmeans_full(
                x, self.kmeans_cfg.k, seed=self.kmeans_cfg.seed, max_iter=0, tol=0.0)[0].numpy()
        return run(self, X, feature_names, init_centroids)

    ref_models.ReplicationPolicyModel.run = run_from_port_init
    try:
        yield
    finally:
        ref_models.ReplicationPolicyModel.run = run


def test_rack_kill_at_seed_2_is_init_sensitive_on_both_sides():
    """ROADMAP Queue C2: ``rack-kill`` at suite seed 2 is red on the port's
    own init (``repair_backlog`` holds for 2 windows, its rule needs 3), and
    the reference on that init gives the same red cell; from the
    reference's init both are green."""
    port_spec, ref_spec = spec_pair("rack-kill", 2)
    got = run_cell(port_spec, device="cpu")
    with port_init_in_reference():
        want = ref_run_cell(ref_spec)
    assert_cells_match(got, want)
    assert {k for k, v in got["invariants"].items() if not v} == {"alerts_expected"}
    assert "repair_backlog" not in got["metrics"]["alerts_fired"]
    got, want = run_pair("rack-kill", 2)
    assert_cells_match(got, want)
    assert got["ok"] and "repair_backlog" in got["metrics"]["alerts_fired"]


#: The rows the D² init of ``rack-kill`` (suite seed 0) picked on the card:
#: ``chip_smoke.py`` phase 9a logs them in the cell's ``init_rows`` (an
#: NVIDIA H100 80GB HBM3; the card's generator is not the CPU's, so its
#: own init differs from the CPU's).
CARD_RACK_KILL_ROWS = [319, 63, 155, 123, 67, 191, 377, 196, 144, 37, 394, 376]


@contextlib.contextmanager
def init_from_rows(rows):
    """Cold inits of both packages' models at the given rows of the
    snapshot: an init the card picked, carried to any device."""
    port_run, ref_run = ReplicationPolicyModel.run, ref_models.ReplicationPolicyModel.run

    def port(self, X, feature_names=None, init_centroids=None, **kw):
        if init_centroids is None:
            init_centroids = X.cpu().numpy()[rows]
        return port_run(self, X, feature_names, init_centroids=init_centroids, **kw)

    def ref(self, X, feature_names=None, init_centroids=None):
        if init_centroids is None:
            init_centroids = np.asarray(X)[rows]
        return ref_run(self, X, feature_names, init_centroids)

    ReplicationPolicyModel.run, ref_models.ReplicationPolicyModel.run = port, ref
    try:
        yield
    finally:
        ReplicationPolicyModel.run, ref_models.ReplicationPolicyModel.run = port_run, ref_run


def test_rack_kill_at_seed_0_is_red_on_both_sides_from_the_card_init():
    """ROADMAP Queue C2 on the card: from the init the card picks for
    ``rack-kill`` at suite seed 0, the port and the reference give the same
    red cell (``repair_backlog`` holds 2 windows)."""
    port_spec, ref_spec = spec_pair("rack-kill", 0)
    with init_from_rows(np.asarray(CARD_RACK_KILL_ROWS)):
        got = run_cell(port_spec, device="cpu")
        want = ref_run_cell(ref_spec)
    assert_cells_match(got, want)
    assert {k for k, v in got["invariants"].items() if not v} == {"alerts_expected"}
    assert "repair_backlog" not in got["metrics"]["alerts_fired"]
