"""The port's ``benchmarks/integrity_bench`` (part 2 of
``test_torch_bench_integrity.py``): the overhead block's keys against the
reference's ``integrity_overhead``, ``main --quick``, and the scrubbed
side's loss at ``--quick``'s scale, which depends on the cold init on both
sides alike (ROADMAP C10)."""

import contextlib
import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.integrity_bench as ref  # noqa: E402
import cdrs_tpu.models.replication as ref_models  # noqa: E402
import torch  # noqa: E402
from test_torch_bench_integrity import QUICK  # noqa: E402
from torch_bench_parity import assert_matches, one_torch_thread, reference_on_jax  # noqa: E402

import cdrs_tpu_torch.ops.kmeans as port_kmeans  # noqa: E402
from cdrs_tpu_torch.benchmarks import integrity_bench  # noqa: E402
from cdrs_tpu_torch.models.replication import ReplicationPolicyModel  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_integrity_overhead_has_the_references_keys():
    kw = dict(n_files=300, duration=240.0, repeats=1)
    got = integrity_bench.integrity_overhead(**kw, device="cpu")
    with reference_on_jax(ref):
        want = ref.integrity_overhead(**kw)
    assert set(got) == set(want) and got["windows_per_run"] == want["windows_per_run"] == 4


def test_integrity_bench_main_quick_never_appends(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "i.json"
    assert integrity_bench.main(["--quick", "--no_overhead", "--device", "cpu", "--out",
                                 str(out)]) == 0
    doc = json.loads(out.read_text())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["history_appended"] == 0 and not (tmp_path / "data").exists()
    assert all(doc["criteria"].values()), doc["criteria"]
    assert doc["bench_records"][0]["metric"] == "integrity_mttd_margin_half_lap"
    assert doc["bench_records"][0]["device_name"] == "torch-cpu"


@contextlib.contextmanager
def both_from_d2_seed(seed: int):
    """Both sides' cold re-clusters start from the port's D² init of the
    snapshot drawn with ``seed`` (another draw than the bench's own)."""
    port_run, ref_run = ReplicationPolicyModel.run, ref_models.ReplicationPolicyModel.run

    def port_side(self, X, feature_names=None, init_centroids=None, **kw):
        if init_centroids is None:
            init_centroids = port_kmeans._d2_init(X.float(), self.kmeans_cfg.k, seed)
        return port_run(self, X, feature_names, init_centroids=init_centroids, **kw)

    def ref_side(self, X, feature_names=None, init_centroids=None):
        if init_centroids is None:
            x = torch.from_numpy(np.asarray(X, dtype=np.float32))
            init_centroids = port_kmeans._d2_init(x, self.kmeans_cfg.k, seed).numpy()
        return ref_run(self, X, feature_names, init_centroids)

    ReplicationPolicyModel.run, ref_models.ReplicationPolicyModel.run = port_side, ref_side
    try:
        yield
    finally:
        ReplicationPolicyModel.run, ref_models.ReplicationPolicyModel.run = port_run, ref_run


@pytest.mark.parametrize("seed,lost", [(1000, 1), (1001, 0)])
def test_scrubbed_loss_at_quick_depends_on_the_cold_init_on_both_sides(seed, lost):
    """ROADMAP Queue C10: at ``--quick``'s 160 files the scrubbed side keeps
    every file from the bench's own init on the CPU, but loses one from
    other D² draws (seed 1000 here; the card's own draw in smoke phase 18);
    the reference carrying the same init loses the same."""
    kw = dict(QUICK, kill_window=4, resume_check=False)
    with both_from_d2_seed(seed):
        got = integrity_bench.run_overlap_bench(**kw, device="cpu")
        with reference_on_jax(ref):
            want = ref.run_overlap_bench(**kw)
    assert_matches(got, want)
    assert got["scrubbed"]["true_lost_final"] == lost
    assert got["scrubbed"]["corrupt_reads_served"] == 0
