"""The port's ``benchmarks/integrity_bench`` against the reference's
``run_mttd_sweep``, ``run_overlap_bench``, ``integrity_overhead`` and
``_lap_upper_bytes`` on the CPU, from the reference's cold init (decay 1:
the reference on ``backend="jax"``): detection latencies, residual rot,
true and blind losses, corrupt reads served and the mid-scrub kill/resume
must be the reference's.  At ``--quick``'s scale the scrubbed side's
zero loss depends on the cold init on both sides alike (ROADMAP C10)."""

import contextlib
import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.benchmarks.integrity_bench as ref  # noqa: E402
import cdrs_tpu.models.replication as ref_models  # noqa: E402
import torch  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import assert_matches, reference_on_jax, round_trips  # noqa: E402

import cdrs_tpu_torch.ops.kmeans as port_kmeans  # noqa: E402
from cdrs_tpu_torch.benchmarks import integrity_bench  # noqa: E402
from cdrs_tpu_torch.config import GeneratorConfig  # noqa: E402
from cdrs_tpu_torch.models.replication import ReplicationPolicyModel  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

#: The reference's ``--quick`` scale.
QUICK = dict(n_files=160, seed=17, duration=720.0, n_windows=8, corrupt_window=2, k=8)


def run_pair(fn, kw):
    with reference_on_jax(ref):
        want = getattr(ref, fn)(**kw)
    with carried_init():
        got = getattr(integrity_bench, fn)(**kw, device="cpu")
    return got, want


@pytest.mark.parametrize("fn,kw", [
    ("run_mttd_sweep", dict(QUICK, budget_fracs=(0.25, 0.5))),
    ("run_mttd_sweep", {}),
    ("run_overlap_bench", dict(QUICK, kill_window=4)),
    ("run_overlap_bench", dict(resume_check=False)),
], ids=["mttd-quick", "mttd-default", "overlap-quick", "overlap-default"])
def test_integrity_bench_matches_the_reference(fn, kw, tmp_path):
    got, want = run_pair(fn, kw)
    assert_matches(got, want)
    round_trips(got, tmp_path)
    if fn == "run_mttd_sweep":
        assert all(s["detected_within_bound"] for s in got["sweep"])
    else:
        assert got["scrubbed"]["true_lost_final"] == 0
        assert got["unscrubbed"]["corrupt_reads_served"] > 0


def test_lap_upper_bytes_is_the_references():
    from cdrs_tpu.config import GeneratorConfig as RefGen
    from cdrs_tpu.sim.generator import generate_population as ref_gen

    from cdrs_tpu_torch.benchmarks.common import min_rf2_scoring

    man = generate_population(GeneratorConfig(n_files=300, seed=17))
    ref_man = ref_gen(RefGen(n_files=300, seed=17))
    got = integrity_bench._lap_upper_bytes(man, min_rf2_scoring(every_category=True), 2)
    assert got == ref._lap_upper_bytes(ref_man, ref._min_rf2_scoring(), 2) > 0


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
