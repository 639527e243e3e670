"""The benchmark's e2e scoring and config-5 fold against the reference's on
the CPU: categories from the same labels equal ``classify_jax``'s exactly
(sort and bisection medians), and the config-5 workload folded by the port
equals the JAX package's fold, integer counters exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.config import ScoringConfig as RefScoringConfig  # noqa: E402
from cdrs_tpu.features import streaming as ref_streaming  # noqa: E402
from cdrs_tpu.io.events import EventLog as RefEventLog, Manifest as RefManifest  # noqa: E402
from cdrs_tpu.ops.scoring_jax import classify_jax  # noqa: E402

from cdrs_tpu_torch.benchmarks import harness  # noqa: E402
from cdrs_tpu_torch.features.streaming import stream_init, stream_update  # noqa: E402
from cdrs_tpu_torch.ops.kmeans import kmeans_full  # noqa: E402
from cdrs_tpu_torch.ops.scoring import classify  # noqa: E402

N, D, K = 20_000, 12, 16


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def _ref_scoring(d, median_method):
    """The reference's e2e tables (``cdrs_tpu/benchmarks/harness._bench_e2e``)."""
    feats = tuple(f"f{i}" for i in range(d))
    dirs = {"Hot": 1, "Shared": 1, "Moderate": 0, "Archival": -1}
    return RefScoringConfig(
        features=feats, global_medians={f: 0.5 for f in feats},
        weights={c: {f: 1.0 for f in feats} for c in dirs},
        directions={c: {f: v for f in feats} for c, v in dirs.items()},
        median_method=median_method, compute_global_medians_from_data=True)


@pytest.fixture(scope="module")
def points_and_labels():
    x = harness.synth_blobs_np(N, D, K, 0).astype(np.float32)
    init = torch.from_numpy(harness._init_from_rows(x, K, 0))
    _, labels, _, _ = kmeans_full(x, K, tol=0.0, seed=0, max_iter=5, init_centroids=init,
                                  device="cpu")
    return x, labels.numpy()


@pytest.mark.parametrize("method", ["auto", "bisect"])
def test_e2e_categories_equal_classify_jax_from_the_same_labels(points_and_labels, method):
    x, labels = points_and_labels
    assert dataclasses.asdict(harness.e2e_scoring(D, method)) == \
        dataclasses.asdict(_ref_scoring(D, method))
    got, scores, _ = classify(torch.from_numpy(x), torch.from_numpy(labels), K,
                              harness.e2e_scoring(D, method))
    want, want_scores, _ = classify_jax(x, labels, K, _ref_scoring(D, method))
    assert np.array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-5)
    assert len(set(got.tolist())) >= 2


def test_e2e_run_on_the_cpu_reports_the_references_fields(monkeypatch):
    monkeypatch.setitem(harness.CONFIGS, 3, dataclasses.replace(
        harness.CONFIGS[3], n=N, d=D, k=K, e2e_iters=3))
    out = harness.run_bench(config=3, e2e=True, quality=False, device="cpu")
    assert out["metric"] == f"e2e_seconds_to_categories_n{N}_d{D}_k{K}"
    assert out["lloyd_iters"] == 3 and out["init_method"] == "kmeans||"
    assert out["median_method"] == "auto" and out["categories_found"]
    assert set(out["categories_found"]) <= {0, 1, 2, 3}
    assert out["value"] > 0 and out["baseline_seconds_estimated"] > 0
    assert out["baseline"] == "torch-cpu" and out["chunk_rows"] is None


@pytest.mark.parametrize("seed", [0, 1])
def test_config5_fold_equals_the_reference_fold(seed):
    manifest, raw, logs = harness._stream_workload(5000, 65_536, 2, seed)
    ref_manifest = RefManifest(paths=list(manifest.paths), creation_ts=manifest.creation_ts,
                               primary_node_id=manifest.primary_node_id,
                               size_bytes=manifest.size_bytes,
                               category=list(manifest.category), nodes=list(manifest.nodes))
    port, ref = stream_init(5000, "cpu"), ref_streaming.stream_init(5000)
    for lg, b in zip(logs, raw):
        port = stream_update(port, lg, manifest)
        ref = ref_streaming.stream_update(ref, RefEventLog(
            ts=b["ts"], path_id=b["pid"], op=b["op"], client_id=b["client"],
            clients=ref_manifest.nodes), ref_manifest)
    for name in ("access_freq", "writes", "local_acc", "conc_max", "last_sec",
                 "last_count"):
        got, want = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want), name
    assert (port.sec_base, port.observation_end, port.n_events) == \
        (ref.sec_base, ref.observation_end, ref.n_events)


def test_config5_bench_keys_on_the_cpu():
    out = harness._bench_streaming(dataclasses.replace(harness.CONFIGS[5], n=4000, iters=3),
                                   0, device="cpu", batch_events=32_768)
    assert out["metric"] == "stream_events_per_sec_n4000_batch32768"
    assert out["wire"] == "packed" and out["mesh_data"] == 1
    assert out["vs_baseline"] == out["value"] / out["baseline_exact_events_per_sec"]
    assert out["numpy_approx_events_per_sec"] > 0 and out["device_name"] == "torch-cpu"
    sharded = harness._bench_streaming(dataclasses.replace(harness.CONFIGS[5], n=4000,
                                                           iters=2),
                                       0, mesh_shape={"data": 8}, device="cpu",
                                       batch_events=32_768)
    assert sharded["mesh_data"] == 1 and sharded["mesh_downscaled_to"] == {"data": 1}
