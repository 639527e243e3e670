"""``python -m cdrs_tpu_torch gen | simulate | stream | control | daemon`` end to
end on the CPU.

``gen`` and ``simulate`` write byte-identical files to ``cdrs gen`` and
``cdrs simulate`` on the same seeds (CSV manifest, ``.cdrsb`` log);
``stream --kmeans_batch`` folds that log and writes ``final_categories.csv``,
and the folded features equal the port's batch features of the same files;
``control`` and ``daemon`` print the reference's summary and digest keys.
"""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.cli import main as reference_main  # noqa: E402

from cdrs_tpu_torch.config import CATEGORIES  # noqa: E402
from cdrs_tpu_torch.features.batch import compute_features_torch  # noqa: E402
from cdrs_tpu_torch.features.streaming import fold_stream, stream_finalize  # noqa: E402
from cdrs_tpu_torch.io.events import EventLog, Manifest  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": str(ROOT)}


def _port(*args, cwd):
    proc = subprocess.run([sys.executable, "-m", "cdrs_tpu_torch", *args], cwd=cwd,
                          env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_gen_simulate_stream_end_to_end(tmp_path):
    _port("gen", "--n", "500", "--seed", "5", "--out_manifest", "m.csv", cwd=tmp_path)
    out = _port("simulate", "--manifest", "m.csv", "--out", "a.cdrsb",
                "--duration_seconds", "240", "--seed", "6", cwd=tmp_path)
    assert out.startswith("Wrote a.cdrsb with ")
    ref = tmp_path / "ref"
    ref.mkdir()
    assert reference_main(["gen", "--n", "500", "--seed", "5",
                           "--out_manifest", str(ref / "m.csv")]) == 0
    assert reference_main(["simulate", "--manifest", str(ref / "m.csv"),
                           "--out", str(ref / "a.cdrsb"), "--duration_seconds", "240",
                           "--seed", "6"]) == 0
    for name in ("m.csv", "a.cdrsb"):
        assert (tmp_path / name).read_bytes() == (ref / name).read_bytes(), name

    out = _port("stream", "--manifest", "m.csv", "--access_log", "a.cdrsb",
                "--batch_size", "4000", "--k", "4", "--seed", "0", "--kmeans_batch", "256",
                "--scoring_config", "validated", "--device", "cpu",
                "--checkpoint", "fold.npz", "--checkpoint_every", "1", cwd=tmp_path)
    assert "mini-batch(256)" in out and not (tmp_path / "fold.npz").exists()
    with open(tmp_path / "final_categories.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 4 and all(r["category"] in CATEGORIES for r in rows)
    assert all(r["centroid_id"].startswith("CENTROID_") for r in rows)

    manifest = Manifest.read_csv(str(tmp_path / "m.csv"))
    log = str(tmp_path / "a.cdrsb")
    streamed = stream_finalize(fold_stream(log, manifest, device="cpu", batch_size=4000),
                               manifest)
    batch = compute_features_torch(manifest, EventLog.read_csv(log, manifest), device="cpu")
    assert torch.equal(streamed.raw, batch.raw) and torch.equal(streamed.norm, batch.norm)


def test_stream_rejects_a_bad_kmeans_batch_and_a_cuda_less_default(tmp_path):
    _port("gen", "--n", "50", "--seed", "1", "--out_manifest", "m.csv", cwd=tmp_path)
    _port("simulate", "--manifest", "m.csv", "--out", "a.log", "--duration_seconds", "30",
          "--seed", "2", cwd=tmp_path)
    assert not (tmp_path / "a.log").read_bytes().startswith(b"CDRSBEV1")
    args = [sys.executable, "-m", "cdrs_tpu_torch", "stream", "--manifest", "m.csv",
            "--access_log", "a.log", "--k", "2"]
    bad = subprocess.run(args + ["--kmeans_batch", "0", "--device", "cpu"], cwd=tmp_path,
                         env=ENV, capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1 and "--kmeans_batch must be >= 1" in bad.stderr
    if not torch.cuda.is_available():
        no_cuda = subprocess.run(args, cwd=tmp_path, env=ENV, capture_output=True,
                                 text=True, timeout=300)
        assert no_cuda.returncode != 0 and "CUDA is not available" in no_cuda.stderr


def test_control_summary_has_the_reference_keys(tmp_path, capsys, monkeypatch):
    """``control --device cpu`` over a ``gen``/``simulate`` log: the JSON
    summary has the keys of ``cdrs control --backend jax`` with the same
    options, and the plan CSV and window records are written."""
    _port("gen", "--n", "300", "--seed", "5", "--out_manifest", "m.csv", cwd=tmp_path)
    _port("simulate", "--manifest", "m.csv", "--out", "a.cdrsb", "--duration_seconds",
          "600", "--seed", "6", cwd=tmp_path)
    opts = ["--manifest", "m.csv", "--access_log", "a.cdrsb", "--window_seconds", "120",
            "--k", "4", "--seed", "3", "--scoring_config", "validated", "--max_files", "50",
            "--checkpoint", "ck.npz"]
    out = _port("control", *opts, "--device", "cpu", "--plan_out", "plan.csv",
                "--metrics", "m.jsonl", cwd=tmp_path)
    summary = json.loads(out)
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    assert reference_main(["control", *[o.replace("ck.npz", "ref_ck.npz") for o in opts],
                           "--backend", "jax"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert set(summary) == set(ref)
    assert set(summary["checkpoint"]) == set(ref["checkpoint"])
    for key in ("windows", "events", "reclusters"):
        assert summary[key] == ref[key], key
    with open(tmp_path / "plan.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 300 and set(rows[0]) == {"path", "category", "rf"}
    # The stream holds the instrument's events too; the window records are
    # its "kind": "window" lines.
    events = [json.loads(ln) for ln in (tmp_path / "m.jsonl").read_text().splitlines()]
    records = [e for e in events if e["kind"] == "window"]
    assert [r["window"] for r in records] == list(range(summary["windows"]))
    counters = {e["name"]: e["value"] for e in events if e["kind"] == "counter"}
    assert counters["controller.windows"] == summary["windows"]
    assert records[-1]["plan_hash"] == summary["final_plan_hash"]
    # Rerunning resumes from the checkpoint: nothing left to process.
    again = json.loads(_port("control", *opts, "--device", "cpu", cwd=tmp_path))
    assert again["windows"] == 0 and again["final_plan_hash"] == summary["final_plan_hash"]


def test_daemon_digest_plan_resume_and_supervise(tmp_path, capsys, monkeypatch):
    """``daemon --device cpu`` over a ``.cdrsb`` log: the digest has the keys of
    ``cdrs daemon --backend jax``, the digest and plan files are written, a
    rerun resumes from the checkpoint and processes no window, and
    ``--supervise`` over a clean child exits 0."""
    _port("gen", "--n", "300", "--seed", "5", "--out_manifest", "m.csv", cwd=tmp_path)
    _port("simulate", "--manifest", "m.csv", "--out", "a.cdrsb", "--duration_seconds",
          "600", "--seed", "6", cwd=tmp_path)
    opts = ["--manifest", "m.csv", "--access_log", "a.cdrsb", "--window_seconds", "120",
            "--k", "4", "--seed", "3", "--scoring_config", "validated", "--max_files", "50",
            "--brownout", "--recluster", "minibatch", "--minibatch_rows", "128"]
    digest = json.loads(_port("daemon", *opts, "--device", "cpu", "--checkpoint", "ck.npz",
                              "--digest_out", "dig.json", "--plan_out", "plan.csv",
                              "--metrics", "m.jsonl", "--metrics_max_bytes", "4000",
                              cwd=tmp_path))
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    assert reference_main(["daemon", *opts, "--backend", "jax", "--checkpoint",
                           "ref_ck.npz"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert set(digest) == set(ref)
    for key in ("windows_processed", "events_ingested", "epochs_published", "cursor"):
        assert digest[key] == ref[key], key
    assert set(digest["brownout"]) == set(ref["brownout"]) and digest["minibatch"]["n_batches"]
    on_disk = json.loads((tmp_path / "dig.json").read_text())
    assert on_disk == digest and digest["stop_reason"] == "end_of_stream"
    with open(tmp_path / "plan.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 300 and set(rows[0]) == {"path", "category", "rf"}
    from cdrs_tpu_torch.obs.sink import read_events, rotated_paths

    assert rotated_paths(str(tmp_path / "m.jsonl"))
    windows = [e for e in read_events(str(tmp_path / "m.jsonl")) if e["kind"] == "window"]
    assert [e["window"] for e in windows] == list(range(digest["windows_processed"]))
    assert windows[-1]["plan_hash"] == digest["plan_hash"]
    again = json.loads(_port("daemon", *opts, "--device", "cpu", "--checkpoint", "ck.npz",
                             cwd=tmp_path))
    assert again["windows_processed"] == 0 and again["plan_hash"] is None
    assert again["epochs_published"] == digest["epochs_published"]
    assert again["window_index"] == digest["window_index"]
    proc = subprocess.run([sys.executable, "-m", "cdrs_tpu_torch", "daemon", *opts,
                           "--device", "cpu", "--checkpoint", "sup.npz", "--supervise",
                           "--max_restarts", "2"], cwd=tmp_path, env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "child exited cleanly" in proc.stderr and "--supervise" not in \
        proc.stderr.split("starting child (attempt 1): ")[1].splitlines()[0]
    assert json.loads(proc.stdout)["windows_processed"] == digest["windows_processed"]
