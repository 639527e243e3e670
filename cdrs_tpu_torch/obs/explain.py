"""``cdrs explain``: decision provenance, rebuilt offline from a telemetry
stream and a controller checkpoint (``cdrs_tpu/obs/explain.py``).

* ``explain file ID`` — the hash chooser's slot-by-slot narration
  (``placement_fn.explain_placement``, checked against
  ``compute_placement``), the checkpoint's exception-overlay row for the
  file if it deviates, and its cause-tagged move history from the
  ``lineage`` events.
* ``explain category NAME`` — each cluster mapped to the category, its
  score split into per-feature signed contributions against the global
  medians (``ops.scoring.score_table_terms``; they sum to the score).
* ``explain window W`` — the signals that crossed their thresholds that
  window, its churn traffic by cause, and the alert transitions it caused.

Output is deterministic for a given stream and checkpoint (no wall clock)
and byte-identical to the reference's on the same files.  A checkpoint
written in ``materialized`` placement, or a file id out of range, exits 2;
an unreadable stream or checkpoint exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["main", "explain_file", "explain_category", "explain_window",
           "file_history"]

#: Cause vocabulary stamped by the controller (``control/controller.py``).
CAUSES = ("drift", "hotspot", "conversion", "repair",
          "correlated_rebalance", "elastic_rebalance", "epoch_diff")


# -- shared loading ----------------------------------------------------------


def _load_events(path: str):
    from .sink import read_events

    try:
        events = read_events(path)
    except OSError as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        return None
    if not events:
        print(f"error: {path}: no telemetry events (missing, empty, or "
              f"corrupt stream)", file=sys.stderr)
        return None
    return events


def _load_checkpoint(path: str):
    from ..utils.checkpoint import CheckpointError, load_state

    try:
        return load_state(path)
    except (OSError, CheckpointError) as e:
        print(f"error: cannot load checkpoint {path}: {e}",
              file=sys.stderr)
        return None


def _resolve_topology(args, manifest):
    """The chaos CLI's topology (--topology JSON|FILE, --racks SPEC, default
    flat) over the manifest's nodes."""
    from ..cluster.placement import ClusterTopology

    if getattr(args, "topology", None):
        text = args.topology
        if not text.lstrip().startswith("{"):
            with open(text, encoding="utf-8") as f:
                text = f.read()
        return ClusterTopology.from_hierarchy(json.loads(text))
    if getattr(args, "racks", None):
        return ClusterTopology.from_rack_spec(manifest.nodes, args.racks)
    return ClusterTopology(nodes=tuple(manifest.nodes))


# -- file --------------------------------------------------------------------


def file_history(events: list[dict], fid: int) -> list[dict]:
    """The file's cause-tagged move history: one entry per lineage event
    naming the file, in window order, with that window's re-cluster trigger
    and plan hash.  Windows whose id lists were truncated
    (``LINEAGE_ID_CAP``) are listed after, as membership unknown."""
    from .aggregate import dedup_windows

    recs = {r.get("window"): r for r in dedup_windows(events)}
    hist: list[dict] = []
    truncated: list[int] = []
    seen = set()
    for e in events:
        if e.get("kind") != "lineage":
            continue
        w = e.get("window")
        if e.get("truncated") and w not in truncated:
            truncated.append(w)
        if int(fid) not in (e.get("file_ids") or ()):
            continue
        key = (w, e.get("cause"))
        if key in seen:   # a tail repeated after a crash
            continue
        seen.add(key)
        rec = recs.get(w) or {}
        hist.append({
            "window": w,
            "cause": e.get("cause"),
            "batch_files": e.get("files"),
            "batch_bytes": e.get("bytes"),
            "recluster_trigger": rec.get("recluster_trigger"),
            "plan_hash": rec.get("plan_hash"),
        })
    hist.sort(key=lambda h: (h["window"] is None, h["window"]))
    return hist if not truncated else hist + [
        {"window": w, "cause": "(lineage id list truncated — counts "
                               "exact, membership unknown)"}
        for w in sorted(truncated)]


def explain_file(fid: int, *, manifest, topology, rf: int,
                 seed: int = 0, local: bool = False,
                 events: list[dict] | None = None,
                 checkpoint=None) -> dict:
    """One file: chooser narration, exception overlay and cause-tagged
    history.  ``checkpoint`` is an optional ``(arrays, meta)`` pair from
    ``utils/checkpoint.load_state``."""
    import numpy as np

    from ..cluster.placement import primary_on_topology
    from ..placement_fn import explain_placement

    if not 0 <= int(fid) < len(manifest):
        raise ValueError(
            f"file id {fid} out of range (manifest has "
            f"{len(manifest)} files)")
    primary = primary_on_topology(manifest.nodes,
                                  manifest.primary_node_id,
                                  topology)[int(fid)]
    out: dict = {
        "file": int(fid),
        "path": str(manifest.paths[int(fid)]),
        "size_bytes": int(manifest.size_bytes[int(fid)]),
        "trace": explain_placement(int(fid), int(rf), int(primary),
                                   topology, seed, local=bool(local)),
    }
    if checkpoint is not None:
        arrays, meta = checkpoint
        out["placement_mode"] = meta.get("placement", "materialized")
        if "current_rf" in arrays:
            out["target_rf"] = int(arrays["current_rf"][int(fid)])
        if "current_cat" in arrays:
            from ..config import CATEGORIES

            c = int(arrays["current_cat"][int(fid)])
            out["category"] = CATEGORIES[c] if c >= 0 else "Unplanned"
        exc_fids = arrays.get("fault_fn_exc_fids")
        if exc_fids is not None:
            hit = np.flatnonzero(np.asarray(exc_fids) == int(fid))
            if hit.size:
                row = np.asarray(arrays["fault_fn_exc_rows"])[hit[0]]
                out["exception_row"] = [int(x) for x in row if x >= 0]
            else:
                out["exception_row"] = None
            out["exceptions_total"] = int(np.asarray(exc_fids).size)
    if events is not None:
        out["history"] = file_history(events, int(fid))
        from .aggregate import dedup_windows

        recs = dedup_windows(events)
        stamps = [r.get("placement") for r in recs
                  if isinstance(r.get("placement"), dict)]
        if stamps:
            out["stream_placement"] = stamps[-1]
    return out


def render_file(d: dict, out) -> None:
    print(f"file {d['file']} ({d['path']}, {d['size_bytes']} bytes)",
          file=out)
    if "category" in d:
        line = f"  decided category: {d['category']}"
        if "target_rf" in d:
            line += f", target shards {d['target_rf']}"
        print(line, file=out)
    tr = d["trace"]
    nodes = [s["node_name"] for s in tr["slots"]]
    print(f"  computed placement (seed {tr['seed']}, rf {tr['rf']}"
          + (", region-local" if tr["local"] else "")
          + f"): {nodes}", file=out)
    for s in tr["slots"]:
        line = f"    slot {s['slot']}: {s['node_name']} — {s['rule']}"
        if "key" in s:
            k = s["key"]
            line += (f" (region copies {k['top_count']}, rack copies "
                     f"{k['base_count']}, priority {k['priority']})")
        print(line, file=out)
        for c in s.get("candidates", ()):
            if "masked" in c:
                print(f"      {c['name']:<8} [{c['domain']}] — "
                      f"{c['masked']}", file=out)
            else:
                extra = ""
                if "top_count" in c:
                    extra = (f" region={c['top_count']} "
                             f"rack={c['base_count']}")
                print(f"      {c['name']:<8} [{c['domain']}] "
                      f"priority={c['priority']}{extra}", file=out)
    if "exception_row" in d:
        if d["exception_row"] is not None:
            print(f"  exception overlay: DEVIATES from the computed "
                  f"base — current row {d['exception_row']} "
                  f"(one of {d['exceptions_total']} standing "
                  f"exceptions)", file=out)
        else:
            print(f"  exception overlay: on the computed base "
                  f"({d.get('exceptions_total', 0)} standing "
                  f"exceptions elsewhere)", file=out)
    if "history" in d:
        if d["history"]:
            print("  move history (cause-tagged):", file=out)
            for h in d["history"]:
                extra = ""
                if h.get("recluster_trigger"):
                    extra = f" (trigger: {h['recluster_trigger']})"
                if h.get("plan_hash"):
                    extra += f" plan {h['plan_hash']}"
                print(f"    window {h['window']}: {h['cause']}{extra}",
                      file=out)
        else:
            print("  move history: no cause-tagged moves in the stream",
                  file=out)


# -- category ----------------------------------------------------------------


def explain_category(name: str, centroids, category_idx, scoring_cfg,
                     fractions=None) -> dict:
    """Per-feature split of the directional-deviation score of every
    cluster the accepted model mapped to ``name``.  ``centroids`` is the
    accepted (k, d) model; each contribution is a ``score_table_terms``
    entry, and a cluster's contributions sum to its score."""
    import numpy as np

    from ..config import CATEGORIES
    from ..ops.scoring import score_table_terms

    if name not in CATEGORIES:
        raise ValueError(
            f"unknown category {name!r} (want one of {CATEGORIES})")
    ci = CATEGORIES.index(name)
    cent = np.asarray(centroids, dtype=np.float64)
    terms = score_table_terms(cent, scoring_cfg)       # (k, C, d)
    scores = terms.sum(axis=2)                         # (k, C)
    gmed = np.asarray([scoring_cfg.global_medians[f]
                       for f in scoring_cfg.features], dtype=np.float64)
    W = np.asarray(scoring_cfg.weight_matrix(), dtype=np.float64)
    D = np.asarray(scoring_cfg.direction_matrix(), dtype=np.float64)
    cat_idx = np.asarray(category_idx)
    members = np.flatnonzero(cat_idx == ci)
    clusters = []
    for c in members:
        row = scores[c]
        others = np.delete(row, ci)
        runner = float(others.max()) if others.size else 0.0
        feats = []
        for j, f in enumerate(scoring_cfg.features):
            delta = float(cent[c, j] - gmed[j])
            contrib = float(terms[c, ci, j])
            feats.append({
                "feature": f,
                "centroid": round(float(cent[c, j]), 6),
                "global_median": round(float(gmed[j]), 6),
                "delta": round(delta, 6),
                "direction": int(D[ci, j]),
                "weight": round(float(W[ci, j]), 6),
                "contribution": round(contrib, 6),
                "gated_out": contrib == 0.0 and W[ci, j] != 0.0,
            })
        feats.sort(key=lambda r: -r["contribution"])
        clusters.append({
            "cluster": int(c),
            "score": round(float(row[ci]), 6),
            "runner_up_score": round(runner, 6),
            "margin": round(float(row[ci]) - runner, 6),
            "scores_all": {cat: round(float(row[i]), 6)
                           for i, cat in enumerate(CATEGORIES)},
            "features": feats,
        })
    out = {"category": name,
           "rf": scoring_cfg.replication_factors.get(name),
           "clusters_total": int(cent.shape[0]),
           "clusters": clusters}
    if fractions is not None:
        out["population_fraction"] = round(float(
            np.asarray(fractions)[ci]), 6)
    return out


def render_category(d: dict, out) -> None:
    line = (f"category {d['category']} (rf {d['rf']}): "
            f"{len(d['clusters'])} of {d['clusters_total']} clusters")
    if d.get("population_fraction") is not None:
        line += f", {d['population_fraction']:.1%} of files"
    print(line, file=out)
    if not d["clusters"]:
        print("  no cluster currently maps to this category", file=out)
        return
    for c in d["clusters"]:
        note = ""
        if c["margin"] < 0:
            # The decision scored cluster medians; a snapshot carries only
            # the centroid, so a negative margin flags the proxy.
            note = (" [centroid proxy disagrees with the accepted "
                    "decision (which scored cluster medians); read the "
                    "rows as directional]")
        print(f"  cluster {c['cluster']}: score {c['score']} "
              f"(runner-up {c['runner_up_score']}, margin "
              f"{c['margin']}){note}", file=out)
        for f in c["features"]:
            sign = "+" if f["delta"] >= 0 else ""
            want = {1: "wants high", -1: "wants low",
                    0: "direction-free"}[f["direction"]]
            gate = " [GATED OUT: direction/band mismatch]" \
                if f["gated_out"] else ""
            print(f"    {f['feature']:<22} delta {sign}{f['delta']:g} "
                  f"x weight {f['weight']:g} ({want}) -> "
                  f"+{f['contribution']:g}{gate}", file=out)


# -- window ------------------------------------------------------------------


def explain_window(events: list[dict], w: int) -> dict:
    """One window: the signals that crossed, the traffic each cause
    consumed, and the alert transitions the window caused."""
    from .aggregate import dedup_windows
    from .alerts import evaluate_records

    recs = dedup_windows(events)
    by_w = {r.get("window"): r for r in recs}
    if int(w) not in by_w:
        have = [r.get("window") for r in recs]
        raise ValueError(
            f"no window {w} in the stream (windows "
            f"{min(have)}..{max(have)})" if have
            else f"no window records in the stream")
    rec = by_w[int(w)]

    signals = []

    def sig(name, value, crossed, detail=""):
        if value is None:
            return
        signals.append({"signal": name, "value": value,
                        "crossed": bool(crossed), "detail": detail})

    trig = rec.get("recluster_trigger")
    sig("drift", rec.get("drift"), trig == "drift",
        "re-cluster trigger" if trig == "drift" else "")
    sig("hotspot", rec.get("hotspot_score"), trig == "hotspot",
        "re-cluster trigger" if trig == "hotspot" else "")
    sig("slo_burn", rec.get("slo_burn"),
        (rec.get("slo_burn") or 0.0) > 1.0, "error budget exceeded"
        if (rec.get("slo_burn") or 0.0) > 1.0 else "")
    dur = rec.get("durability") or {}
    for key in ("lost", "at_risk", "under_replicated", "unreachable",
                "correlated_risk"):
        if key in dur:
            sig(f"durability.{key}", dur[key], dur[key] > 0)
    integ = rec.get("integrity") or {}
    for key in ("true_lost", "corrupt_copies"):
        if key in integ:
            sig(f"integrity.{key}", integ[key], integ[key] > 0)
    if (rec.get("scrub") or {}).get("starved") is not None:
        sig("scrub.starved", int(bool(rec["scrub"]["starved"])),
            bool(rec["scrub"]["starved"]))
    if rec.get("reads_unavailable") is not None:
        sig("reads_unavailable", rec.get("reads_unavailable"),
            (rec.get("reads_unavailable") or 0) > 0)
    # Crossed first, then by magnitude.
    signals.sort(key=lambda s: (not s["crossed"], -float(s["value"])))

    causes = dict(rec.get("causes") or {})
    scrub_b = (rec.get("scrub") or {}).get("bytes", 0)
    traffic = {k: dict(v) for k, v in causes.items()}
    if scrub_b:
        traffic["scrub"] = {"files": (rec.get("scrub") or {}).get(
            "files_verified", 0), "bytes": int(scrub_b)}
    total = sum(v.get("bytes", 0) for v in traffic.values())
    for v in traffic.values():
        v["share"] = round(v.get("bytes", 0) / total, 4) if total else 0.0

    upto = [r for r in recs if r.get("window") is not None
            and r["window"] <= int(w)]
    verdicts = evaluate_records(upto)
    transitions = [t for r in verdicts
                   for t in r["transitions"] if t.get("window") == int(w)]
    firing = sorted(r["name"] for r in verdicts if r["firing"])
    return {
        "window": int(w),
        "n_events": rec.get("n_events"),
        "recluster": rec.get("recluster"),
        "recluster_trigger": trig,
        "recluster_mode": rec.get("recluster_mode"),
        "plan_hash": rec.get("plan_hash"),
        "fault_events": list(rec.get("fault_events") or ()),
        "signals": signals,
        "traffic": traffic,
        "traffic_bytes_total": int(total),
        "repair_bytes": rec.get("repair_bytes", 0),
        "bytes_migrated": rec.get("bytes_migrated", 0),
        "alert_transitions": transitions,
        "alerts_firing_after": firing,
    }


def render_window(d: dict, out) -> None:
    head = (f"window {d['window']}: {d['n_events']} events, "
            f"recluster={bool(d['recluster'])}")
    if d["recluster_trigger"]:
        head += (f" (trigger {d['recluster_trigger']}, mode "
                 f"{d['recluster_mode']})")
    print(head, file=out)
    if d["fault_events"]:
        print(f"  fault events: {', '.join(d['fault_events'])}",
              file=out)
    print("  signals (crossed first):", file=out)
    for s in d["signals"]:
        mark = "CROSSED" if s["crossed"] else "quiet"
        detail = f" — {s['detail']}" if s["detail"] else ""
        print(f"    {s['signal']:<26} {s['value']:<12g} "
              f"[{mark}]{detail}", file=out)
    if d["traffic"]:
        print(f"  churn traffic by cause "
              f"({d['traffic_bytes_total']} bytes total):", file=out)
        for cause in sorted(d["traffic"],
                            key=lambda c: -d["traffic"][c]["bytes"]):
            v = d["traffic"][cause]
            print(f"    {cause:<22} {v['bytes']:>12} bytes "
                  f"({v['share']:.1%}), {v.get('files', 0)} files",
                  file=out)
    else:
        print("  churn traffic by cause: none (no admitted moves)",
              file=out)
    for t in d["alert_transitions"]:
        print(f"  alert {t['state'].upper()}: {t['alert']} "
              f"[{t['severity']}]", file=out)
    if d["alerts_firing_after"]:
        print(f"  alerts firing after this window: "
              f"{', '.join(d['alerts_firing_after'])}", file=out)
    if d["plan_hash"]:
        print(f"  plan hash: {d['plan_hash']}", file=out)


# -- CLI ---------------------------------------------------------------------


def _scoring_from(args):
    from ..config import ScoringConfig

    spec = getattr(args, "scoring_config", None)
    if spec == "validated":
        from ..config import validated_scoring_config

        return validated_scoring_config()
    if spec:
        from ..config import load_scoring_config

        return load_scoring_config(spec)
    return ScoringConfig()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cdrs explain",
        description="decision provenance: why a file lives where it "
                    "does, why a category scored what it did, what a "
                    "window's signals and traffic were")
    sub = parser.add_subparsers(dest="what", required=True)

    p = sub.add_parser("file", help="slot-by-slot chooser narration + "
                                    "exception overlay + cause-tagged "
                                    "move history")
    p.add_argument("id", type=int, help="file id (manifest row)")
    p.add_argument("--manifest", required=True)
    p.add_argument("--metrics", default=None, metavar="JSONL",
                   help="telemetry stream: adds the lineage move history")
    p.add_argument("--checkpoint", default=None, metavar="NPZ",
                   help="controller snapshot: adds the decided "
                        "category/rf and the exception-overlay row")
    p.add_argument("--topology", default=None, metavar="JSON|FILE")
    p.add_argument("--racks", default=None, metavar="SPEC")
    p.add_argument("--rf", type=int, default=2,
                   help="shard count to narrate when no --checkpoint "
                        "supplies the decided one")
    p.add_argument("--seed", type=int, default=0,
                   help="placement seed (the controller uses 0)")
    p.add_argument("--local", action="store_true",
                   help="narrate the region-local (locality-pinned) "
                        "variant")

    p = sub.add_parser("category", help="per-feature decomposition of "
                                        "the directional-deviation "
                                        "score (Table-2 math)")
    p.add_argument("name", help="category name (e.g. Hot, Archival)")
    p.add_argument("--checkpoint", required=True, metavar="NPZ",
                   help="controller snapshot carrying the accepted "
                        "model (centroids + cluster categories)")
    p.add_argument("--scoring_config", default=None,
                   metavar="JSON|validated")

    p = sub.add_parser("window", help="signals crossed, traffic by "
                                      "cause, alert transitions")
    p.add_argument("index", type=int, help="window index")
    p.add_argument("--metrics", required=True, metavar="JSONL")

    args = parser.parse_args(argv)
    out = sys.stdout

    try:
        if args.what == "file":
            from ..io.events import Manifest

            manifest = Manifest.read_csv(args.manifest)
            if not 0 <= args.id < len(manifest):
                # Before any checkpoint array is indexed.
                print(f"error: file id {args.id} out of range "
                      f"(manifest has {len(manifest)} files)",
                      file=sys.stderr)
                return 2
            try:
                topology = _resolve_topology(args, manifest)
            except (ValueError, OSError) as e:
                print(f"error: bad topology: {e}", file=sys.stderr)
                return 2
            events = None
            if args.metrics:
                events = _load_events(args.metrics)
                if events is None:
                    return 1
            checkpoint = None
            rf = args.rf
            if args.checkpoint:
                checkpoint = _load_checkpoint(args.checkpoint)
                if checkpoint is None:
                    return 1
                mode = checkpoint[1].get("placement", "materialized")
                if mode == "materialized":
                    print("error: checkpoint was written in "
                          "'materialized' placement mode — only the "
                          "hash modes ('functional'/"
                          "'materialized_hash') are a pure function "
                          "the chooser can narrate; re-run with "
                          "--placement materialized_hash or drop "
                          "--checkpoint to narrate the hash chooser "
                          "hypothetically", file=sys.stderr)
                    return 2
                if "current_rf" in checkpoint[0]:
                    rf = int(checkpoint[0]["current_rf"][args.id])
            d = explain_file(args.id, manifest=manifest,
                             topology=topology, rf=rf, seed=args.seed,
                             local=args.local, events=events,
                             checkpoint=checkpoint)
            render_file(d, out)
            return 0
        if args.what == "category":
            loaded = _load_checkpoint(args.checkpoint)
            if loaded is None:
                return 1
            arrays, meta = loaded
            if "accepted_centroids" not in arrays:
                print(f"error: checkpoint {args.checkpoint} carries no "
                      f"accepted model yet (no window re-clustered "
                      f"before the snapshot)", file=sys.stderr)
                return 2
            d = explain_category(
                args.name, arrays["accepted_centroids"],
                arrays["accepted_category_idx"], _scoring_from(args),
                fractions=arrays.get("accepted_fractions"))
            render_category(d, out)
            return 0
        # window
        events = _load_events(args.metrics)
        if events is None:
            return 1
        d = explain_window(events, args.index)
        render_window(d, out)
        return 0
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
