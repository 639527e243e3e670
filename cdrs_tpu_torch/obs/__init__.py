"""Observability: the JSONL sink and its readers, the stream digests and
the scenario coverage fingerprint, the alert rules, the daemon's
decision-trace contexts and Chrome export, and its live HTTP plane
(``prom`` renderer, ``httpz`` server)."""
