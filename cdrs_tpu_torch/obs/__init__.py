"""Observability: the JSONL sink and its readers, the pacing digest, the
alert rules and the daemon's decision-trace contexts."""
