"""Observability: the controller's JSONL window sink and pacing digest."""
