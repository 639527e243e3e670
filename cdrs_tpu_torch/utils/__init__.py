"""Host utilities: checkpoint snapshots."""
