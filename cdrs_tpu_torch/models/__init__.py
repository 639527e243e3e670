"""The replication-policy model."""
