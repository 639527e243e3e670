"""Online control: time windows, drift detection, plan diff and migration
scheduling, and the replication controller that drives them."""
