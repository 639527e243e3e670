"""Online control: the drift detector."""
