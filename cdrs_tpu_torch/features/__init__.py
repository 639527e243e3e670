"""Per-file feature extraction on tensors."""
