"""Clustering and scoring on tensors, and the hand-written CUDA kernels they launch."""
