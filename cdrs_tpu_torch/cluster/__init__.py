"""Simulated cluster: flat replica placement, policy evaluation, plan export."""
