"""Host workload synthesis: file population and Poisson access log."""
