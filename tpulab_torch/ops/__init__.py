"""Compute ops of the lab workloads (roberts, elementwise, mahalanobis)."""
