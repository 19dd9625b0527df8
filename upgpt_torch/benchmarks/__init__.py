"""Micro-benchmarks of the port's kernels."""
