"""Inference surfaces."""
