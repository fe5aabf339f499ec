"""Synthetic data pipelines."""
